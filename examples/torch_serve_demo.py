"""Fed-RAC serving demo on the PyTorch port: one server process holds the
α-compressed model FAMILY; batched requests are routed to the model level
matching each requester's resource cluster (§IV-A2 at inference time).
The port of ``examples/serve_demo.py``; it runs on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import argparse
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import clustering  # noqa: E402
from repro_torch.core.resources import LAMBDA_PAPER, TABLE_III  # noqa: E402
from repro_torch.core.scaling import compress_config, param_count  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import registry  # noqa: E402


def tiers():
    """Resource-aware clustering of the requesting devices into at most
    three service tiers: (labels, m, k-optimal)."""
    res = clustering.optimal_clusters(TABLE_III, LAMBDA_PAPER, seed=3,
                                      restarts=1)
    labels = clustering.order_clusters_by_resources(res.normalized,
                                                    res.labels, LAMBDA_PAPER)
    m = min(3, len(np.unique(labels)))
    return np.clip(labels, 0, m - 1), m, res.k


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (pass --device cpu)")
    base = get_config("olmo-1b", smoke=True).replace(vocab_size=1024)
    labels, m, k = tiers()
    print(f"requesters clustered into {m} service tiers "
          f"(k-optimal was {k})")

    family, params = [], []
    for lvl in range(m):
        cfg = compress_config(base, 0.5, lvl)
        family.append(cfg)
        gen = torch.Generator(device=device).manual_seed(lvl)
        params.append(registry.init_params(cfg, gen))
        print(f"  tier {lvl}: {param_count(cfg) / 1e6:.2f}M params")

    # serve one batch per tier
    rng = np.random.default_rng(0)
    out = []
    for lvl in range(m):
        n_req = int((labels == lvl).sum())
        batch = min(4, max(1, n_req))
        prompts = torch.tensor(rng.integers(0, base.vocab_size, (batch, 16)),
                               device=device)
        t0 = time.time()
        toks = generate(family[lvl], params[lvl], prompts, gen_len=16)
        dt = time.time() - t0
        out.append(toks)
        print(f"  tier {lvl}: served {n_req} requesters "
              f"(batch {batch}): {batch * 16 / dt:.1f} tok/s, "
              f"sample={toks[0, :8]}")
    return out


if __name__ == "__main__":
    main()
