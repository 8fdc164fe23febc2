"""End-to-end LM training on the PyTorch port: an olmo-family model for a
few hundred steps with the WSD schedule and AdamW, a checkpoint, and
Fed-RAC's cluster compression (``--cluster-level`` trains the α-compressed
slave configuration).  The port of ``examples/fedrac_lm_train.py``; it
runs on the card unless ``--device cpu``.

The default is a reduced model of about 7 M parameters; ``--full-100m``
selects a model of about 100 M parameters on the same code path:

  PYTHONPATH=src python examples/torch_fedrac_lm_train.py --steps 300
  PYTHONPATH=src python examples/torch_fedrac_lm_train.py --full-100m \\
      --steps 300
"""
import argparse
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scaling import compress_config, param_count  # noqa: E402
from repro_torch.core.server import resolve_device  # noqa: E402
from repro_torch.data.synthetic import lm_batches, make_lm_corpus  # noqa: E402
from repro_torch.launch.train import (build_step,  # noqa: E402
                                      init_train_params, lm_batch)
from repro_torch.optim import optimizers, schedules  # noqa: E402


def make_config(full_100m: bool, cluster_level: int):
    """The example's model configuration, as the JAX example builds it."""
    cfg = get_config("olmo-1b", smoke=True)
    if full_100m:
        cfg = cfg.replace(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                          head_dim=64, d_ff=2048, vocab_size=50304)
    else:
        cfg = cfg.replace(n_layers=4, d_model=256, vocab_size=2048)
    return compress_config(cfg, 0.5, cluster_level)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--cluster-level", type=int, default=0,
                    help="train the α-compressed slave config instead")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "fedrac_lm_ckpt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.full_100m, args.cluster_level)
    print(f"config: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
          f"params~{param_count(cfg) / 1e6:.1f}M")

    params = init_train_params(cfg, args.seed, device)
    opt = optimizers.adamw()
    opt_state = opt.init(params)
    sched = schedules.wsd(args.lr, args.steps)           # MiniCPM WSD
    step_fn = build_step(cfg, opt, sched)
    corpus = make_lm_corpus(cfg.vocab_size, 300_000, seed=args.seed)

    losses, t0 = [], time.time()
    for step in range(args.steps):
        toks = lm_batches(corpus, args.batch, args.seq, 1,
                          seed=args.seed + step)[0]
        params, opt_state, ce = step_fn(params, opt_state,
                                        lm_batch(cfg, toks, device), step)
        losses.append(float(ce))
        if (step + 1) % 50 == 0:
            tput = args.batch * args.seq * 50 / (time.time() - t0)
            print(f"step {step + 1:4d} ce={np.mean(losses[-50:]):.4f} "
                  f"tok/s={tput:,.0f}", flush=True)
            t0 = time.time()
    path = checkpoint.save_step(args.ckpt_dir, args.steps, {"params": params})
    print(f"ce: start={np.mean(losses[:20]):.4f} "
          f"end={np.mean(losses[-20:]):.4f}  ckpt={path}")
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    return losses


if __name__ == "__main__":
    main()
