"""Paper-experiment driver on the PyTorch port: Fed-RAC vs all four
baselines on a synthetic dataset, the Fig. 2 comparison of
``examples/fedrac_cnn_full.py``, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_fedrac_cnn_full.py \
      [--dataset synth-har] [--rounds 12] [--device cpu]

The configuration is the JAX example's: the 40 Table-III participants,
the CNN family at its default base width 0.25 for Fed-RAC, the smallest
slave width for FedAvg, FedProx and Oort, HeteroFL at base width 0.25 on
three levels.  One
difference is by design: the baselines' initial weights (and HeteroFL's
global model) come from the port's seeded ``torch.Generator`` where the
JAX example draws from ``jax.random.PRNGKey(0)``, so the two examples'
baseline curves differ.  The parity tests carry the weights across.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import server as srv  # noqa: E402
from repro_torch.core.distill import ce_loss  # noqa: E402
from repro_torch.core.families import cnn_family  # noqa: E402
from repro_torch.core.resources import (TABLE_III,  # noqa: E402
                                        participants_from_matrix)
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.data.synthetic import (SPECS,  # noqa: E402
                                        make_classification, train_test_split)
from repro_torch.models import cnn  # noqa: E402

BASELINES = ("FedAvg", "FedProx", "Oort", "HeteroFL")


def federation(args):
    """(participants, client data, test set, input shape, classes)."""
    shape, classes = SPECS[args.dataset]
    ds = make_classification(args.dataset, args.samples, seed=args.seed)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, 40, alpha=1.0, seed=args.seed)
    parts = participants_from_matrix(TABLE_III, n_data=[len(p) for p in idx])
    cdata = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return parts, cdata, {"x": test.x, "y": test.y}, shape, classes


def fedrac_engine(args, parts, cdata, shape, classes):
    """The Fed-RAC engine after setup (Procedures 1 and 2)."""
    fam = cnn_family(classes=classes, in_channels=shape[-1],
                     input_hw=shape[0])
    cfg = srv.FLConfig(rounds=args.rounds, compact_to=4, seed=args.seed)
    return srv.FedRAC(parts, cdata, fam, cfg, classes=classes,
                      device=args.device).setup()


def loss_fn(params, batch):
    logits = cnn.forward(params, batch["x"])
    return ce_loss(logits, batch["y"]).mean(), logits


def run_baseline(name, args, parts, cdata, test, shape, classes):
    """One baseline at the JAX example's settings: (params, accuracy
    curve)."""
    device = srv.resolve_device(args.device)
    bcfg = bl.BaselineConfig(rounds=args.rounds, seed=args.seed, lr=0.08,
                             steps_per_round=4)
    if name == "HeteroFL":
        levels = {p.pid: min(2, 3 * i // len(parts))
                  for i, p in enumerate(parts)}
        return bl.heterofl(parts, cdata, levels, test, bcfg,
                           in_channels=shape[-1], classes=classes, levels=3,
                           base_width=0.25, device=device)
    # the smallest slave model, so that all 40 devices participate
    init = tree_map(lambda x: x.to(device), cnn.init_params(
        torch.Generator().manual_seed(0), in_channels=shape[-1],
        classes=classes, base_width=0.25 * 0.125))
    if name == "Oort":
        return bl.oort(loss_fn, init, parts, cdata, test, bcfg,
                       flops_per_sample=1e6, model_bytes=2e5)
    fn = {"FedAvg": bl.fedavg, "FedProx": bl.fedprox}[name]
    return fn(loss_fn, init, parts, cdata, test, bcfg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synth-mnist", choices=list(SPECS))
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--samples", type=int, default=2400)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    parts, cdata, test, shape, classes = federation(args)
    eng = fedrac_engine(args, parts, cdata, shape, classes)
    res = eng.train(test)
    print(f"Fed-RAC: global={res.global_acc:.4f} per-cluster="
          f"{ {l: round(a, 3) for l, a in res.final_acc.items()} }")
    out = {"Fed-RAC": (eng, res)}
    for name in BASELINES:
        params, hist = run_baseline(name, args, parts, cdata, test, shape,
                                    classes)
        print(f"{name}: final={hist[-1]:.4f} "
              f"curve={[round(a, 3) for a in hist]}")
        out[name] = (params, hist)
    return out


if __name__ == "__main__":
    main()
