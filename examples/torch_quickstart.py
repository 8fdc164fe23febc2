"""Quickstart on the PyTorch port: Fed-RAC in ~60 lines on the public API.

Clusters the paper's 40 real participants by resources (Procedure 1),
compacts, assigns (Procedure 2), trains the master cluster by FedAvg and the
slaves under master KD, then prints per-cluster accuracy.  The port of
``examples/quickstart.py``; it runs on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import server as srv  # noqa: E402
from repro_torch.core.families import cnn_family  # noqa: E402
from repro_torch.core.resources import (TABLE_III,  # noqa: E402
                                        participants_from_matrix)
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.data.synthetic import (make_classification,  # noqa: E402
                                        train_test_split)


def build(device="cuda"):
    """The federation and the engine after setup: (engine, test set)."""
    # 1. synthetic federated dataset, non-iid across 40 participants
    ds = make_classification("synth-mnist", 2400, seed=0)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, 40, alpha=1.0, seed=0)
    parts = participants_from_matrix(TABLE_III, n_data=[len(p) for p in idx])
    client_data = [{"x": train.x[p], "y": train.y[p]} for p in idx]

    # 2. the model family: the paper's CNN, α-compressed per cluster level
    family = cnn_family(classes=10, in_channels=1)

    # 3. Fed-RAC end to end
    cfg = srv.FLConfig(rounds=8, compact_to=4, seed=3)
    engine = srv.FedRAC(parts, client_data, family, cfg, classes=10,
                        device=device).setup()
    return engine, {"x": test.x, "y": test.y}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    engine, test = build(args.device)
    print(f"optimal k = {engine.k_optimal} (Dunn indices: "
          f"{ {k: round(v, 3) for k, v in engine.di_values.items()} })")
    print(f"compacted to m = {engine.m} clusters; members: "
          f"{ {l: len(v) for l, v in engine.assignment.members.items()} }")

    result = engine.train(test)
    for lvl in range(engine.m):
        print(f"  cluster C{lvl + 1}: acc = "
              f"{result.final_acc.get(lvl, float('nan')):.3f}")
    print(f"global accuracy = {result.global_acc:.3f}")
    return result


if __name__ == "__main__":
    main()
