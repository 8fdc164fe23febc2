"""Fed-RAC end-to-end launcher (Algorithm 1 on synthetic federated data).

  PYTHONPATH=src python -m repro_torch.launch.fl_train --dataset synth-mnist \
      --participants 40 --rounds 10 --compact-to 4 [--device cpu]

Drives resource-aware clustering (Procedure 1, Table III vectors) ->
compaction -> participant assignment (Procedure 2) -> master FedAvg ->
slave KD training, and prints per-cluster / global accuracy and the MAR
analysis (Eq. 9 parallel vs Eq. 10 sequential).  The flags are the JAX
launcher's, plus ``--device`` (``cuda`` by default) and ``--profile-out
PATH``, which runs ``train()`` under ``torch.profiler`` with the engine's
tracer on and writes the profiler's Chrome trace there: the engine's spans
as ``port.<name>`` ranges on one timeline with the kernels and copies.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import cost_model, server as srv
from repro_torch.core.families import cnn_family
from repro_torch.core.resources import (LAMBDA_EQUAL, LAMBDA_PAPER, TABLE_III,
                                        participants_from_matrix)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (SPECS, make_classification,
                                        train_test_split)


def run(args):
    ds = make_classification(args.dataset, args.samples, seed=args.seed)
    train, test = train_test_split(ds)
    parts_idx = dirichlet_partition(train.y, args.participants,
                                    alpha=args.dirichlet, seed=args.seed)
    V = TABLE_III
    if args.participants != 40:
        rng = np.random.default_rng(args.seed)
        V = TABLE_III[rng.integers(0, 40, args.participants)]
    parts = participants_from_matrix(V, n_data=[len(p) for p in parts_idx])
    client_data = [{"x": train.x[p], "y": train.y[p]} for p in parts_idx]

    shape, classes = SPECS[args.dataset]
    fam = cnn_family(classes=classes, in_channels=shape[-1],
                     alpha=args.alpha, base_width=args.base_width,
                     input_hw=shape[0])
    lam = LAMBDA_PAPER if args.lam == "paper" else LAMBDA_EQUAL
    cfg = srv.FLConfig(alpha=args.alpha, rounds=args.rounds,
                       steps_per_round=args.steps_per_round, lr=args.lr,
                       lam=lam, compact_to=args.compact_to, seed=args.seed,
                       use_kd=not args.no_kd, kd_T=args.kd_t,
                       kd_alpha=args.kd_alpha, E=args.epochs)
    eng = srv.FedRAC(parts, client_data, fam, cfg, classes=classes,
                     device=args.device).setup()
    print(f"dataset={args.dataset}  device={eng.device}  "
          f"k_optimal={eng.k_optimal} (DI per k: "
          f"{ {k: round(v, 4) for k, v in eng.di_values.items()} })")
    print(f"compacted to m={eng.m}; members per cluster: "
          f"{ {l: len(v) for l, v in eng.assignment.members.items()} }; "
          f"demotions={eng.assignment.demotions}")
    test = {"x": test.x, "y": test.y}
    if args.profile_out:
        res = profiled_train(eng, test, args.profile_out)
    else:
        res = eng.train(test)
    for lvl in range(eng.m):
        h = res.history.get(lvl, [])
        print(f"cluster C{lvl + 1}: final_acc="
              f"{res.final_acc.get(lvl, float('nan')):.4f}  "
              f"curve={[round(a, 3) for a in h]}")
    print(f"GLOBAL accuracy: {res.global_acc:.4f}")

    # MAR analysis (Eq. 9 vs Eq. 10)
    T_m = eng.specs[-1].mar
    par = cost_model.mar_parallel(T_m, cfg.kappa, eng.m)
    seq = cost_model.mar_sequential(T_m, cfg.kappa, eng.m)
    print(f"MAR: parallel(Eq.9)={par:.2f}s  sequential(Eq.10)={seq:.2f}s  "
          f"speedup={seq / par:.2f}x")
    return res


def profiled_train(eng, test, path):
    """``eng.train(test)`` under ``torch.profiler`` with the engine's
    tracer on (unfenced); the profiler's Chrome trace goes to ``path``."""
    import torch
    from repro_torch.obs import make_observability
    acts = [torch.profiler.ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    eng.obs = make_observability(trace=True)
    with torch.profiler.profile(activities=acts) as prof:
        res = eng.train(test)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
    prof.export_chrome_trace(str(path))
    print(f"profile: {len(eng.obs.tracer.events())} spans -> {path}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synth-mnist", choices=list(SPECS))
    ap.add_argument("--participants", type=int, default=40)
    ap.add_argument("--samples", type=int, default=2400)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps-per-round", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--base-width", type=float, default=0.25)
    ap.add_argument("--dirichlet", type=float, default=1.0)
    ap.add_argument("--compact-to", type=int, default=4)
    ap.add_argument("--lam", default="paper", choices=["paper", "equal"])
    ap.add_argument("--kd-t", type=float, default=2.0)
    ap.add_argument("--kd-alpha", type=float, default=0.3)
    ap.add_argument("--no-kd", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile-out", default=None, metavar="PATH",
                    help="write a torch.profiler Chrome trace of train(), "
                         "the engine's spans drawn as port.* ranges")
    args = ap.parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
