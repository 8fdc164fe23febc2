#!/usr/bin/env python3
"""The control and the planted faults, at a cell's own size: what the
check reads when something other than a sound program produced the
output.  Not part of a benchmark run.

  python3 bench/control.py --workload <cell> --seeds 11 12 13 [--device cuda]

For each seed it computes the reference once in fp32 with TF32 off (the
reference the check uses), then puts in the program's place:

- ``tf32``: the reference in TF32, the precision below the configuration's
  fp32 (on the card the hardware's, ``torch.backends`` flags on; on the
  CPU emulated, ``reference/numerics.py``);
- ``half_batch``: the reference with half of every batch left out, the
  mean over the rest;
- ``frozen``: the reference whose steps return their parameters
  unchanged (by the change measure it reads 1);
- ``tf32_slaves``, ``half_batch_slaves`` (cells with KD): the same
  confined to the KD clusters, the master trained soundly;

and prints one JSON line of the check's numbers for each.  As in a run,
the judging reference's slaves distil from the master of the output
judged.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def as_program(ref: dict, accuracy: bool) -> dict:
    """A reference output in the shape ``check.program_outputs`` gives."""
    levels = ref["levels"]
    return {"members": {l: m for l, m in ref["members"].items() if m},
            "n_eff": dict(ref["n_eff"]),
            "losses": {l: v["losses"] for l, v in levels.items()},
            "evals": {l: v["evals"] for l, v in levels.items()},
            "final": {l: v["final"] for l, v in levels.items()},
            "accuracy": accuracy}


VARIANTS = ("tf32", "half_batch", "frozen", "tf32_slaves",
            "half_batch_slaves")


def readings(cell, seed: int, device: str, variants=VARIANTS) -> dict:
    import torch
    from bench import check, program, traffic
    from bench.reference import fedrac
    from bench.reference.numerics import FP32, TF32
    cfg, fl = cell["config"], cell["traffic"]["fl"]
    dev = torch.device(device)
    fed = traffic.generate(cell["traffic"], cfg, seed)
    kind = program.kind_module(cfg)
    classes = kind.classes(cfg)
    kd = fl["use_kd"]

    def run(num=FP32, fault=None, **kw):
        return fedrac.train_call(cfg["reference"], cfg, fed, fl, seed, dev,
                                 num, fault=fault, classes=classes, **kw)

    def with_slaves(master_of, slaves_of):
        out = dict(slaves_of)
        out["levels"] = {0: master_of["levels"][0], **slaves_of["levels"]}
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = run()
    slaves = [l for l in ref["levels"] if l > 0]
    out = {}
    for v in variants:
        name, confined = v.removesuffix("_slaves"), v.endswith("_slaves")
        if confined and not kd:
            continue
        num, fault = (TF32, None) if name == "tf32" else (FP32, name)
        if confined:
            got = with_slaves(ref, run(num, fault, levels=slaves,
                                       at_levels=slaves,
                                       teacher=ref["levels"][0]["final"]))
            judge = ref
        else:
            got = run(num, fault)
            judge = (with_slaves(ref, run(
                levels=slaves, teacher=got["levels"][0]["final"]))
                if kd and slaves else ref)
        out[v] = check.numbers(as_program(got, kind.EVAL_IS_ACCURACY),
                               judge, fed["n_test"], kd)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import manifest
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        for variant, nums in readings(cell, seed, args.device,
                                      args.variants).items():
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "control": variant, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
