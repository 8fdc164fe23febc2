#!/usr/bin/env python3
"""Stand-alone probe of the program's own spans on a cell (no cell runs it).

  python3 bench/probe_port_ranges.py --workload <cell> --seed <n> [--pairs 2]

Two readings, printed as one JSON line:

- The cost of the program's tracer: ``train()`` calls with an unfenced
  tracing bundle (``make_observability(trace=True, fence=False)``, no
  profiler running) against calls with ``NULL_OBS``, in alternating
  order, after one warm-up call.
- One ``train()`` call under ``torch.profiler`` with the tracer on, so the
  program's spans are ``port.<span>`` ranges on the kernels' timeline.
  The device's idle gaps are named by the innermost ``port.`` or
  ``bench.`` range that covers most of each.  Device ms are given per
  range in two ways: ``device_ms_tree``, each range's
  ``device_time_total`` in the profiler's event tree (which counts a
  kernel in every range around it, on every stream), and
  ``device_ms_by_launch``, each kernel counted once, in the innermost
  range whose host interval holds the runtime call that launched it (the
  launch's correlation id), with ``device_ms_union_by_launch`` the union
  of those kernels' intervals across streams (``timeline.launch_ranges``,
  which a traced benchmark run's ``run.ranges`` read too).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import manifest, program, timeline  # noqa: E402
from bench import traffic as tg  # noqa: E402


def spread(values):
    """Interquartile range over the median, or None for fewer than two."""
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def probe(cell: dict, seed: int, pairs: int, device: str = "cuda") -> dict:
    import torch
    from repro_torch.obs import NULL_OBS, make_observability

    cfg, traffic = cell["config"], cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels import _build
        _build.build()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fed = tg.generate(traffic, cfg, seed)
    spans = timeline.Spans(torch, on=False, sync=on_card)
    eng = program.build_engine(cfg, traffic, fed, seed, dev, spans)
    test = fed["test"]
    out = {"seed": seed, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0) if on_card else "cpu"}
    eng.train(test)
    sync()
    times = {"clean": [], "traced": []}
    host = {}
    for i in range(pairs):
        order = ("clean", "traced") if i % 2 == 0 else ("traced", "clean")
        for kind in order:
            eng.obs = (NULL_OBS if kind == "clean"
                       else make_observability(trace=True, fence=False))
            eng.block_losses = []
            t = time.perf_counter()
            eng.train(test)
            sync()
            times[kind].append(time.perf_counter() - t)
            if kind == "traced":
                for e in eng.obs.tracer.events():
                    host.setdefault(e["name"], []).append(e["dur"] / 1e3)
    eng.obs = NULL_OBS
    med = {k: statistics.median(v) for k, v in times.items()}
    out.update(call_s=times, median_s=med,
               spread={k: spread(v) for k, v in times.items()},
               traced_over_clean=med["traced"] / med["clean"] - 1,
               host_span_ms_per_call={k: sum(v) / pairs
                                      for k, v in host.items()},
               host_spans_per_call={k: len(v) / pairs
                                    for k, v in host.items()})

    eng.obs = make_observability(trace=True, fence=False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.train"):
            eng.train(test)
            sync()
    eng.obs = NULL_OBS
    out["profile"] = reduce(prof, torch)
    return out


def reduce(prof, torch) -> dict:
    """A profiled call under the benchmark's ``bench.train`` range: its
    window, busy and idle time, its gaps named by the innermost ``port.``
    or ``bench.`` range covering most of each, the host intervals of each
    ``port.`` range, each range's ``device_time_total`` in the profiler's
    event tree (which counts a kernel in every range around it, on every
    stream) and its device ms by launch (``timeline.launch_ranges``)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.events()
    rng = [(e.name, e.time_range.start, e.time_range.end) for e in evs
           if e.device_type != cuda and timeline.is_range(e.name)]
    w0, w1 = next((s, t) for n, s, t in rng if n == "bench.train")
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
           for e in evs if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and not timeline.is_range(e.name)
           and e.time_range.end > w0 and e.time_range.start < w1]
    busy = timeline.union(dev)
    busy_us = sum(t - s for s, t in busy)
    gaps, cur = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    inner = [r for r in rng if r[0] != "bench.train"]
    named = []
    for s, t in gaps:
        best, width = "train", None
        for n, a, b in inner:
            if (min(b, t) - max(a, s) > (t - s) / 2
                    and (width is None or b - a < width)):
                best, width = n, b - a
        named.append((best, (t - s) / 1e6))
    named.sort(key=lambda g: -g[1])
    gap_s = {}
    for n, s in named:
        gap_s[n] = gap_s.get(n, 0.0) + s
    names = sorted({n for n, _, _ in rng if n.startswith(timeline.PORT)})
    tree = {n: sum(e.device_time_total for e in evs if e.name == n) / 1e3
            for n in names}
    by, totals = timeline.launch_ranges(prof, torch)
    counted = {n: r for n, r in by.items() if r["kernels"]}
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "idle_share": 100 * (1 - busy_us / (w1 - w0)),
            "gaps_top": named[:12], "gap_s_by_range": gap_s,
            "ranges": {n: sum(r[0] == n for r in rng) for n in names},
            "device_ms_tree": tree,
            "device_ms_by_launch": {n: r["sum_ms"]
                                    for n, r in counted.items()},
            "device_ms_union_by_launch": {n: r["union_ms"]
                                          for n, r in counted.items()},
            "device_ms_unranged": totals["unranged_ms"],
            "device_ms_unmatched": totals["unmatched_ms"],
            "device_ms_kernels_total": totals["total_ms"],
            "n_kernels": totals["n_kernels"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = probe(manifest.cell(args.workload), args.seed, args.pairs,
                args.device)
    print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
