#!/usr/bin/env python3
"""Benchmark of the PyTorch port (``src/repro_torch``): Fed-RAC's
``FedRAC.train()`` on one NVIDIA card.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start): TF32 off, the
program's CUDA kernels built into ``build/repro_torch/`` of the checkout
(only a checkout's first run compiles), the federation made from
``--seed``, ``FedRAC(...).setup()`` (Procedure 1 and 2), and one
``train()`` call on the cell's own shapes.  The window then calls
``train()`` back to back and stops at the first call boundary at or after
``--seconds``; every rate is all the work of those calls over all of their
time.  ``attempted`` counts dispatch blocks; ``failed`` those that raised
or returned a non-finite member loss.

``--trace 1`` profiles the window's first ``trace_calls`` calls
(``workloads/<cell>.json``) with ``torch.profiler``, the benchmark's
spans marking the host's phases on its timeline; then one call profiled
apart with the program's tracer on, unfenced, so that its spans are
``port.<name>`` ranges on the kernels' timeline (``run.ranges``); the
calls after them take turns: one with the benchmark's spans and the
program's fenced spans timed (``run.port_events``, ``run.counters``),
one as the untraced window runs, which ``mfu`` reads.  It reports the
cell's per-layer metrics instead of the end-to-end ones.

After the window the last call's output is held against the plain
reference (``check.py``); a KD slave's reference distils from the
program's trained master, as the slave did.  The numbers compared, each beside its limit,
are the last lines on standard error and the last key (``checks``) of
the result, which is the last line on standard output.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")
GIB = 2.0 ** 30
THREADS = 4           # torch's host threads, the same on every machine


def process_start() -> float:
    """The process's start on the wall clock (10 ms resolution), or this
    module's import where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age if 0 <= age < 3600 else T_IMPORT
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T0 = process_start()


def use_checkout_paths():
    """Import the port from the checkout's ``src`` and the harness as the
    ``bench`` package; keep this script's directory off the path."""
    here = str(ROOT / "bench")
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def banned_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None) -> dict:
    """Set up, warm up, measure, check.  Returns the result line's dict.
    ``cell`` is a cell's name or its ``manifest.cell`` dict; the harness's
    own tests pass a dict cut to a small size, and ``device="cpu"``."""
    import torch
    from bench import check, manifest, program, timeline
    from bench.reference import fedrac
    from bench.reference.numerics import FP32
    t0 = T0 if t0 is None else t0
    cell = manifest.cell(cell) if isinstance(cell, str) else cell
    name = cell["name"]
    cfg, traffic, fl = cell["config"], cell["traffic"], cell["traffic"]["fl"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    # the configurations are fp32; the port leaves precision to its caller
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        from repro_torch.kernels import _build
        _build.build()
    from bench import traffic as traffic_gen
    fed = traffic_gen.generate(traffic, cfg, seed)
    spans = timeline.Spans(torch, on=trace, sync=on_card)
    eng = program.build_engine(cfg, traffic, fed, seed, dev, spans)
    kind = program.kind_module(cfg)
    lay = program.layout(eng)
    members = {int(l): v["members"] for l, v in lay.items()}
    units_per_call = (sum(members.values()) * fl["rounds"]
                      * fl["steps_per_round"] * fl["local_batch"]
                      * kind.units_per_sample(traffic))
    flops_per_call = kind.flops_per_call(cfg, traffic, members,
                                         fed["n_test"])
    emit({"cell": name, "seed": seed, "layout": lay,
          "units_per_call": units_per_call, "unit": kind.UNIT,
          "model_flops_per_call": flops_per_call,
          "device": torch.cuda.get_device_name(0) if on_card else "cpu",
          "nvidia_smi": smi_line() if on_card else None,
          "torch": torch.__version__})
    test = fed["test"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # warm-up: one call on the cell's own shapes
    spans.call, spans.on = -1, False
    t_warm = time.perf_counter()
    eng.train(test)
    sync()
    emit({"before_warmup_s": time.time() - t0 - (time.perf_counter()
                                                   - t_warm),
          "warmup_s": time.perf_counter() - t_warm})
    if trace:
        from repro_torch.kernels.fedagg import ops as f_ops
        from repro_torch.kernels.flash import ops as a_ops
        from repro_torch.obs import make_observability
        # keyed by what the kernels' names in the profile hold
        recorders = {
            "fedagg": timeline.KernelCalls(
                f_ops, "weighted_aggregate",
                lambda plane, w: tuple(plane.shape)),
            "flash_": timeline.KernelCalls(
                a_ops, "flash_attention_bh",
                lambda q, k, v, causal=True, window=0, **kw: (
                    q.shape[0], k.shape[0], q.shape[1], q.shape[2],
                    q.element_size(), bool(causal), int(window)))}
        span_obs = make_observability(trace=True, fence=True)
        range_obs = make_observability(trace=True, fence=False)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
    quiet_obs = eng.obs
    warm_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    n_prof = cell["trace_calls"] if trace else 0
    prof, range_prof, attempted, failed, calls = None, None, 0, 0, 0
    call_s, phases = [], []
    error = None
    t_start = time.perf_counter()
    t_setup = time.time() - t0
    while True:
        # profiled calls, the program's ranges profiled, then timed spans
        # and untraced calls in turn
        phase = ("clean" if not trace else "prof" if calls < n_prof
                 else "ranges" if calls == n_prof
                 else ("spans", "clean")[(calls - n_prof - 1) % 2])
        eng.block_losses = []
        spans.call, spans.on = calls, phase != "clean"
        spans.fences = phase == "spans"
        eng.obs = (span_obs if phase == "spans" else range_obs
                   if phase == "ranges" else quiet_obs)
        if phase == "prof" and prof is None:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            for r in recorders.values():
                r.active = True
        if phase == "ranges":
            range_prof = torch.profiler.profile(activities=acts)
            range_prof.start()
        t_call = time.perf_counter()
        try:
            with spans.span("train", fence=True):
                result = eng.train(test)
            sync()
        except Exception:                     # a call that raised fails
            error = traceback.format_exc()
            attempted += max(len(eng.block_losses), 1)
            failed += max(len(eng.block_losses), 1)
            break
        calls += 1
        phases.append(phase)
        call_s.append(time.perf_counter() - t_call)
        attempted += len(eng.block_losses)
        failed += sum(not bool(torch.isfinite(l).all())
                      for _, l in eng.block_losses)
        now = time.perf_counter()
        if prof is not None and calls == n_prof:
            prof.stop()
            for r in recorders.values():
                r.active = False
        if phase == "ranges":
            range_prof.stop()
        if now - t_start >= seconds and (
                not trace or {"spans", "clean"} <= set(phases)):
            break
    window_s = (now if error is None else time.perf_counter()) - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    out = {"correct": False, "attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"],
                   "memory_peak_bytes": int(max(peak, warm_peak))}
    metrics, breakdown = {}, None
    if trace and error is None:
        for r in recorders.values():
            r.restore()
        counters = span_obs.registry.snapshot()["counters"]
        emit({"counters": counters})
        profile = timeline.reduce_profile(prof, torch)
        ranges = timeline.program_ranges(range_prof, torch)
        del prof, range_prof
        run = SimpleNamespace(
            spans=spans,
            calls={i for i, p in enumerate(phases) if p == "spans"},
            clean_calls=phases.count("clean"),
            clean_s=sum(t for t, p in zip(call_s, phases) if p == "clean"),
            port_events=span_obs.tracer.events(), counters=counters,
            ranges=ranges, profile=profile, flops_per_call=flops_per_call,
            kernel_calls={k: r.calls for k, r in recorders.items()})
        for m in cell["per_layer"]:
            value = manifest.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = profile["busy_s"]
        device_info["window_s"] = profile["window_s"]
        ops = sorted(profile["by_op"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:160], s] for n, s in ops],
                     "idle_gaps": [list(g) for g in sorted(
                         profile["gaps"], key=lambda g: -g[1])[:10]]}
    elif error is None:
        e2e = {"samples_per_s": units_per_call * calls / window_s,
               "tokens_per_s": units_per_call * calls / window_s,
               "peak_mem_gib": peak / GIB, "setup_s": t_setup}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    # the check: the last call's output against the plain reference, run
    # once the program's state is freed
    values = {}
    if error is None:
        prog = check.program_outputs(eng, result, kind.EVAL_IS_ACCURACY)
        del eng, result
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        teacher = prog["final"][0] if fl["use_kd"] else None
        ref = fedrac.train_call(cfg["reference"], cfg, fed, fl, seed, dev,
                                FP32, classes=kind.classes(cfg),
                                teacher=teacher)
        values = check.numbers(prog, ref, fed["n_test"], fl["use_kd"])
    correct, checks = check.judge(values, cell["limits"])
    if error is not None:
        print(error, file=sys.stderr)
    out["correct"] = bool(correct and failed == 0 and error is None)
    out["metrics"] = metrics
    out["device"] = device_info
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["window"] = {"calls": calls, "seconds": window_s,
                     "units": units_per_call * calls, "call_s": call_s,
                     "phases": phases}
    out["checks"] = checks
    for k in sorted(set(values) - set(checks)):
        print(f"reading {k} {values[k]!r} (not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_paths()
    import torch
    torch.set_num_threads(THREADS)
    from bench import manifest
    chips = manifest.cell(args.workload)["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); {seen} "
              "visible", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"bench: the run loaded {found}, which the port must not "
              "import", file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
