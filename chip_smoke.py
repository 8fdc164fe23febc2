#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   the card, and TF32 turned off for convolutions and matmuls;
  2. build    both CUDA kernels compiled from ``src/repro_torch/kernels``;
  3. kernels  each kernel against its plain PyTorch version on the card,
              then timed with CUDA events (kernel, plain version, the bound
              from bytes and operations, and a library call where one exists);
  4. main     Algorithm 1 at the paper's full CNN width (C128-C64-C128-C256-
              C512-D10) on synth-mnist with the 40 Table-III participants,
              four rounds per cluster in one dispatch block, then each slave's
              distillation loss against the master on the test set through
              the kernel route.  Launch counts are set to 0 just before and
              read just after: fedagg must run once per dispatched round of
              every non-empty cluster, distill once per trained slave;
  4b. profile the same training again, warm, on the host clock and under
              torch.profiler: device time by kernel and the busy share;
  5. cli     ``repro_torch.launch.fl_train`` on the card;
  6. parity   a small federation on the card (deterministic cuDNN) and on
              the CPU from the same initial weights; the final planes must
              agree.
Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and last ``{"ok": true, "device": {...}}``.  Any failure raises, so
the script exits nonzero and prints no last line.  It exits nonzero at once
when no CUDA card is visible or the package is not beside it.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
ITERS, ITERS_LARGE = 50, 20        # timed calls per measurement
# fp32 operations the distill kernel does per (student, teacher) logit pair:
# 2 divides, 3 max, 6 exp, 4 subtracts, 9 multiply-adds, 1 compare
DISTILL_OPS_PER_LOGIT = 25
FEDAGG_RTOL, FEDAGG_ATOL = 1e-5, 1e-6
PARITY_RTOL, PARITY_ATOL = 2e-4, 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, args_list, iters, *, device_only=True):
    """Mean milliseconds per call over ``iters`` warm calls, cycling through
    ``args_list`` (copies of the inputs, together larger than the L2 cache
    when the inputs are large, so each call reads from device memory).

    ``device_only``: a spin kernel (``torch.cuda._sleep``) holds the stream
    while the host queues every call, so the events bracket device time
    alone; without it, a call whose host side (Python checks, ctypes,
    allocation) outlasts its kernel is timed at the host's pace."""
    import torch
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        # about 1 ms of clock cycles a call: longer than the host needs to
        # queue one call of the plain versions; ITERS keeps the queued
        # launches under the CUDA launch-queue depth
        torch.cuda._sleep(int(iters * 2e6))
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(tensors, nbytes):
    n = min(8, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def check_fedagg(torch, ops, ref, dev, C, D):
    g = torch.Generator(device=dev).manual_seed(C * 131 + D)
    x = torch.randn(C, D, device=dev, generator=g)
    w = torch.rand(C, device=dev, generator=g)
    w = w / w.sum()
    got = ops.weighted_aggregate(x, w)
    want = ref.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=FEDAGG_RTOL,
                               atol=FEDAGG_ATOL)
    return x, w, float((got - want).abs().max())


def time_fedagg(torch, ops, ref, x, w):
    C, D = x.shape
    nbytes = (C * D + C + D) * 4
    args = copies((x, w), nbytes)
    iters = ITERS_LARGE if nbytes > L2_BYTES else ITERS
    b_ms, b_by = bound(nbytes, 2 * C * D)
    return {"ms": time_ms(ops.weighted_aggregate, args, iters),
            "call_ms": time_ms(ops.weighted_aggregate, args, iters,
                               device_only=False),
            "plain_ms": time_ms(ref.weighted_aggregate, args, iters),
            "library_ms": time_ms(lambda p, v: torch.mv(p.t(), v), args,
                                  iters),
            "bound_ms": b_ms, "bound_by": b_by}


def check_distill(torch, ops, ref, dev, N, V, dtype, T=2.0, alpha=0.3):
    g = torch.Generator(device=dev).manual_seed(N * 7 + V)
    s = (torch.randn(N, V, device=dev, generator=g) * 3).to(dtype)
    t = (torch.randn(N, V, device=dev, generator=g) * 3).to(dtype)
    y = torch.randint(0, V, (N,), device=dev, generator=g, dtype=torch.int32)
    rows = ops.kd_loss_rows(s, t, y, T=T, alpha=alpha)
    want_rows = ref.kd_loss_rows(s, t, y, T=T, alpha=alpha)
    torch.cuda.synchronize()
    got, want = float(rows.mean()), float(want_rows.mean())
    # tests/test_distill.py: 1e-3 relative on the mean in fp32, 5e-2 in bf16
    tol = (5e-2 if dtype == torch.bfloat16 else 1e-3) * max(1.0, abs(want))
    if not (math.isfinite(got) and abs(got - want) < tol):
        raise AssertionError(f"distill ({N}, {V}, {dtype}): kernel {got} vs "
                             f"plain {want}, tolerance {tol}")
    return (s, t, y), float((rows - want_rows).abs().max())


def time_distill(torch, ops, ref, args):
    s, t, y = args
    N, V = s.shape
    nbytes = 2 * N * V * s.element_size() + N * y.element_size() + N * 4
    reps = copies(args, nbytes)
    iters = ITERS_LARGE if nbytes > L2_BYTES else ITERS
    b_ms, b_by = bound(nbytes, DISTILL_OPS_PER_LOGIT * N * V)
    return {"ms": time_ms(ops.kd_loss_rows, reps, iters),
            "call_ms": time_ms(ops.kd_loss_rows, reps, iters,
                               device_only=False),
            "plain_ms": time_ms(ref.kd_loss_rows, reps, iters),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


# ------------------------------------------------------------------ main path
def federation(n_part, samples, seed):
    import numpy as np
    from repro_torch.core.resources import TABLE_III, participants_from_matrix
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_classification, \
        train_test_split
    ds = make_classification("synth-mnist", samples, seed=seed)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, n_part, alpha=1.0, seed=seed)
    V = TABLE_III
    if n_part != 40:
        V = TABLE_III[np.random.default_rng(seed).integers(0, 40, n_part)]
    parts = participants_from_matrix(V, n_data=[len(p) for p in idx])
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return parts, cd, {"x": test.x, "y": test.y}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible; this script runs "
                 "the port on an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; "
                 "run the script from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import distill, server as srv
    from repro_torch.core.families import cnn_family
    from repro_torch.kernels import _build
    from repro_torch.kernels.distill import ops as d_ops, ref as d_ref
    from repro_torch.kernels.fedagg import ops as f_ops, ref as f_ref
    from repro_torch.launch import fl_train

    # 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "cudnn_allow_tf32": False,
          "matmul_allow_tf32": False})

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(_build.library_path(n).relative_to(ROOT))
                        for n in _build.SOURCES},
          "ptxas": {n: [l.strip() for l in log.splitlines()
                        if "registers" in l or "spill" in l]
                    for n, log in logs.items()}})

    # the main path's engine, set up (host-side Procedure 1 and 2) so the
    # kernels are checked and timed at the shapes it will give them
    parts, cd, test = federation(40, 2400, 3)
    cfg = srv.FLConfig(rounds=4, rounds_per_dispatch=4, compact_to=4, seed=3)

    class Recording(srv.FedRAC):
        """Keeps each block's per-round member losses for the checks."""

        def dispatch_rounds(self, *args, **kw):
            out = super().dispatch_rounds(*args, **kw)
            self.block_losses.append(out.losses)
            return out

    eng = Recording(parts, cd, cnn_family(base_width=1.0), cfg, classes=10,
                    device="cuda").setup()
    eng.block_losses = []
    members = eng.assignment.members
    live = [l for l in range(eng.m) if members.get(l)]
    main_shapes = {l: (eng._capacity(len(members[l])),
                       eng.plane_spec(l).d_pad) for l in live}
    n_test = len(test["y"])

    # 3. kernels ----------------------------------------------------------
    fed_shapes = sorted(set(main_shapes.values()) | {(16, 1_629_440),
                                                     (16, 409_216)})
    fed_checks = {}
    for C in (1, 3, 64):
        for D in (128, 2176):
            fed_checks[(C, D)] = check_fedagg(torch, f_ops, f_ref, dev, C,
                                              D)[2]
    fed_timed = {}
    for C, D in fed_shapes:
        x, w, err = check_fedagg(torch, f_ops, f_ref, dev, C, D)
        fed_checks[(C, D)] = err
        fed_timed[(C, D)] = dict(time_fedagg(torch, f_ops, f_ref, x, w),
                                 max_abs_err=err)
        del x, w
    emit({"phase": "kernels", "kernel": "fedagg",
          "tolerance": {"rtol": FEDAGG_RTOL, "atol": FEDAGG_ATOL},
          "max_abs_err": {f"{C}x{D}": e for (C, D), e in fed_checks.items()},
          "timed": {f"{C}x{D}": v for (C, D), v in fed_timed.items()}})
    dist_cases = [(n_test, 10, torch.float32), (256, 10, torch.float32),
                  (8, 7000, torch.float32), (512, 151_936, torch.float32),
                  (16, 512, torch.bfloat16)]
    dist_timed = {}
    for N, V, dt in dist_cases:
        args, err = check_distill(torch, d_ops, d_ref, dev, N, V, dt)
        dist_timed[(N, V, str(dt))] = dict(
            time_distill(torch, d_ops, d_ref, args), max_abs_err=err)
        del args
    emit({"phase": "kernels", "kernel": "distill",
          "tolerance": "tests/test_distill.py: |mean - plain| < 1e-3 "
                       "(fp32) or 5e-2 (bf16) times max(1, |plain|)",
          "timed": {f"{N}x{V}:{dt}": v
                    for (N, V, dt), v in dist_timed.items()}})

    # 4. main path, full width --------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f_ops.weighted_aggregate.launches = 0
    d_ops.kd_loss_rows.launches = 0
    t0 = time.perf_counter()
    res = eng.train(test)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    xt = torch.as_tensor(test["x"], device=dev)
    yt = torch.as_tensor(test["y"], device=dev)
    kd_report = {}
    with torch.no_grad():
        _, t_logits = eng.family.loss_and_logits(0, eng.master_params,
                                                 {"x": xt, "y": yt})
        for level, p in eng.cluster_params.items():
            if level == 0:
                continue
            _, s_logits = eng.family.loss_and_logits(level, p,
                                                     {"x": xt, "y": yt})
            kd_report[level] = float(distill.kd_loss(
                s_logits, yt, t_logits, T=cfg.kd_T, alpha=cfg.kd_alpha,
                use_kernel=True))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"fedagg": f_ops.weighted_aggregate.launches,
                "distill": d_ops.kd_loss_rows.launches}
    dispatched = cfg.rounds * len(live)
    if not (dispatched > 0 and launches["fedagg"] == dispatched):
        raise AssertionError(f"fedagg launched {launches['fedagg']} times, "
                             f"expected {dispatched} dispatched rounds")
    slaves = [l for l in live if l > 0]
    if not (slaves and launches["distill"] == len(slaves)):
        raise AssertionError(f"distill launched {launches['distill']} times "
                             f"for slaves {slaves}")
    planes = {l: eng.plane_of(l, p) for l, p in eng.cluster_params.items()}
    for losses in eng.block_losses:
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("a dispatched round produced a non-finite "
                                 "member loss")
    for l, pl in planes.items():
        if not bool(torch.isfinite(pl).all()):
            raise AssertionError(f"cluster {l} ended with a non-finite plane")
    if not all(math.isfinite(v) for v in kd_report.values()):
        raise AssertionError(f"non-finite distillation loss {kd_report}")
    emit({"phase": "main", "k_optimal": eng.k_optimal, "m": eng.m,
          "di_values": {str(k): v for k, v in eng.di_values.items()},
          "members": {str(l): len(v) for l, v in members.items()},
          "capacity_and_d_pad": {str(l): list(v)
                                 for l, v in main_shapes.items()},
          "history": {str(l): h for l, h in res.history.items()},
          "global_acc": res.global_acc,
          "slave_kd_loss_vs_master": {str(l): v
                                      for l, v in kd_report.items()},
          "train_seconds": train_s, "main_seconds": main_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "dispatched_rounds": dispatched})

    # 4b. where the time goes: the same train() again, warm (programs
    # built, cuDNN initialised), once on the host clock and once under
    # torch.profiler for the device time by kernel
    t0 = time.perf_counter()
    eng.train(test)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        eng.train(test)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, sets): the host op rows
        # repeat the device time of the kernels they launch
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.count, e.key[:90]))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    emit({"phase": "profile", "warm_train_seconds": warm_s,
          "profiled_train_seconds": prof_s,
          "device_seconds": device_s,
          # both from the profiled run: tracing adds time to every launch on
          # the host and on the device, so the share is approximate
          "device_busy_share_profiled": device_s / prof_s if rows else None,
          "fedagg_kernel": [{"calls": c, "ms": us / 1e3}
                            for us, c, k in rows if "fedagg" in k],
          "top_device_ops": [{"name": k, "calls": c, "ms": us / 1e3}
                             for us, c, k in rows[:10]]})

    # 5. cli --------------------------------------------------------------
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli = fl_train.main(["--participants", "16", "--rounds", "2",
                             "--base-width", "0.125", "--samples", "800",
                             "--device", "cuda"])
    emit({"phase": "cli", "seconds": time.perf_counter() - t0,
          "global_acc": cli.global_acc,
          "last_lines": buf.getvalue().strip().splitlines()[-2:]})

    # 6. card == CPU ------------------------------------------------------
    # deterministic cuDNN algorithms: the same convolution algorithm in
    # every run, so the card's distance from the CPU does not vary by run
    torch.backends.cudnn.deterministic = True
    finals, inits = {}, {}
    for where in ("cpu", "cuda"):
        parts, cd, test = federation(8, 400, 3)
        e = srv.FedRAC(parts, cd, cnn_family(base_width=0.125),
                       srv.FLConfig(rounds=2, rounds_per_dispatch=2,
                                    compact_to=2, seed=3),
                       classes=10, device=where).setup()
        inits[where] = {l: e.plane_of(l, e.init_params(l)).cpu()
                        for l in range(e.m)}
        e.train(test)
        finals[where] = {l: e.plane_of(l, p).cpu()
                         for l, p in e.cluster_params.items()}
    parity = {}
    for l in finals["cpu"]:
        torch.testing.assert_close(inits["cuda"][l], inits["cpu"][l],
                                   rtol=0, atol=0)
        torch.testing.assert_close(finals["cuda"][l], finals["cpu"][l],
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)
        diff = (finals["cuda"][l] - finals["cpu"][l]).abs()
        allowed = PARITY_ATOL + PARITY_RTOL * finals["cpu"][l].abs()
        parity[str(l)] = {"max_abs_diff": float(diff.max()),
                          "worst_share_of_tolerance":
                              float((diff / allowed).max())}
    emit({"phase": "parity", "tolerance": {"rtol": PARITY_RTOL,
                                           "atol": PARITY_ATOL},
          "levels": parity})

    # kernels line, card line, last line -----------------------------------
    C0, D0 = main_shapes[0]
    fed = fed_timed[(C0, D0)]
    dist = dist_timed[(n_test, 10, str(torch.float32))]
    emit({"kernels": [
        {"name": "fedagg", "route": "cuda",
         "source": "src/repro_torch/kernels/fedagg/csrc/fedagg.cu",
         "replaces": "src/repro/kernels/fedagg/kernel.py:23",
         "shape": [C0, D0], "launches": launches["fedagg"],
         "max_abs_err": fed["max_abs_err"], "ms": fed["ms"],
         "plain_ms": fed["plain_ms"], "bound_ms": fed["bound_ms"],
         "bound_by": fed["bound_by"], "library_ms": fed["library_ms"]},
        {"name": "distill", "route": "cuda",
         "source": "src/repro_torch/kernels/distill/csrc/distill.cu",
         "replaces": "src/repro/kernels/distill/kernel.py:83",
         "shape": [n_test, 10], "launches": launches["distill"],
         "max_abs_err": dist["max_abs_err"], "ms": dist["ms"],
         "plain_ms": dist["plain_ms"], "bound_ms": dist["bound_ms"],
         "bound_by": dist["bound_by"], "library_ms": dist["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
