"""What a traced run records, and its reduction.

``Spans``: the benchmark's own spans around the calls it makes into the
engine (``train``, ``init_params``, ``evaluate``, ``dispatch_rounds``),
on the host clock, and as ``torch.profiler.record_function`` ranges so
that the device timeline knows what the host was doing.  Off (``--trace
0``), a span is a shared no-op.

``KernelCalls``: the shapes of every call into the program's kernel
entry points while the profiler runs, taken from the call's arguments.

``reduce_profile``: from a ``torch.profiler`` run, the device intervals
(kernels, copies, sets), their union, the time by operation and the idle
gaps named by the benchmark span the host spent most of each in.

``program_ranges``: from a profiled call with the program's tracer on
(its spans are ``port.<name>`` ranges), each range's device time, every
kernel counted once in the innermost range that launched it
(``launch_ranges``, which the stand-alone ``probe_port_ranges.py``
reads as well).
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager, nullcontext

_NULL = nullcontext()
PORT = "port."                   # the program's spans as profiler ranges
RANGE_PREFIXES = (PORT, "bench.")


def is_range(name: str) -> bool:
    """A host range of the program or the benchmark, not device work."""
    return name.startswith(RANGE_PREFIXES)


class Spans:
    """``fences``: whether the spans timed on the host clock end in a
    synchronize (off in profiled calls, whose timeline times them)."""

    def __init__(self, torch, on: bool, sync: bool):
        self.torch, self.on, self.sync = torch, on, sync
        self.fences = True
        self.records = []            # (name, t0_s, t1_s, call)
        self.call = 0

    def span(self, name: str, fence: bool = False):
        return self._span(name, fence) if self.on else _NULL

    @contextmanager
    def _span(self, name, fence):
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(f"bench.{name}"):
            yield
            if fence and self.sync:
                self.torch.cuda.synchronize()
        self.records.append((name, t0, time.perf_counter(), self.call))

    def total_s(self, name: str, calls) -> float:
        return sum(t1 - t0 for n, t0, t1, c in self.records
                   if n == name and c in calls)


class KernelCalls:
    """Wraps a module's kernel entry point (a function with a ``launches``
    counter, which its body increments by its module-level name) to record
    each call's shapes while ``active``."""

    def __init__(self, module, name: str, describe):
        self.module, self.name, self.describe = module, name, describe
        self.calls, self.active = [], False
        orig = getattr(module, name)

        def wrapper(*args, **kw):
            if self.active:
                self.calls.append(describe(*args, **kw))
            return orig(*args, **kw)

        wrapper.launches = orig.launches
        self.orig = orig
        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def device_events(prof, torch):
    """(name, start_us, end_us) of every device-side event: kernels, copies
    and sets, on the profiler's clock.  The profiler also draws each host
    ``record_function`` range on the device's timeline (the benchmark's
    ``bench.`` and the program's ``port.`` ones); those are not device
    work and are left out."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not is_range(e.name)):
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def host_ranges(prof, prefix: str = "bench."):
    """(name without prefix, start_us, end_us) of the benchmark's spans."""
    return [(e.name[len(prefix):], e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith(prefix) and e.device_type.name == "CPU"]


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_profile(prof, torch):
    """The traced window (from the first ``train`` span's start to the last
    one's end), the device's busy seconds in it (the union of device
    intervals), seconds by device operation, and the idle gaps, each
    named by the benchmark span that covers most of it."""
    ranges = host_ranges(prof)
    calls = [(s, e) for n, s, e in ranges if n == "train"]
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    dev = [(n, max(s, w0), min(e, w1))
           for n, s, e in device_events(prof, torch) if e > w0 and s < w1]
    busy = union([(s, e) for _, s, e in dev])
    by_op, count_by_op = {}, {}
    for n, s, e in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        count_by_op[n] = count_by_op.get(n, 0) + 1
    gaps, cur = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    named = []
    inner = [r for r in ranges if r[0] != "train"]
    for s, e in gaps:
        # the span the host spent most of the gap in; "train" when the
        # engine was outside every inner span for most of it
        best, most = "train", (e - s) / 2
        for n, a, b in inner:
            overlap = min(b, e) - max(a, s)
            if overlap > most:
                best, most = n, overlap
        named.append((best, (e - s) / 1e6))
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "by_op": by_op, "count_by_op": count_by_op, "gaps": named}


def launch_ranges(prof, torch):
    """Device time of the program's ranges: each kernel counted once, in
    the innermost ``port.`` range whose host interval holds the start of
    the runtime call that launched it (the kernel's correlation id), so
    that kernels launched from autograd's device thread count where their
    backward ran.  Returns ({range name: {"count": host intervals,
    "kernels", "sum_ms": their device ms, "union_ms": the union of their
    intervals across streams}}, {"unranged_ms", "unmatched_ms",
    "total_ms", "n_kernels"})."""
    cuda = torch.autograd.DeviceType.CUDA
    ivals, runtime, kernels = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not is_range(n):
                kernels.append(e)
        elif n.startswith(PORT):
            ivals.setdefault(n, []).append((e.start_ns(), e.end_ns()))
        elif n.startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
    for v in ivals.values():
        v.sort()
    ranges = {n: {"count": len(v), "kernels": 0, "sum_ms": 0.0,
                  "union_ms": 0.0} for n, v in ivals.items()}
    spans_of = {}
    unranged = unmatched = total = 0.0
    for k in kernels:
        d = k.duration_ns() / 1e6
        total += d
        t0 = runtime.get(k.correlation_id())
        if t0 is None:
            unmatched += d
            continue
        best, width = None, None
        for n, iv in ivals.items():
            j = bisect.bisect_right(iv, (t0, float("inf"))) - 1
            if j >= 0 and iv[j][0] <= t0 <= iv[j][1]:
                w = iv[j][1] - iv[j][0]
                if width is None or w < width:
                    best, width = n, w
        if best is None:
            unranged += d
            continue
        ranges[best]["kernels"] += 1
        ranges[best]["sum_ms"] += d
        spans_of.setdefault(best, []).append((k.start_ns(), k.end_ns()))
    for n, v in spans_of.items():
        ranges[n]["union_ms"] = sum(b - a for a, b in union(v)) / 1e6
    return ranges, {"unranged_ms": unranged, "unmatched_ms": unmatched,
                    "total_ms": total, "n_kernels": len(kernels)}


def program_ranges(prof, torch) -> dict:
    """``launch_ranges``' ranges by the program's span name (``port.``
    left off), as the per-layer readers get them (``run.ranges``)."""
    return {n[len(PORT):]: r for n, r in launch_ranges(prof, torch)[0].items()}

