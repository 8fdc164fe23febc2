"""Shared arithmetic of the per-layer metric readers (``metrics/``).  A
reader returns None when its run holds nothing for it to read.

What a traced run hands a reader (``run``): ``spans`` and ``calls`` (the
benchmark's spans; the calls that timed them), ``port_events`` and
``counters`` (the program's tracer events and its registry's counters
in those calls), ``profile`` (``timeline.reduce_profile`` of the
profiled calls) with ``kernel_calls`` (the kernels' recorded shapes in
them), ``ranges`` (``timeline.program_ranges`` of the one call profiled
with the program's ranges), ``clean_calls`` and ``clean_s`` (the
untraced calls), ``flops_per_call`` (the kind's model FLOPs)."""
from __future__ import annotations

from bench import counts


def span_ms(run, name: str):
    """Milliseconds a ``train()`` call spent in the benchmark span
    ``name``, over the run's calls that timed spans."""
    if not run.calls:
        return None
    return run.spans.total_s(name, run.calls) / len(run.calls) * 1e3


def port_span_ms(run, name: str):
    """Mean milliseconds of the program's own span ``name``."""
    durs = [e["dur"] for e in run.port_events if e["name"] == name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def roofline(run, kernel: str, work):
    """Percent of the bound: the least time of the recorded calls (each
    call's (bytes, operations) from ``work``) over the device time of the
    kernels whose name holds ``kernel``.  None when there is no such call
    or the profile's launches do not pair with the calls."""
    prof = run.profile
    calls = run.kernel_calls.get(kernel, [])
    if prof is None or not calls:
        return None
    names = [n for n in prof["by_op"] if kernel in n]
    launches = sum(prof["count_by_op"][n] for n in names)
    if launches == 0:
        return None
    if launches != len(calls):
        raise ValueError(f"{launches} {kernel} launches in the profile for "
                         f"{len(calls)} recorded calls")
    t_ms = sum(prof["by_op"][n] for n in names) * 1e3
    b_ms = sum(counts.bound_ms(*work(c))[0] for c in calls)
    return 100.0 * b_ms / t_ms


def fedagg_roofline(run):
    return roofline(run, "fedagg", lambda c: counts.fedagg_work(*c))


def flash_roofline(run):
    return roofline(run, "flash_", lambda c: counts.flash_work(*c))


def idle_share(run):
    prof = run.profile
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu(run):
    """Percent of the TF32 peak: the model FLOPs of the untraced calls
    (no span timed, nothing fenced) over their seconds."""
    if not run.clean_calls or run.clean_s <= 0:
        return None
    return (100.0 * run.flops_per_call * run.clean_calls
            / (run.clean_s * counts.TF32_FLOPS_PER_S))


def range_ms(run, name: str):
    """Device milliseconds of the kernels launched inside the program's
    innermost ``name`` ranges in the ranges call, their union across
    streams.  None where the range launched no kernel (as on the CPU)."""
    r = run.ranges.get(name)
    return r["union_ms"] if r and r["kernels"] else None
