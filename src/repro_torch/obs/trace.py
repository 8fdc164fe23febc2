"""Span-based tracing of the round pipeline, exported as Chrome-trace JSON
(loadable in ``chrome://tracing`` and Perfetto).

The tracer is deliberately tiny: a span is one appended tuple on exit, and
call sites hold a tracer reference that defaults to ``NULL_TRACER`` — whose
``span()`` returns a shared no-op context manager, so the disabled fast
path costs a single attribute lookup + two empty calls per span.

**On the profiler's clock.**  While a recording tracer holds a span open it
also holds a ``torch.profiler.record_function("port.<name>")`` range
open, so a running ``torch.profiler`` draws the program's spans on the
same timeline as the kernels and copies they launched.  The null tracer
enters no range.  Retroactive ``complete`` records are the tracer's alone.

**Fencing.**  CUDA launches are asynchronous: a span closing right after a
kernel launch measures *submission*, not execution.  ``Tracer(fence=True)``
makes ``tracer.fence(x)`` call ``torch.cuda.synchronize`` on the device of
the CUDA tensors in ``x`` so span timings are honest on the card, at the
cost of serializing the pipeline — opt-in, off by default, a no-op for CPU
tensors, and an identity on the null tracer.
"""
from __future__ import annotations

import json
import time


RANGE_PREFIX = "port."


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_range")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        from torch.profiler import record_function
        self._range = record_function(RANGE_PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._events.append(
            (self.name, self.cat, self._t0, t1 - self._t0, self.args))
        self._range.__exit__(*exc)
        return False


class _NullSpan:
    """Shared no-op span: the single-branch disabled fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every op is a no-op, ``fence`` is identity."""
    __slots__ = ()
    enabled = False
    fencing = False

    def span(self, name, cat="sim", **args):
        return _NULL_SPAN

    def instant(self, name, cat="sim", **args):
        pass

    def complete(self, name, t0_ns, dur_ns, cat="sim", **args):
        pass

    def fence(self, value):
        return value

    def events(self):
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer.  ``span(name)`` is a context manager; nesting is
    implied by interval containment (all spans are synchronous on one
    host thread, so Chrome/Perfetto reconstruct the stack from overlap)."""
    __slots__ = ("_events", "_origin_ns", "fencing")
    enabled = True

    def __init__(self, fence: bool = False):
        self._events = []          # (name, cat, t0_ns, dur_ns, args|None)
        self._origin_ns = time.perf_counter_ns()
        self.fencing = fence

    def span(self, name, cat="sim", **args):
        return _Span(self, name, cat, args or None)

    def instant(self, name, cat="sim", **args):
        self._events.append(
            (name, cat, time.perf_counter_ns(), 0, args or None))

    def complete(self, name, t0_ns, dur_ns, cat="sim", **args):
        """Record a span retroactively from caller-measured timestamps
        (``time.perf_counter_ns()``) — used where a context manager can't
        wrap the timed region, e.g. lazily-detected XLA compiles."""
        self._events.append((name, cat, t0_ns, dur_ns, args or None))

    def fence(self, value):
        """Wait for the card to finish the work behind ``value`` (a tensor
        or a dict/list/tuple tree of them) when fencing is enabled — call
        inside a span to make its duration cover device execution, not
        just the launches.  CPU tensors need no wait."""
        if self.fencing:
            synchronize(value)
        return value

    # ------------------------------------------------------------ export
    def events(self) -> list[dict]:
        """Chrome-trace event dicts (ts/dur in µs from the tracer origin)."""
        o = self._origin_ns
        out = []
        for name, cat, t0, dur, args in sorted(self._events,
                                               key=lambda e: e[2]):
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": (t0 - o) / 1e3, "dur": dur / 1e3,
                  "pid": 0, "tid": 0}
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            out.append(ev)
        return out

    def to_chrome(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": "fedrac"}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def synchronize(value) -> None:
    """Wait until the card has finished the work behind the CUDA tensors in
    ``value`` (a tensor or a dict/list/tuple tree of them); nothing to wait
    for on the CPU."""
    dev = _cuda_device(value)
    if dev is not None:
        import torch
        torch.cuda.synchronize(dev)


def _cuda_device(value):
    """The device of the first CUDA tensor in a tree, or None."""
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
        return None
    dev = getattr(value, "device", None)
    return dev if getattr(dev, "type", None) == "cuda" else None


def _jsonable(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


def span_coverage(events: list[dict], root: str) -> float:
    """Fraction of the ``root`` span's duration covered by the union of the
    other spans nested inside it (nesting = interval containment, so doubly
    counted children collapse in the union).  Used by the validator to
    assert the trace accounts for ≥95% of measured wall-clock."""
    roots = [e for e in events
             if e.get("ph") == "X" and e["name"] == root]
    if not roots:
        raise ValueError(f"no {root!r} span in trace")
    r = roots[0]
    lo, hi = r["ts"], r["ts"] + r["dur"]
    if r["dur"] <= 0:
        return 1.0
    ivals = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events
                   if e.get("ph") == "X" and e is not r
                   and e["ts"] >= lo and e["ts"] + e["dur"] <= hi)
    covered, cur_lo, cur_hi = 0.0, None, None
    for a, b in ivals:
        if cur_lo is None:
            cur_lo, cur_hi = a, b
        elif a <= cur_hi:
            cur_hi = max(cur_hi, b)
        else:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
    if cur_lo is not None:
        covered += cur_hi - cur_lo
    return covered / r["dur"]
