"""Structured observability: metrics registry + round-pipeline tracing.

Everything downstream (engine, FedRAC, CLIs) takes an ``Observability``
bundle.  ``NULL_OBS`` is the disabled singleton whose tracer spans and
registry lookups cost one branch — safe to thread through hot loops
unconditionally.

Model code, which takes no bundle, reaches the engine's through
``current()``: ``FedRAC.train`` makes its own current for the length of
the call (``observing``).  Outside one it is ``NULL_OBS``.
"""
from __future__ import annotations

from contextlib import contextmanager

from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Table)
from .trace import (NULL_TRACER, NullTracer, Tracer, span_coverage)


class Observability:
    """Bundle of a metrics registry and a tracer.  ``on`` gates the
    instrumented slow paths at call sites with a single branch."""
    __slots__ = ("registry", "tracer", "on")

    def __init__(self, registry=None, tracer=None, *, on=True):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.on = on


NULL_OBS = Observability(registry=MetricsRegistry(), tracer=NULL_TRACER,
                         on=False)


def make_observability(*, trace: bool = True, fence: bool = False
                       ) -> Observability:
    """Fresh enabled bundle; ``fence=True`` makes spans wait for the card
    (``torch.cuda.synchronize``: honest device timings, serialized
    pipeline)."""
    return Observability(MetricsRegistry(),
                         Tracer(fence=fence) if trace else NULL_TRACER,
                         on=True)


_CURRENT = NULL_OBS


def current() -> Observability:
    """The bundle that model code reports to: the engine's during a
    ``train()`` call, ``NULL_OBS`` otherwise.  One module global, so that
    autograd's device thread, which runs the backward, sees it too."""
    return _CURRENT


@contextmanager
def observing(bundle: Observability):
    """Make ``bundle`` current for the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = bundle
    try:
        yield bundle
    finally:
        _CURRENT = prev


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Table",
    "Tracer", "NullTracer", "NULL_TRACER", "span_coverage",
    "Observability", "NULL_OBS", "make_observability", "current",
    "observing",
]
