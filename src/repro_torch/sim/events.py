"""Participant lifecycle events consumed by the simulation engine.

All events are frozen dataclasses keyed by participant id; the engine
dispatches on type.  Timestamps live in the queue, not the event, so the
same event object can be rescheduled (e.g. an auto-rejoin ``Arrival``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Event:
    pid: int


@dataclass(frozen=True)
class Arrival(Event):
    """Participant comes online.  Trace-authored arrivals (late joiners)
    carry ``token=None`` and always apply; engine-scheduled rejoins carry the
    departure generation that queued them, so a newer ``Departure`` landing
    inside the rejoin window supersedes the stale rejoin."""
    token: int | None = None


@dataclass(frozen=True)
class Departure(Event):
    """Participant goes offline.  ``rejoin_after`` (round units) schedules an
    automatic ``Arrival``; ``None`` means a permanent dropout."""
    rejoin_after: float | None = None


@dataclass(frozen=True)
class ResourceDrift(Event):
    """§IV-A dynamic resources: multiplicative change to (s, r, a).  The
    engine mutates the participant and re-runs Procedure-2 placement, so the
    participant may migrate clusters."""
    s_mult: float = 1.0
    r_mult: float = 1.0
    a_mult: float = 1.0


@dataclass(frozen=True)
class StragglerSpike(Event):
    """Transient slowdown: compute time is multiplied by ``factor`` for
    ``duration`` rounds (thermal throttling, co-located load, ...)."""
    factor: float = 4.0
    duration: float = 1.0


@dataclass(frozen=True)
class SpikeEnd(Event):
    """Internal: clears the straggler spike identified by ``token`` (scheduled
    by the engine; a stale SpikeEnd must not clear a newer spike)."""
    token: int = 0


@dataclass(frozen=True)
class ClusterDone(Event):
    """Internal async-server event: cluster ``level``'s in-flight dispatch
    block completes and its delta is ready to merge.  Lives on the
    *completion* queue (timestamps in simulated seconds, not round units);
    ``pid`` is unused and pinned to -1."""
    level: int = 0


# name -> class registry for checkpoint (de)serialization of pending events
EVENT_TYPES = {cls.__name__: cls
               for cls in (Arrival, Departure, ResourceDrift,
                           StragglerSpike, SpikeEnd, ClusterDone)}


def event_priority(ev: Event) -> int:
    """Fixed per-type heap tie-break: at equal timestamps an ``Arrival``
    must be visible before any other event (a rejoin landing at the same
    instant as a drift/departure would otherwise be masked); every other
    type keeps FIFO order via the sequence number.  This makes merge order
    in the async server seed-stable across platforms rather than an
    artifact of insertion order."""
    return 0 if isinstance(ev, Arrival) else 1


def encode_event(ev: Event) -> list:
    """JSON-safe ``[type_name, fields]`` form of one event."""
    return [type(ev).__name__, asdict(ev)]


def decode_event(rec: list) -> Event:
    name, fields = rec
    try:
        cls = EVENT_TYPES[name]
    except KeyError:
        raise ValueError(f"unknown event type {name!r} in checkpoint") from None
    return cls(**fields)
