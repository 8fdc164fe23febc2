"""Deterministic discrete-event clocks.

Event timestamps are in *round units* for the participant-lifecycle queue
(the FL server only observes device state at dispatch boundaries, so an
event stamped t=3.4 becomes visible at the start of round 4) and in
simulated *seconds* for the async completion queue; the two domains never
share a queue.  Total order is the explicit heap key ``(time, priority,
seq)`` — ``priority`` is a fixed per-event-type tie-break
(:func:`repro_torch.sim.events.event_priority`: arrivals sort before everything
else at the same instant) and ``seq`` is a monotonically increasing
insertion counter, which makes replay under a fixed seed exactly
reproducible across platforms.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

from .events import decode_event, encode_event, event_priority


class EventQueue:
    """Min-heap of ``(time, priority, seq, event)`` with a deterministic
    total order: time, then event-class priority, then FIFO insertion."""

    def __init__(self):
        self._heap: list = []
        self._seq = 0

    def push(self, time: float, event, priority: int | None = None) -> None:
        if priority is None:
            priority = event_priority(event)
        heapq.heappush(self._heap, (float(time), int(priority), self._seq, event))
        self._seq += 1

    def next_time(self) -> float | None:
        """Peek the earliest pending event time (None when empty) — the
        dispatch-mode engine caps fused blocks so no event can land inside
        one."""
        return self._heap[0][0] if self._heap else None

    def pop(self):
        """Pop the single earliest ``(time, event)`` (None when empty)."""
        if not self._heap:
            return None
        t, _, _, ev = heapq.heappop(self._heap)
        return t, ev

    def pop_due(self, now: float) -> list:
        """Pop every (time, event) with time <= now, in heap-key order."""
        due = []
        while self._heap and self._heap[0][0] <= now:
            t, _, _, ev = heapq.heappop(self._heap)
            due.append((t, ev))
        return due

    def pop_due_where(self, now: float, pred) -> list:
        """Pop every (time, event) with time <= now AND ``pred(event)``,
        preserving heap-key order among the popped entries.  Non-matching
        due entries keep their original (priority, seq) key, so a later
        :meth:`pop_due` / :meth:`pop_due_where` sees them in the same total
        order — this is what lets async clusters consume only their own
        participants' events without perturbing everyone else's."""
        due, keep = [], []
        while self._heap and self._heap[0][0] <= now:
            entry = heapq.heappop(self._heap)
            if pred(entry[3]):
                due.append((entry[0], entry[3]))
            else:
                keep.append(entry)
        for entry in keep:
            heapq.heappush(self._heap, entry)
        return due

    def __len__(self) -> int:
        return len(self._heap)

    # ------------------------------------------------------------ checkpoint
    def state(self) -> tuple[list, int]:
        """Pending ``(time, priority, seq, event)`` entries in heap-key order
        plus the sequence counter — enough to rebuild the queue with
        identical tie-breaking after a resume."""
        return sorted(self._heap), self._seq

    def load_state(self, entries: list, seq: int) -> None:
        heap = []
        for entry in entries:
            if len(entry) == 3:         # pre-priority checkpoints: (t, s, ev)
                t, s, ev = entry
                heap.append((float(t), event_priority(ev), int(s), ev))
            else:
                t, p, s, ev = entry
                heap.append((float(t), int(p), int(s), ev))
        heapq.heapify(heap)
        self._heap = heap
        self._seq = int(seq)

    def encode(self) -> dict:
        """JSON-safe ``{"seq", "entries"}`` snapshot (events encoded)."""
        entries, seq = self.state()
        return {"seq": seq,
                "entries": [[t, p, s, encode_event(ev)]
                            for t, p, s, ev in entries]}

    def load_encoded(self, rec: dict) -> None:
        entries = []
        for entry in rec["entries"]:
            if len(entry) == 3:
                t, s, enc = entry
                entries.append((float(t), int(s), decode_event(enc)))
            else:
                t, p, s, enc = entry
                entries.append((float(t), int(p), int(s), decode_event(enc)))
        self.load_state(entries, rec["seq"])


@dataclass
class SimClock:
    """Accumulated simulated wall-clock seconds."""
    now: float = 0.0

    def advance(self, dt: float) -> None:
        self.now += float(dt)


@dataclass
class ClusterClock:
    """One cluster's independent clock in async mode: simulated seconds
    accumulated by *this* cluster's dispatch blocks plus its local round
    cursor (== the cluster's committed server version)."""
    now: float = 0.0
    round: int = 0

    def advance(self, dt: float, rounds: int = 0) -> None:
        self.now += float(dt)
        self.round += int(rounds)
