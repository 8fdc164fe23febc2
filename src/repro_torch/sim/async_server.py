"""Continuous-time asynchronous parameter server.

One ``AsyncPlaneServer`` per cluster level owns that cluster's shared
parameter state — the flat ``(capacity, D)``-derived ``(D_pad,)`` aggregated
plane on the dispatch path, the params pytree on the one-round path — plus the two
counters that define async semantics:

* ``version`` — the number of committed communication rounds.  A dispatch
  block *pulls* ``(state, version)``, trains ``L`` fused rounds against that
  snapshot, and *commits* its result at its own completion time, advancing
  the version by ``L``.  Staleness is measured in server versions: a ledger
  entry tagged with the version it was banked at weighs
  ``n · discount**(V_merge − V_banked)``
  (:func:`repro_torch.core.aggregation.version_staleness_weights`) when it
  merges at version ``V_merge``.  With versions advancing one per round this is
  numerically identical to the buffered path's round-age discount — the
  synchronized-arrival anchor that makes ``mode="async"`` with
  ``max_staleness=0`` reproduce the buffered engine bit-for-bit.
* ``merges`` — the merge-event counter.  Async mode has no global round
  barrier, so checkpoint cadence, fault-injection points and the
  conservation invariant all re-anchor on merge events instead of rounds.

The ledger IS the buffered engine's bank (the engine hands the same list
object to the server): entries ``{"pid", "round" (== version tag), "n_eff",
"plane"|"params"}`` are violators whose late update is in flight between
their dispatch and the cluster's next merge — the bank stops being a
round-boundary holding pen and becomes the server's in-flight delta ledger.

``MasterBlock`` records the master cluster's most recent dispatch (eagerly
computed, possibly not yet committed): block start round, length, the
pre-block state and the per-round post-round plane history.  A slave block
whose rounds align with it gets the exact per-round KD teacher stack the
synchronous schedule would have used; a misaligned slave (clusters drifted
apart under unbounded staleness) falls back to the master's latest
*committed* state broadcast across its rounds — a stale teacher, the KD
analogue of a stale gradient.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MasterBlock:
    """The master cluster's most recent dispatch block (KD teacher source)."""
    r0: int                 # first round of the block
    length: int             # rounds in the block
    start: object           # pre-block plane / params (parallel cadence)
    hist: object = None     # (L, D0) per-round post planes (dispatch mode)


class AsyncPlaneServer:
    """Per-cluster shared-state owner for ``mode="async"``."""

    def __init__(self, level: int, state, ledger: list | None = None):
        self.level = level
        self.state = state
        self.version = 0         # committed rounds
        self.merges = 0          # merge events committed
        # in-flight delta ledger — aliases the engine's bank for this level
        self.ledger = ledger if ledger is not None else []

    # ------------------------------------------------------------ protocol
    def pull(self):
        """Snapshot for a new dispatch block: (state, version)."""
        return self.state, self.version

    def commit(self, state, n_rounds: int) -> None:
        """Merge event: install the block's resulting state, advance the
        version by the block length."""
        self.state = state
        self.version += int(n_rounds)
        self.merges += 1

    # ------------------------------------------------------------ ledger
    def ripe(self) -> list:
        """Ledger entries banked strictly before the current version —
        eligible to merge into the next dispatch at a discounted weight."""
        return [b for b in self.ledger if b["round"] < self.version]

    def drop_ripe(self) -> None:
        """Remove ripe entries in place (they merged); keeps the engine's
        aliased bank list consistent."""
        self.ledger[:] = [b for b in self.ledger if b["round"] >= self.version]

    def lag_of(self, entry: dict) -> int:
        """Version lag of one ledger entry at the current version."""
        return int(self.version) - int(entry["round"])
