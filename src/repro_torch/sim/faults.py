"""Fault-injection hooks of the simulation engine.

The engine calls two hooks at the places a real server dies: every round
boundary (``round_boundary(r)``, ``r`` rounds completed) and inside a fused
dispatch block after its programs ran but before its rounds are recorded
(``mid_block(r0, r1)``).  This module holds only ``NULL_FAULTS``, the hook
that never fires.  The injector that kills the process there
(``FaultInjector``, ``FaultPlan``) and ``corrupt_checkpoint`` come with the
checkpoint and resume layer, ROADMAP item 8, whose kill-and-resume tests
they serve.
"""
from __future__ import annotations


class NullFaults:
    """Fault hooks that never fire."""
    __slots__ = ()

    def round_boundary(self, r: int) -> None:
        pass

    def mid_block(self, r0: int, r1: int) -> None:
        pass


NULL_FAULTS = NullFaults()
