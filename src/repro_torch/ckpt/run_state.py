"""Versioned run-state envelope over ``repro_torch.ckpt.manifest``.

A run-state checkpoint is one ``CheckpointManager`` step whose meta carries
a ``{"run_state": {"version", "kind"}}`` header.  The engine
(``HeterogeneitySim``) owns *what* goes in the snapshot — planes, bank,
sampler position, event queue, participant resources, metrics tables —
this module owns the envelope: version/kind validation, the save cadence,
and the newest-valid-or-nothing resume read.

``RunCheckpointer`` is the object a launcher hands to an engine::

    ckpt = make_checkpointer("runs/ckpt", every=2, keep=3, resume=True)
    HeterogeneitySim(eng, trace, cfg, checkpoint=ckpt).run(test)

The engine captures a snapshot at every round boundary — every *merge
event* in ``mode="async"``, where per-cluster clocks replace the global
round barrier and the snapshot additionally carries the per-cluster clock
states, server version counters and the in-flight delta ledger under
``meta["async"]`` (same envelope version: the section is additive) —
(cheap host copies; also the graceful-shutdown payload), writes it when
``due()``, and on
``resume`` loads the newest checkpoint that passes CRC + decode + header
validation — a corrupt or truncated newest checkpoint degrades to the
previous valid one with a logged warning, and no valid checkpoint at all
degrades to a from-scratch run, never a crash.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.ckpt.manifest import CheckpointManager

log = logging.getLogger("repro_torch.ckpt")

RUN_STATE_VERSION = 1


def header(kind: str) -> dict:
    return {"version": RUN_STATE_VERSION, "kind": kind}


def check_header(meta: dict, kind: str) -> None:
    """Raise ``CheckpointError`` unless ``meta`` carries a compatible
    run-state header for ``kind``."""
    hdr = meta.get("run_state")
    if not isinstance(hdr, dict):
        raise CheckpointError("checkpoint has no run_state header")
    if hdr.get("version") != RUN_STATE_VERSION:
        raise CheckpointError(
            f"run-state version {hdr.get('version')!r} != "
            f"{RUN_STATE_VERSION} (incompatible checkpoint)")
    if hdr.get("kind") != kind:
        raise CheckpointError(
            f"run-state kind {hdr.get('kind')!r} != {kind!r} "
            "(checkpoint from a different engine)")


@dataclass
class RunCheckpointer:
    """Save cadence + resume switch around a ``CheckpointManager``."""
    manager: CheckpointManager
    every: int = 1
    resume: bool = False
    # False: read checkpoints, never write them (every rank of a mesh run
    # but rank 0, which writes for all)
    writer: bool = True

    def due(self, r: int) -> bool:
        """Write a checkpoint at boundary ``r``?  (r counts completed
        rounds — merge events in async mode — so the first eligible
        boundary is r == every.)"""
        return r > 0 and self.every > 0 and r % self.every == 0

    def save(self, r: int, kind: str, meta: dict, arrays: dict):
        """Write step ``r``; returns its path (None for a reader)."""
        if not self.writer:
            return None
        meta = dict(meta)
        meta["run_state"] = header(kind)
        return self.manager.save(r, meta, arrays)

    def load_latest(self, kind: str):
        """Newest (step, meta, arrays) whose header matches ``kind``, or
        ``None`` (degrade-to-fresh-run) when no checkpoint validates.
        Corrupt/foreign checkpoints are skipped with a warning."""
        for step in reversed(self.manager.steps()):
            try:
                meta, arrays = self.manager.load_step(step)
                check_header(meta, kind)
                return step, meta, arrays
            except CheckpointError as e:
                log.warning("skipping checkpoint step %d: %s", step, e)
        return None


def make_checkpointer(ckpt_dir: str, *, every: int = 1, keep: int = 3,
                      resume: bool = False,
                      writer: bool = True) -> RunCheckpointer:
    return RunCheckpointer(CheckpointManager(ckpt_dir, keep=keep),
                           every=every, resume=resume, writer=writer)
