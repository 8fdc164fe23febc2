"""Seeded batch-index draws for the dispatch path.

Each member's draws for one round come from a CPU ``torch.Generator`` seeded
from (seed, absolute round, global member slot) alone, never from block
boundaries or the dispatch width R, so any two widths give the same
batches.  The draws are small integer arrays; the engine makes a block's
draws on the host, moves them to the device in one copy and gathers the
batches there.  Drawing on the host also makes the CUDA and CPU runs of the
engine see the same batches.

The stream is not the JAX package's threefry stream: the two are
statistically equivalent and distinct.  Parity tests inject the JAX draws
through ``FedRAC._draw_indices``.

``balanced_indices`` realizes §IV-C class-balanced resampling as a fixed-
shape draw: batch slots go round-robin over each member's present classes,
then each slot draws uniformly within its class.

``stream_fingerprint`` is a CRC32 of a probe draw of this stream, which a
run-state checkpoint records and a resume checks.  Since the stream is not
JAX's, neither is the fingerprint: a checkpoint the JAX package wrote does
not resume a port engine (it fails the check with ``CheckpointError``, as a
checkpoint of another seed does).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def member_seed(seed: int, r: int, slot: int) -> int:
    """63-bit generator seed for one (seed, absolute round, member slot)."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(r) & _MASK64))
    h = _splitmix64(h ^ (int(slot) & _MASK64))
    return h >> 1


def stream_fingerprint(seed: int, r: int, probe: int = 4) -> int:
    """CRC32 of a canonical probe draw for round ``r`` under ``seed``.

    Every draw is a pure function of (seed, absolute round, global member
    slot), so this fingerprint, written into a run-state checkpoint and
    recomputed at resume, proves that the resumed process generates the
    stream the checkpoint was trained under: a changed seed or sampler
    fails loudly instead of silently diverging."""
    idx = uniform_indices(seed, r, 2, probe, np.full(probe, 1 << 20))
    return zlib.crc32(idx.astype(np.int32).tobytes()) & 0xFFFFFFFF


def _uniform(seed: int, r: int, slot: int, shape) -> np.ndarray:
    g = torch.Generator().manual_seed(member_seed(seed, r, slot))
    return torch.rand(shape, generator=g, dtype=torch.float64).numpy()


def uniform_indices(seed: int, r: int, steps: int, batch: int, n,
                    offset: int = 0) -> np.ndarray:
    """(C, steps, batch) int64 draws, member i uniform over [0, n[i])."""
    n = np.maximum(np.asarray(n, np.int64), 1)
    out = np.empty((len(n), steps, batch), np.int64)
    for i, ni in enumerate(n):
        u = _uniform(seed, r, offset + i, (steps, batch))
        out[i] = np.minimum(np.floor(u * ni), ni - 1)
    return out


def balanced_indices(seed: int, r: int, steps: int, batch: int, tables,
                     counts, offset: int = 0) -> np.ndarray:
    """Class-balanced (C, steps, batch) int64 draws from per-member class
    tables: ``tables`` (C, classes, m), ``counts`` (C, classes).  Slots go
    round-robin over each member's present classes in ascending class
    order, then draw uniformly over the class's first min(count, m)
    samples."""
    tables = np.asarray(tables)
    counts = np.asarray(counts, np.int64)
    C, classes = counts.shape
    present = counts > 0
    n_present = np.maximum(present.sum(-1), 1)
    order = np.argsort(np.where(present, 0, 1) * classes
                       + np.arange(classes)[None, :], axis=-1, kind="stable")
    slot_cls = np.arange(batch)[None, :] % n_present[:, None]
    cls = np.take_along_axis(order, slot_cls, axis=1)               # (C, B)
    cnt = np.minimum(np.maximum(np.take_along_axis(counts, cls, axis=1), 1),
                     tables.shape[-1])
    out = np.empty((C, steps, batch), np.int64)
    for i in range(C):
        u = _uniform(seed, r, offset + i, (steps, batch))
        inst = np.minimum(np.floor(u * cnt[i]), cnt[i] - 1).astype(np.int64)
        out[i] = tables[i, cls[i][None, :], inst]
    return out


def build_class_table(y: np.ndarray, classes: int, m: int | None = None):
    """Host-side (classes, m) index table + (classes,) counts for one shard.

    Rows shorter than m repeat the class's indices (the padding is never
    drawn: draws are bounded by counts).  m may be smaller than
    ``counts.max()``: each class row then holds its first m indices and the
    draw is clamped to m.  counts are returned unclamped."""
    y = np.asarray(y)
    cols = [np.where(y == c)[0].astype(np.int32) for c in range(classes)]
    counts = np.array([len(c) for c in cols], np.int32)
    m = int(m if m is not None else max(1, counts.max(initial=1)))
    if m < 1:
        raise ValueError(f"class table width must be >= 1, got {m}")
    table = np.zeros((classes, m), np.int32)
    for c, col in enumerate(cols):
        if len(col):
            reps = -(-m // len(col))
            table[c] = np.tile(col, reps)[:m]
    return table, counts
