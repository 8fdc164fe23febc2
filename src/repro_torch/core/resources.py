"""Participant resource vectors, unit normalization, λ-weighted similarity (§IV-A).

Includes the paper's exact data: Table I (10-participant example) and
Table III (the 40 real participants used in §V-F1) — these anchor the
reproduction tests.

Fleet-scale state is struct-of-arrays: ``Fleet`` holds the whole
population as columnar numpy arrays (pids, an (n, 3) resource matrix,
online/spike/n_data vectors), and ``Participant`` doubles as a thin row
view (``Fleet.participant``) so every object-per-participant call site —
Procedure-2 placement, the cost model, the sim engine — keeps working
while mutations write through to the arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass
class Participant:
    pid: int
    s: float        # processing speed (GHz-equivalents)
    r: float        # transmission rate (Mbps)
    a: float        # available memory (GB)
    n_data: int = 0

    @property
    def vector(self):
        return np.array([self.s, self.r, self.a], dtype=np.float64)


class _FleetRow(Participant):
    """Row view over one ``Fleet`` slot: attribute reads/writes go straight
    to the fleet's arrays, so a view and its fleet can never disagree."""
    __slots__ = ("_fleet", "_i")

    def __init__(self, fleet: "Fleet", i: int):
        object.__setattr__(self, "_fleet", fleet)
        object.__setattr__(self, "_i", int(i))

    @property
    def pid(self) -> int:
        return int(self._fleet.pids[self._i])

    @property
    def s(self) -> float:
        return float(self._fleet.V[self._i, 0])

    @s.setter
    def s(self, v):
        self._fleet.V[self._i, 0] = v

    @property
    def r(self) -> float:
        return float(self._fleet.V[self._i, 1])

    @r.setter
    def r(self, v):
        self._fleet.V[self._i, 1] = v

    @property
    def a(self) -> float:
        return float(self._fleet.V[self._i, 2])

    @a.setter
    def a(self, v):
        self._fleet.V[self._i, 2] = v

    @property
    def n_data(self) -> int:
        return int(self._fleet.n_data[self._i])

    @n_data.setter
    def n_data(self, v):
        self._fleet.n_data[self._i] = v

    def detach(self) -> Participant:
        """A standalone (plain dataclass) copy of this row."""
        return Participant(self.pid, self.s, self.r, self.a, self.n_data)

    def __repr__(self):
        return (f"_FleetRow(pid={self.pid}, s={self.s}, r={self.r}, "
                f"a={self.a}, n_data={self.n_data})")


@dataclass
class Fleet:
    """Struct-of-arrays participant state — the canonical representation at
    fleet scale (10⁴–10⁶ devices).  All arrays share length n; ``V`` columns
    are (s, r, a) in the Table-III units.  ``online``/``spike`` are the
    simulator-facing dynamic state (vectorized engines mutate them with
    whole-array ops; ``HeterogeneitySim`` mutates rows through views)."""
    pids: np.ndarray                 # (n,)  int64
    V: np.ndarray                    # (n,3) float64 — s, r, a columns
    n_data: np.ndarray               # (n,)  int64
    online: np.ndarray = None        # (n,)  bool
    spike: np.ndarray = None         # (n,)  float64 compute-slowdown factor
    _rows: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        n = len(self.pids)
        self.pids = np.ascontiguousarray(self.pids, np.int64)
        self.V = np.ascontiguousarray(self.V, np.float64)
        self.n_data = np.ascontiguousarray(self.n_data, np.int64)
        if self.online is None:
            self.online = np.ones(n, bool)
        if self.spike is None:
            self.spike = np.ones(n, np.float64)
        assert self.V.shape == (n, 3)

    @classmethod
    def from_matrix(cls, V: np.ndarray, n_data=None) -> "Fleet":
        n = len(V)
        nd = (np.full(n, 100, np.int64) if n_data is None
              else np.asarray(n_data, np.int64))
        return cls(pids=np.arange(n, dtype=np.int64),
                   V=np.asarray(V, np.float64), n_data=nd)

    @classmethod
    def from_participants(cls, parts: Sequence[Participant]) -> "Fleet":
        return cls(pids=np.array([p.pid for p in parts], np.int64),
                   V=np.stack([p.vector for p in parts]),
                   n_data=np.array([p.n_data for p in parts], np.int64))

    def __len__(self) -> int:
        return len(self.pids)

    def participant(self, i: int) -> Participant:
        """Row view for slot ``i`` (cached: one view object per slot)."""
        if i not in self._rows:
            self._rows[i] = _FleetRow(self, i)
        return self._rows[i]

    def participants(self) -> list:
        """All row views, slot order — a drop-in ``parts`` list."""
        return [self.participant(i) for i in range(len(self))]


def resource_matrix(parts) -> np.ndarray:
    if isinstance(parts, Fleet):
        return parts.V
    return np.stack([p.vector for p in parts])


def unit_normalize(V: np.ndarray) -> np.ndarray:
    """Per-column min-max to [0,1]; constant columns map to 0 (paper §IV-A)."""
    lo, hi = V.min(axis=0), V.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    return (V - lo) / span


def similarity_matrix(Vbar: np.ndarray, lam=(1 / 3, 1 / 3, 1 / 3)) -> np.ndarray:
    """S_ij = sqrt(Σ_d λ_d (v_id - v_jd)^2) — λ-weighted Euclidean distance.

    Accumulates per dimension (squared-norm expansion over columns) instead
    of broadcasting an (n, n, 3) diff temp: peak extra memory is two (n, n)
    scratch arrays (~3× lower than the einsum form this replaces).  For the
    3-axis resource vectors the partial sums follow einsum's 2-way-unrolled
    pairwise order — (λ₀d₀² + λ₂d₂²) + λ₁d₁² — so the result is
    bit-identical to the previous implementation on the paper tables."""
    lam = np.asarray(lam, dtype=np.float64)
    assert abs(lam.sum() - 1.0) < 1e-9, "λ must sum to 1 (paper constraint)"

    def sq(d):
        diff = Vbar[:, d, None] - Vbar[None, :, d]
        np.multiply(diff, diff, out=diff)
        diff *= lam[d]
        return diff
    if Vbar.shape[1] == 3:
        acc = sq(0)
        acc += sq(2)
        acc += sq(1)
    else:
        acc = sq(0)
        for d in range(1, Vbar.shape[1]):
            acc += sq(d)
    return np.sqrt(acc, out=acc)


# ----------------------------------------------------------------- paper data
# Table I — 10-participant illustration (Example 2; optimal k = 3).
TABLE_I = np.array([
    [100, 10, 20], [50, 15, 30], [75, 8, 25], [125, 10, 15], [150, 7, 10],
    [110, 10, 25], [125, 15, 20], [80, 10, 10], [75, 15, 20], [50, 10, 30],
], dtype=np.float64)

# Table III — 40 participants [processing GHz, transmission Mbps, memory GB].
TABLE_III = np.array([
    [1.6, 10.88, 8], [2.8, 4.1, 3], [1.1, 1.13, 6], [1.6, 11.45, 3],
    [3.2, 8.9, 3], [2.2, 2, 4], [3.1, 8.7, 1], [1.8, 60, 3],
    [2.7, 8.89, 3], [1.4, 34.5, 8], [1.6, 12.54, 6], [0.8, 1.2, 6],
    [1.3, 28.41, 6], [1.3, 21.9, 3], [3.1, 25.99, 6], [3.2, 19.43, 4],
    [1.0, 20.98, 3], [1.6, 30, 3], [1.0, 12, 2], [2.7, 10, 6],
    [1.6, 40, 1], [1.1, 11.4, 6], [2.5, 25, 6], [2.2, 30, 4],
    [1.6, 9.62, 6], [2.2, 23.27, 6], [1.5, 49.79, 6], [1.7, 37.65, 6],
    [3.1, 15.71, 6], [2.6, 3, 6], [3.1, 18.04, 6], [2.5, 44.13, 6],
    [2.3, 6.5, 6], [2.1, 60.21, 6], [2.1, 61.3, 8], [3.2, 19, 6],
    [2.7, 32.05, 6], [2.9, 6.52, 6], [0.8, 38.8, 6], [2.1, 32, 6],
], dtype=np.float64)

LAMBDA_EQUAL = (1 / 3, 1 / 3, 1 / 3)
LAMBDA_PAPER = (0.4, 0.4, 0.2)      # FastDeepIoT-derived weighting [33]


def participants_from_matrix(V: np.ndarray, n_data=None) -> list[Participant]:
    n_data = n_data if n_data is not None else [100] * len(V)
    return [Participant(i, *V[i], n_data=int(n_data[i])) for i in range(len(V))]
