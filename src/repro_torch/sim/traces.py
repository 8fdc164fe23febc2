"""Seeded device-profile and event-trace generation — vectorized.

Profiles resample the paper's Table III (processing GHz, Mbps, GB) with
multiplicative jitter so any participant count keeps the paper's marginal
resource distribution.  Event traces are pre-scheduled at trace-build time
from a single ``numpy`` generator — two traces built with the same arguments
are identical, which the determinism tests pin down.

Generation is batched: every maker draws one block of variates and decodes
it into a columnar event table (``FleetTrace``), never looping per
(round, pid).  The decoded stream is BIT-IDENTICAL to the original scalar
loops (kept as ``legacy_*_events`` references, pinned by
``tests/test_torch_sim_host.py``): ``numpy.random.Generator`` fills batched
draws element-sequentially, so a batch of K uniforms equals K scalar calls,
and the interleaved conditional pattern ``u = rng.random(); if u < rate:
v = rng.random()`` is replayed from one batch by run-parity decoding —
a position is a gate draw iff the run of sub-``rate`` values immediately
before it has even length (gates and their extra value draws alternate
inside such a run).

One stream changed shape to make this possible: resource-drift normals.
Scalar Gaussians consume a variable number of generator words (ziggurat
rejection), so an interleaved uniform/normal stream cannot be decoded
positionally; ``drift_events`` now draws its gate uniforms first and then
the fired slots' normals (three per slot, slot order) — still one seeded
generator, still loop-replayable (``legacy_drift_events``).

Event timestamps are in round units (see ``sim.clock``).
"""
from __future__ import annotations

import inspect
import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.resources import TABLE_III
from repro_torch.sim.events import (Arrival, Departure, Event, ResourceDrift,
                              StragglerSpike)


@dataclass
class Trace:
    name: str
    events: list = field(default_factory=list)       # [(time, Event)]
    initially_offline: frozenset = frozenset()       # pids joining late


def sample_profiles(n: int, seed: int = 0, jitter: float = 0.15) -> np.ndarray:
    """(n, 3) resource matrix resampled from Table III with ±jitter."""
    rng = np.random.default_rng(seed)
    rows = TABLE_III[rng.integers(0, len(TABLE_III), n)]
    return rows * rng.uniform(1.0 - jitter, 1.0 + jitter, rows.shape)


# ------------------------------------------------------------ columnar form
def _table(**cols) -> dict:
    return {k: np.asarray(v) for k, v in cols.items()}


def _empty(*names) -> dict:
    return {k: np.empty(0, np.int64 if k == "pid" else np.float64)
            for k in names}


@dataclass
class FleetTrace:
    """Columnar event tables for a whole trace — the fleet-scale form.

    Each table is a dict of equal-length 1-D arrays sorted by slot order
    (time ascending, pid ascending within a round; arrivals keep their
    draw order, which fixes FIFO tie-breaking).  ``to_trace()`` materializes
    the legacy ``Trace`` object list in the exact order the scalar makers
    used to append (dropouts, then drifts, then spikes, then arrivals) —
    the bridge for the event-queue engine and the equivalence tests.
    Vectorized engines (the fleet simulator, not ported yet) consume the
    tables directly
    and never materialize per-event objects.
    """
    name: str
    n: int
    rounds: int
    dropouts: dict = field(default_factory=lambda: _empty(
        "time", "pid", "rejoin"))                  # rejoin: nan = permanent
    drifts: dict = field(default_factory=lambda: _empty(
        "time", "pid", "s_mult", "r_mult", "a_mult"))
    spikes: dict = field(default_factory=lambda: _empty(
        "time", "pid", "factor", "duration"))
    arrivals: dict = field(default_factory=lambda: _empty("time", "pid"))
    initially_offline: frozenset = frozenset()

    @property
    def n_events(self) -> int:
        return sum(len(t["time"]) for t in
                   (self.dropouts, self.drifts, self.spikes, self.arrivals))

    def to_trace(self) -> Trace:
        ev = []
        d = self.dropouts
        for t, pid, rj in zip(d["time"], d["pid"], d["rejoin"]):
            ev.append((float(t), Departure(
                int(pid), rejoin_after=None if math.isnan(rj) else float(rj))))
        d = self.drifts
        for t, pid, sm, rm, am in zip(d["time"], d["pid"], d["s_mult"],
                                      d["r_mult"], d["a_mult"]):
            ev.append((float(t), ResourceDrift(int(pid), s_mult=float(sm),
                                               r_mult=float(rm),
                                               a_mult=float(am))))
        d = self.spikes
        for t, pid, f, dur in zip(d["time"], d["pid"], d["factor"],
                                  d["duration"]):
            ev.append((float(t), StragglerSpike(int(pid), factor=float(f),
                                                duration=float(dur))))
        d = self.arrivals
        for t, pid in zip(d["time"], d["pid"]):
            ev.append((float(t), Arrival(int(pid))))
        return Trace(self.name, ev,
                     initially_offline=self.initially_offline)


# ------------------------------------------------------------ batched draws
def _decode_gated(seed: int, n_slots: int, rate: float):
    """Replay ``for slot: u = rng.random(); if u < rate: v = rng.random()``
    from one batched draw.

    Run-parity decode: a position is a gate iff the run of consecutive
    sub-``rate`` values immediately before it has EVEN length — a gate that
    fires is followed by exactly one value position, and only a firing gate
    produces one, so gates/values alternate inside every such run.  Returns
    (fired slot ordinals ascending, their value draws).  Over-draws a
    generous block and doubles it in the rare case the decode comes up
    short; re-creating the generator keeps the stream prefix identical.
    """
    if n_slots == 0 or rate <= 0.0:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    K = int(n_slots * (1.0 + rate)
            + 10.0 * math.sqrt(max(n_slots * rate, 1.0)) + 64)
    while True:
        U = np.random.default_rng(seed).random(K)
        H = np.flatnonzero(U < rate)         # sub-rate ("hit") positions
        if len(H) == 0:                      # K ≥ n_slots gates, none fired
            return np.empty(0, np.int64), np.empty(0, np.float64)
        # Sparse run-parity: work on the ~rate·K hits, not all K positions.
        # Within each maximal hit-run, even offsets are fired gates, odd
        # offsets their values; the position right AFTER an odd-length run
        # (a miss, or one past the draw) is the trailing gate's value too.
        brk = np.empty(len(H), bool)         # True at each run's first hit
        brk[0] = True
        np.greater(np.diff(H), 1, out=brk[1:])
        rid = np.cumsum(brk) - 1                     # run id per hit
        start = np.flatnonzero(brk)                  # run starts (in H index)
        off = H - H[start][rid]                      # offset within run
        ev = (off & 1) == 0                          # even offset = fired gate
        H_ev = H[ev]
        L = np.diff(start, append=len(H))            # run lengths
        odd_run = (L & 1).astype(bool)               # odd run → trailing value
        n_E = int(odd_run.sum()) - (odd_run[-1] and H[-1] == K - 1)
        n_odd = len(H) - len(H_ev)                   # odd-offset hits = values
        if K - n_odd - n_E >= n_slots:       # enough gates decoded
            # gate ordinal = position − (# value positions before it):
            # ceil(L/2) values per earlier run + off/2 inside this run
            vals = (L + 1) >> 1
            prev = np.cumsum(vals) - vals
            ordv = H_ev - prev[rid[ev]] - (off[ev] >> 1)
            sel = ordv < n_slots
            val_pos = H_ev[sel] + 1
            if len(val_pos) == 0 or val_pos[-1] < K:
                return ordv[sel], U[val_pos]
        K *= 2


def _slot_time_pid(slots: np.ndarray, n: int):
    return ((slots // n).astype(np.float64), (slots % n).astype(np.int64))


def dropout_table(n: int, rounds: int, rate: float, seed: int = 0,
                  rejoin_after: float = 2.0,
                  permanent_frac: float = 0.1) -> dict:
    """Columnar per-participant per-round Bernoulli(rate) dropouts; most
    rejoin after ``rejoin_after`` rounds (``rejoin`` column; nan = the
    ``permanent_frac`` share that never come back)."""
    fired, v = _decode_gated(seed, n * rounds, rate)
    time, pid = _slot_time_pid(fired, n)
    return _table(time=time, pid=pid,
                  rejoin=np.where(v < permanent_frac, np.nan,
                                  float(rejoin_after)))


def drift_table(n: int, rounds: int, rate: float, seed: int = 0,
                scale: float = 0.35) -> dict:
    """Columnar multiplicative log-normal random-walk steps on (s, r);
    memory drifts an order of magnitude slower (apps release RAM rarely).
    Gate uniforms are drawn first, then the fired slots' standard normals
    (3 per slot, slot order) — see the module docstring."""
    rng = np.random.default_rng(seed)
    u = rng.random(n * rounds)
    fired = np.flatnonzero(u < rate).astype(np.int64)
    g = rng.standard_normal((len(fired), 3))
    time, pid = _slot_time_pid(fired, n)
    return _table(time=time, pid=pid,
                  s_mult=np.exp(g[:, 0] * scale),
                  r_mult=np.exp(g[:, 1] * scale),
                  a_mult=np.exp(g[:, 2] * (scale * 0.1)))


def straggler_table(n: int, rounds: int, rate: float, seed: int = 0,
                    factor_range=(2.0, 8.0), duration: float = 1.0) -> dict:
    fired, v = _decode_gated(seed, n * rounds, rate)
    time, pid = _slot_time_pid(fired, n)
    lo, hi = factor_range
    return _table(time=time, pid=pid, factor=lo + (hi - lo) * v,
                  duration=np.full(len(fired), float(duration)))


def arrival_table(n: int, rounds: int, frac: float, seed: int = 0) -> tuple:
    """A ``frac`` share of participants join uniformly over the first half
    of the horizon.  Returns (initially_offline frozenset, table); the table
    keeps permutation order (insertion order fixes FIFO tie-breaks)."""
    rng = np.random.default_rng(seed)
    late = rng.permutation(n)[: int(round(n * frac))]
    times = rng.integers(1, max(2, rounds // 2 + 1),
                         size=len(late)).astype(np.float64)
    return (frozenset(int(p) for p in late),
            _table(time=times, pid=late.astype(np.int64)))


# ------------------------------------------------------------ event makers
# List-of-events API on top of the columnar builders: identical streams
# (pinned against the legacy_* scalar loops below), but the O(n·rounds)
# draw/decode is batched — only realized events materialize objects.
def dropout_events(n: int, rounds: int, rate: float, seed: int = 0,
                   rejoin_after: float = 2.0,
                   permanent_frac: float = 0.1) -> list:
    return FleetTrace("dropout", n, rounds, dropouts=dropout_table(
        n, rounds, rate, seed, rejoin_after, permanent_frac)).to_trace().events


def drift_events(n: int, rounds: int, rate: float, seed: int = 0,
                 scale: float = 0.35) -> list:
    return FleetTrace("drift", n, rounds, drifts=drift_table(
        n, rounds, rate, seed, scale)).to_trace().events


def straggler_events(n: int, rounds: int, rate: float, seed: int = 0,
                     factor_range=(2.0, 8.0), duration: float = 1.0) -> list:
    return FleetTrace("straggler", n, rounds, spikes=straggler_table(
        n, rounds, rate, seed, factor_range, duration)).to_trace().events


def late_arrivals(n: int, rounds: int, frac: float, seed: int = 0) -> tuple:
    off, tab = arrival_table(n, rounds, frac, seed)
    return off, FleetTrace("flash-crowd", n, rounds,
                           arrivals=tab).to_trace().events


# ------------------------------------------------------ legacy references
# The original per-(round, pid) scalar loops.  They define the event stream
# the vectorized makers must reproduce bit-identically (equivalence tests).
def legacy_dropout_events(n: int, rounds: int, rate: float, seed: int = 0,
                          rejoin_after: float = 2.0,
                          permanent_frac: float = 0.1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        for pid in range(n):
            if rng.random() < rate:
                perm = rng.random() < permanent_frac
                out.append((float(r), Departure(
                    pid, rejoin_after=None if perm else rejoin_after)))
    return out


def legacy_drift_events(n: int, rounds: int, rate: float, seed: int = 0,
                        scale: float = 0.35) -> list:
    rng = np.random.default_rng(seed)
    fired = [(r, pid) for r in range(rounds) for pid in range(n)
             if rng.random() < rate]
    out = []
    for r, pid in fired:
        out.append((float(r), ResourceDrift(
            pid,
            s_mult=float(np.exp(rng.normal(0.0, scale))),
            r_mult=float(np.exp(rng.normal(0.0, scale))),
            a_mult=float(np.exp(rng.normal(0.0, scale * 0.1))))))
    return out


def legacy_straggler_events(n: int, rounds: int, rate: float, seed: int = 0,
                            factor_range=(2.0, 8.0),
                            duration: float = 1.0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        for pid in range(n):
            if rng.random() < rate:
                out.append((float(r), StragglerSpike(
                    pid, factor=float(rng.uniform(*factor_range)),
                    duration=duration)))
    return out


def legacy_late_arrivals(n: int, rounds: int, frac: float,
                         seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed)
    late = rng.permutation(n)[: int(round(n * frac))]
    evs = [(float(rng.integers(1, max(2, rounds // 2 + 1))), Arrival(int(pid)))
           for pid in late]
    return frozenset(int(p) for p in late), evs


# ------------------------------------------------------------ scenarios
def _stable(n, rounds, seed):
    return FleetTrace("stable", n, rounds)


def _dropout(n, rounds, seed, *, dropout_rate=0.15, rejoin_after=2.0):
    return FleetTrace("dropout", n, rounds, dropouts=dropout_table(
        n, rounds, dropout_rate, seed, rejoin_after=rejoin_after))


def _drift(n, rounds, seed, *, drift_rate=0.1, drift_scale=0.35):
    return FleetTrace("drift", n, rounds, drifts=drift_table(
        n, rounds, drift_rate, seed, scale=drift_scale))


def _straggler(n, rounds, seed, *, spike_rate=0.15, spike_duration=1.0):
    return FleetTrace("straggler", n, rounds, spikes=straggler_table(
        n, rounds, spike_rate, seed, duration=spike_duration))


def _flash_crowd(n, rounds, seed, *, late_frac=0.4):
    off, tab = arrival_table(n, rounds, late_frac, seed)
    return FleetTrace("flash-crowd", n, rounds, arrivals=tab,
                      initially_offline=off)


def _mixed(n, rounds, seed, *, dropout_rate=0.08, drift_rate=0.05,
           spike_rate=0.08):
    return FleetTrace(
        "mixed", n, rounds,
        dropouts=dropout_table(n, rounds, dropout_rate, seed),
        drifts=drift_table(n, rounds, drift_rate, seed + 1),
        spikes=straggler_table(n, rounds, spike_rate, seed + 2))


SCENARIOS = {
    "stable": _stable,
    "dropout": _dropout,
    "drift": _drift,
    "straggler": _straggler,
    "flash-crowd": _flash_crowd,
    "mixed": _mixed,
}


def scenario_knobs(scenario: str) -> frozenset:
    """The keyword knobs a scenario accepts (its keyword-only parameters)."""
    sig = inspect.signature(SCENARIOS[scenario])
    return frozenset(p.name for p in sig.parameters.values()
                     if p.kind is inspect.Parameter.KEYWORD_ONLY)


def _check_knobs(scenario: str, knobs: dict) -> None:
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {sorted(SCENARIOS)}")
    unknown = set(knobs) - scenario_knobs(scenario)
    if unknown:
        raise TypeError(
            f"scenario {scenario!r} does not accept "
            f"{sorted(unknown)}; valid knobs: "
            f"{sorted(scenario_knobs(scenario)) or 'none'}")


def make_fleet_trace(scenario: str, n: int, rounds: int, seed: int = 0,
                     **knobs) -> FleetTrace:
    """Columnar trace for the vectorized engines.  Unknown knobs raise
    (a typo'd ``--dropout-rate`` must not silently no-op)."""
    _check_knobs(scenario, knobs)
    return SCENARIOS[scenario](n, rounds, seed, **knobs)


def make_trace(scenario: str, n: int, rounds: int, seed: int = 0,
               **knobs) -> Trace:
    return make_fleet_trace(scenario, n, rounds, seed, **knobs).to_trace()
