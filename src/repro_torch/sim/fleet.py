"""Vectorized fleet simulator: Fed-RAC orchestration at 10⁴–10⁶ devices.

``HeterogeneitySim`` exercises the full training path (per-cluster vmap
updates, KD, buffered aggregation) but walks Python objects per participant
— fine at paper scale (10–10³), hopeless at fleet scale.  ``FleetSim`` is
the orchestration-layer counterpart: the whole population lives in a
``Fleet`` struct-of-arrays, events come from ``FleetTrace`` columnar tables,
and every round is a handful of whole-fleet numpy ops — event application,
Eq. 2 pricing, FedCS selection, MAR policy, telemetry — with no O(n²) array
and no per-participant Python loop anywhere:

* setup runs the fleet-scale Procedure 1 (``fleet_optimal_clusters``:
  subsampled k-means + sampled Dunn) and orders clusters master-first;
* drift re-placement is the vectorized Procedure 2
  (``reassign_by_centroids`` — one argmin over the frozen centroids);
* client selection implements FedCS (arXiv:1804.08333) per cluster as a
  sort + prefix scan: admit in ascending round-time order while
  Θ = max(T_train) + Σ T_comm stays within the cluster MAR;
* all four MAR policies (drop / mask / wait / buffer) apply as boolean
  masks; ``buffer`` banks each round's violators and credits them to the
  next round's flush count (no model state at this scale — weights and
  step-masks are what the training path would consume).

Model updates themselves are NOT simulated here — this is the server's
scheduling/accounting view, the layer whose cost ceiling used to be Python.

Everything is host numpy float64, the JAX package's arithmetic, so both
packages give the same records on the same ``FleetTrace``.  The one torch
step is the Lloyd loop of the setup's k-means, which runs on ``device``
(the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.assignment import (build_cluster_specs,
                                         reassign_by_centroids)
from repro_torch.core.clustering import fleet_optimal_clusters
from repro_torch.core.resources import Fleet
from repro_torch.core.rounds import ConvergenceConstants
from repro_torch.core.server import resolve_device
from repro_torch.sim.faults import NULL_FAULTS
from repro_torch.sim.traces import FleetTrace

log = logging.getLogger("repro_torch.sim")

# FleetRoundRecord fields that are per-level arrays (serialized stacked as
# (rounds, m) in run-state checkpoints; round/duration/events go in meta)
_ROW_ARRAY_FIELDS = ("time", "active", "masked", "dropped", "offline",
                     "unselected", "violations", "banked", "flushed", "bytes")


@dataclass
class FleetSimConfig:
    rounds: int = 3
    mar_policy: str = "drop"          # drop | mask | wait | buffer
    select: str = "all"               # all | fedcs
    select_budget: int = 0            # fedcs: max clients/cluster (0 = ∞)
    schedule: str = "parallel"        # Eq. 9 | Eq. 10 round-duration combine
    steps_per_round: int = 20
    mar: float = 0.0                  # master budget; 0 → auto percentile
    mar_percentile: float = 40.0
    kappa: float = 0.7
    lam: tuple = (1 / 3, 1 / 3, 1 / 3)
    k_cap: int = 8
    seed: int = 0
    base_model_bytes: float = 4e5     # level-l model: base · 0.5^l
    base_flops: float = 2e6
    E: int = 5
    batch_size: int = 32
    min_speed: float = 0.05           # drift floors, as in SimConfig
    min_rate: float = 0.1
    min_mem: float = 0.25
    mode: str = "sync"                # sync (global barrier) | async
    #   async: clusters advance on independent cumulative clocks; a round's
    #   wall-clock charge is the increment of the SLOWEST cumulative clock,
    #   so total wall-clock = max_l Σ_r t[l,r] ≤ the barrier's Σ_r max_l —
    #   the no-global-straggler-bound accounting of the async server


@dataclass
class FleetRoundRecord:
    """Per-round per-level counts — the columnar analogue of a
    ``RoundRecord`` full of ``ClusterRoundStats`` (arrays of length m)."""
    round: int
    duration: float
    time: np.ndarray            # per-cluster round duration
    active: np.ndarray
    masked: np.ndarray
    dropped: np.ndarray
    offline: np.ndarray
    unselected: np.ndarray
    violations: np.ndarray
    banked: np.ndarray
    flushed: np.ndarray
    bytes: np.ndarray
    events: int                 # trace events applied this round


@dataclass
class FleetReport:
    scenario: str
    mar_policy: str
    select: str
    n: int
    k: int
    di_values: dict
    mar: list
    rows: list = field(default_factory=list)
    levels: np.ndarray | None = None     # final per-participant level

    def summary(self) -> dict:
        tot = lambda name: int(sum(int(getattr(r, name).sum())
                                   for r in self.rows))
        active = tot("active") + tot("masked")   # masked still contribute
        banked = tot("banked")
        slots = (active + banked + tot("dropped") + tot("offline")
                 + tot("unselected"))
        return {
            "scenario": self.scenario,
            "mar_policy": self.mar_policy,
            "select": self.select,
            "fleet_size": self.n,
            "k": self.k,
            "rounds": len(self.rows),
            "wall_clock_s": round(sum(r.duration for r in self.rows), 3),
            "total_bytes": float(sum(float(r.bytes.sum())
                                     for r in self.rows)),
            "participation_rate": round((active + banked) / slots, 4)
                                  if slots else 0.0,
            "mar_violations": tot("violations"),
            "dropped_total": tot("dropped"),
            "unselected_total": tot("unselected"),
            "banked_total": banked,
            "flushed_total": tot("flushed"),
            "cluster_sizes": (np.bincount(self.levels, minlength=self.k)
                              .tolist() if self.levels is not None else []),
        }


def _sorted_table(tab: dict) -> dict:
    order = np.argsort(tab["time"], kind="stable")
    return {k: v[order] for k, v in tab.items()}


class FleetSim:
    """Couples a ``Fleet`` with a ``FleetTrace`` and runs vectorized rounds.

    ``checkpoint``/``faults`` mirror ``HeterogeneitySim``: a
    ``RunCheckpointer`` snapshots the whole-fleet arrays (V, online, spike,
    levels, dropout/rejoin state, trace cursors, per-round records) at round
    boundaries and resumes bit-identically; a ``FaultInjector`` SIGKILLs at
    boundaries for the kill-and-resume harness.  ``device`` is where the
    setup's Lloyd loop runs: ``cuda`` when None, and without a card that
    raises."""

    KIND = "fleet-sim"

    def __init__(self, fleet: Fleet, trace: FleetTrace, cfg: FleetSimConfig,
                 checkpoint=None, faults=None, device=None):
        if cfg.mar_policy not in ("drop", "mask", "wait", "buffer"):
            raise ValueError(f"unknown mar_policy {cfg.mar_policy!r}")
        if cfg.select not in ("all", "fedcs"):
            raise ValueError(f"unknown select {cfg.select!r}")
        if cfg.schedule not in ("parallel", "sequential"):
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        if cfg.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.mode == "async" and cfg.schedule == "sequential":
            raise ValueError('mode "async" requires schedule "parallel"')
        self.fleet, self.trace, self.cfg = fleet, trace, cfg
        n = len(fleet)

        # ---- Procedure 1 (fleet path) + master-first cluster ordering
        self.clustering = fleet_optimal_clusters(
            fleet.V, cfg.lam, seed=cfg.seed, k_cap=cfg.k_cap,
            device=resolve_device(device))
        self.m = max(self.clustering.k, 1)
        lab = self.clustering.labels
        lam_a = np.asarray(cfg.lam, np.float64)
        Vb = (fleet.V - self.clustering.lo) / self.clustering.span
        score = np.full(self.m, -np.inf)
        wsum = (Vb * lam_a).sum(axis=1)
        cnt = np.bincount(lab, minlength=self.m)
        tot = np.bincount(lab, weights=wsum, minlength=self.m)
        score[cnt > 0] = tot[cnt > 0] / cnt[cnt > 0]
        self.level_of_cluster = np.empty(self.m, np.int64)
        self.level_of_cluster[np.argsort(-score)] = np.arange(self.m)
        self.levels = self.level_of_cluster[lab]

        # ---- per-level specs (geometric model family) with auto-MAR:
        # the paper's §V default — the 40th percentile of the master
        # cluster's round times, scaled per level by κ (§IV-C)
        sizes = [(cfg.base_model_bytes * 0.5 ** l, cfg.base_flops * 0.5 ** l)
                 for l in range(self.m)]
        self.specs = build_cluster_specs(
            sizes, ConvergenceConstants(), E=cfg.E, mar=1.0,
            kappa=cfg.kappa, batch_size=cfg.batch_size)
        self.model_bytes = np.array([s.model_bytes for s in self.specs])
        self.flops = np.array([s.flops_per_sample for s in self.specs])
        if cfg.mar > 0.0:
            master_mar = cfg.mar
        else:
            mem0 = self.levels == 0
            t0 = (cost_model.train_time_vec(
                      fleet.V[mem0, 0], self.flops[0], cfg.E,
                      fleet.n_data[mem0])
                  + cost_model.comm_time_vec(fleet.V[mem0, 1],
                                             self.model_bytes[0]))
            master_mar = (float(np.percentile(t0, cfg.mar_percentile))
                          if mem0.any() else 1.0)
        # build_cluster_specs takes the LAST level's budget and applies
        # T_{f-1} = κ T_f upward; master_mar / κ^{m-1} pins level 0
        self.specs = build_cluster_specs(
            sizes, ConvergenceConstants(), E=cfg.E,
            mar=master_mar / cfg.kappa ** (self.m - 1),
            kappa=cfg.kappa, batch_size=cfg.batch_size)
        self.mar = np.array([s.mar for s in self.specs])

        # ---- dynamic state (whole-fleet arrays; V/online/spike live on
        # the Fleet so row views stay coherent)
        off = np.zeros(n, bool)
        if trace.initially_offline:
            off[np.fromiter(trace.initially_offline, np.int64)] = True
        fleet.online[:] = ~off
        self.gone = np.zeros(n, bool)
        self.rejoin_round = np.full(n, np.inf)
        self.spike_end = np.full(n, -np.inf)
        self._banked_prev = np.zeros(self.m, np.int64)
        # async mode: per-cluster cumulative clocks (simulated seconds)
        self.cluster_time = np.zeros(self.m)

        self._tabs = {"dropouts": _sorted_table(trace.dropouts),
                      "drifts": _sorted_table(trace.drifts),
                      "spikes": _sorted_table(trace.spikes),
                      "arrivals": _sorted_table(trace.arrivals)}
        self._cur = {k: 0 for k in self._tabs}
        self.checkpoint = checkpoint
        self.faults = faults if faults is not None else NULL_FAULTS
        self.report: FleetReport | None = None
        self._pending_state = None

    # ------------------------------------------------------------ events
    def _due(self, name: str, r: int) -> dict:
        tab, lo = self._tabs[name], self._cur[name]
        hi = int(np.searchsorted(tab["time"], float(r), side="right"))
        self._cur[name] = max(hi, lo)
        return {k: v[lo:hi] for k, v in tab.items()} if hi > lo else None

    def _apply_events(self, r: int) -> int:
        fleet, cfg = self.fleet, self.cfg
        applied = 0
        # spike expiry first, then this round's events overwrite
        expired = (fleet.spike != 1.0) & (self.spike_end <= r)
        fleet.spike[expired] = 1.0
        # arrivals before departures at equal timestamps (same netting rule
        # as the event-queue engine): trace arrivals re-register, scheduled
        # rejoins only fire for non-permanent departures
        tab = self._due("arrivals", r)
        if tab is not None:
            pid = tab["pid"]
            self.gone[pid] = False
            fleet.online[pid] = True
            self.rejoin_round[pid] = np.inf
            applied += len(pid)
        rj = (self.rejoin_round <= r) & ~self.gone
        if rj.any():
            fleet.online |= rj
            self.rejoin_round[rj] = np.inf
        tab = self._due("dropouts", r)
        if tab is not None:
            live = ~self.gone[tab["pid"]]      # noise for permanently-gone
            pid, rejoin = tab["pid"][live], tab["rejoin"][live]
            fleet.online[pid] = False
            perm = np.isnan(rejoin)
            self.gone[pid[perm]] = True
            self.rejoin_round[pid[perm]] = np.inf
            self.rejoin_round[pid[~perm]] = r + rejoin[~perm]
            applied += len(pid)
        tab = self._due("spikes", r)
        if tab is not None:
            pid = tab["pid"]
            fleet.spike[pid] = tab["factor"]
            self.spike_end[pid] = r + tab["duration"]
            applied += len(pid)
        tab = self._due("drifts", r)
        if tab is not None:
            pid = tab["pid"]
            V = fleet.V
            V[pid, 0] = np.maximum(V[pid, 0] * tab["s_mult"], cfg.min_speed)
            V[pid, 1] = np.maximum(V[pid, 1] * tab["r_mult"], cfg.min_rate)
            V[pid, 2] = np.maximum(V[pid, 2] * tab["a_mult"], cfg.min_mem)
            # vectorized Procedure 2: drifted rows re-place in one argmin
            self.levels[pid] = reassign_by_centroids(
                V[pid], self.clustering, self.level_of_cluster)
            applied += len(pid)
        return applied

    # ------------------------------------------------------------ rounds
    def _price(self):
        fleet, lv = self.fleet, self.levels
        t_train = cost_model.train_time_vec(
            fleet.V[:, 0], self.flops[lv], self.cfg.E, fleet.n_data,
            compute_slowdown=fleet.spike)
        t_comm = cost_model.comm_time_vec(fleet.V[:, 1],
                                          self.model_bytes[lv])
        return t_train, t_comm

    def _fedcs_unselected(self, t_train, t_comm, online) -> np.ndarray:
        """Per-cluster FedCS admission (sort + prefix Θ scan); True where an
        online member is NOT admitted this round."""
        cfg = self.cfg
        out = np.zeros(len(self.levels), bool)
        t = t_train + t_comm
        for lvl in range(self.m):
            mem = np.flatnonzero((self.levels == lvl) & online)
            if len(mem) == 0:
                continue
            order = mem[np.lexsort((mem, t[mem]))]
            theta = (np.maximum.accumulate(t_train[order])
                     + np.cumsum(t_comm[order]))
            take = int(np.searchsorted(theta, self.specs[lvl].mar,
                                       side="right"))
            if cfg.select_budget:
                take = min(take, cfg.select_budget)
            out[order[take:]] = True
        return out

    def _round(self, r: int, applied: int) -> FleetRoundRecord:
        cfg, m = self.cfg, self.m
        S = cfg.steps_per_round
        lv = self.levels
        t_train, t_comm = self._price()
        t = t_train + t_comm
        mar = self.mar[lv]
        online = self.fleet.online
        offline = ~online

        unselected = np.zeros(len(lv), bool)
        if cfg.select == "fedcs":
            unselected = self._fedcs_unselected(t_train, t_comm, online)
        sel = online & ~unselected
        viol = sel & (t > mar)

        dropped = np.zeros(len(lv), bool)
        banked = np.zeros(len(lv), bool)
        is_masked = np.zeros(len(lv), bool)
        contrib_t = np.where(sel, t, 0.0)
        weights = np.where(sel, self.fleet.n_data, 0).astype(np.float64)
        if cfg.mar_policy == "drop":
            dropped = viol
        elif cfg.mar_policy == "buffer":
            banked = viol
            contrib_t[viol] = 0.0     # late upload is off the critical path
            weights[viol] = 0.0
        elif cfg.mar_policy == "mask":
            with np.errstate(divide="ignore", invalid="ignore"):
                granted = np.floor(S * (mar - t_comm)
                                   / np.where(t_train > 0, t_train, np.inf))
            granted = np.clip(np.nan_to_num(granted, nan=0.0,
                                            neginf=0.0), 0, S)
            is_masked = viol & (granted > 0)
            dropped = viol & (granted == 0)
            frac = granted / S
            weights[is_masked] = (self.fleet.n_data[is_masked]
                                  * frac[is_masked])
            contrib_t[is_masked] = (t_train[is_masked] * frac[is_masked]
                                    + t_comm[is_masked])
        # wait: violators contribute in full, the round runs straggler-bound
        contrib_t[dropped] = 0.0
        weights[dropped] = 0.0

        active = sel & (weights > 0) & ~is_masked
        ct = np.zeros(m)
        contributing = contrib_t > 0
        np.maximum.at(ct, lv[contributing], contrib_t[contributing])
        if cfg.mode == "async":
            # independent cluster clocks: each cluster accumulates its OWN
            # round time; the round's wall-clock charge is the increment of
            # the slowest cumulative clock, so Σ durations telescopes to
            # max_l Σ_r t[l,r] — no global straggler bound
            prev = float(self.cluster_time.max(initial=0.0))
            self.cluster_time += ct
            duration = float(self.cluster_time.max(initial=0.0)) - prev
        else:
            duration = (float(ct.max(initial=0.0))
                        if cfg.schedule == "parallel" else float(ct.sum()))

        cnt = lambda mask: np.bincount(lv[mask], minlength=m)
        n_active, n_masked = cnt(active), cnt(is_masked)
        n_dropped, n_banked = cnt(dropped), cnt(banked)
        if cfg.mode == "async":
            # conservation re-derived per merge event: every participant in
            # exactly one bucket of its cluster's merge
            buckets = (n_active + n_masked + n_dropped + n_banked
                       + cnt(offline) + cnt(unselected & online)
                       + cnt(sel & (weights <= 0) & ~is_masked & ~dropped
                             & ~banked))
            n_lv = np.bincount(lv, minlength=m)
            if not np.array_equal(buckets, n_lv):
                raise RuntimeError(
                    f"conservation violated at round {r}: per-level buckets "
                    f"{buckets.tolist()} != membership {n_lv.tolist()}")
        rec = FleetRoundRecord(
            round=r, duration=duration, time=ct,
            active=n_active, masked=n_masked, dropped=n_dropped,
            offline=cnt(offline), unselected=cnt(unselected & online),
            violations=cnt(viol), banked=n_banked,
            flushed=self._banked_prev,
            bytes=self.model_bytes * (
                2.0 * (n_active + n_masked + n_banked) + 1.0 * n_dropped),
            events=applied)
        self._banked_prev = n_banked
        return rec

    def run(self) -> FleetReport:
        report = FleetReport(
            scenario=self.trace.name, mar_policy=self.cfg.mar_policy,
            select=self.cfg.select, n=len(self.fleet), k=self.m,
            di_values=self.clustering.di_values,
            mar=[round(float(v), 4) for v in self.mar])
        self.report = report
        r0 = self._maybe_resume(report)
        for r in range(r0, self.cfg.rounds):
            applied = self._apply_events(r)
            report.rows.append(self._round(r, applied))
            self._round_boundary(r + 1, report)
        # terminal flush: updates banked in the last round still merge
        if self._banked_prev.any() and report.rows:
            report.rows[-1].flushed = (report.rows[-1].flushed
                                       + self._banked_prev)
            self._banked_prev = np.zeros(self.m, np.int64)
        report.levels = self.levels
        return report

    # ------------------------------------------------------------ checkpoint
    def _round_boundary(self, r: int, report: FleetReport) -> None:
        if self.checkpoint is not None:
            meta, arrays = self._capture_state(r, report.rows)
            self._pending_state = (r, meta, arrays)
            if self.checkpoint.due(r):
                self.checkpoint.save(r, self.KIND, meta, arrays)
        self.faults.round_boundary(r)

    def save_now(self):
        """Write the newest retained boundary snapshot (graceful shutdown);
        returns the step written, or None."""
        if self.checkpoint is None or self._pending_state is None:
            return None
        r, meta, arrays = self._pending_state
        self.checkpoint.save(r, self.KIND, meta, arrays)
        return r

    def _capture_state(self, r: int, rows: list) -> tuple[dict, dict]:
        fleet = self.fleet
        meta = {
            "round": int(r),
            "seed": int(self.cfg.seed),
            "rows": [{"round": int(x.round), "duration": float(x.duration),
                      "events": int(x.events)} for x in rows],
        }
        arrays = {
            "fleet/V": fleet.V.copy(),
            "fleet/n_data": fleet.n_data.copy(),
            "fleet/online": fleet.online.copy(),
            "fleet/spike": fleet.spike.copy(),
            "levels": self.levels.copy(),
            "gone": self.gone.copy(),
            "rejoin_round": self.rejoin_round.copy(),
            "spike_end": self.spike_end.copy(),
            "banked_prev": self._banked_prev.copy(),
            "cluster_time": self.cluster_time.copy(),
            "cur": np.array([self._cur[k] for k in sorted(self._tabs)],
                            np.int64),
        }
        for f in _ROW_ARRAY_FIELDS:
            arrays[f"rows/{f}"] = (
                np.stack([np.asarray(getattr(x, f)) for x in rows])
                if rows else np.zeros((0, self.m)))
        return meta, arrays

    def _maybe_resume(self, report: FleetReport) -> int:
        ck = self.checkpoint
        if ck is None or not ck.resume:
            return 0
        got = ck.load_latest(self.KIND)
        if got is None:
            log.warning("resume requested but no valid checkpoint under "
                        "%s; starting from round 0", ck.manager.dir)
            return 0
        _, meta, arrays = got
        return self._load_state(meta, arrays, report)

    def _load_state(self, meta: dict, arrays: dict,
                    report: FleetReport) -> int:
        fleet = self.fleet
        fleet.V[:] = arrays["fleet/V"]
        fleet.n_data[:] = arrays["fleet/n_data"]
        fleet.online[:] = arrays["fleet/online"].astype(bool)
        fleet.spike[:] = arrays["fleet/spike"]
        self.levels[:] = arrays["levels"]
        self.gone[:] = arrays["gone"].astype(bool)
        self.rejoin_round[:] = arrays["rejoin_round"]
        self.spike_end[:] = arrays["spike_end"]
        self._banked_prev = arrays["banked_prev"].astype(np.int64).copy()
        if "cluster_time" in arrays:     # absent in pre-async checkpoints
            self.cluster_time[:] = arrays["cluster_time"]
        for k, v in zip(sorted(self._tabs), arrays["cur"]):
            self._cur[k] = int(v)
        report.rows = [
            FleetRoundRecord(
                round=int(rm["round"]), duration=float(rm["duration"]),
                events=int(rm["events"]),
                **{f: arrays[f"rows/{f}"][i].copy()
                   for f in _ROW_ARRAY_FIELDS})
            for i, rm in enumerate(meta["rows"])]
        r0 = int(meta["round"])
        log.info("resumed fleet run at round %d from %s", r0,
                 self.checkpoint.manager.dir)
        return r0
