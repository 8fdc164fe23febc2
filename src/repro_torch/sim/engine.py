"""Deadline-aware round engine: drives a ``FedRAC`` instance round-by-round
under an event trace, enforcing each cluster's MAR time budget.

Per round the engine (1) fires all due events — dropouts, arrivals, resource
drift through the Procedure-2 ``update_resources`` path (participants migrate
clusters in place), straggler spikes; (2) prices every member's round via the
cost model (Eq. 2, with transient slowdowns); (3) applies the MAR policy:

* ``drop``  — members with T_i > MAR are excluded this round (zero step-mask
  row, zero aggregation weight; partial aggregation renormalizes the rest);
* ``mask``  — they train only the ⌊S·(MAR − T_c)/T_a⌋ local steps whose
  (slowdown-adjusted) train time still fits the deadline after the fixed
  communication cost, down-weighted by the granted fraction (comm time
  alone blowing the budget degrades to a download-only drop);
* ``wait``  — nobody is cut; the round runs straggler-bound (Eq. 2), the
  violation is only recorded;
* ``buffer`` — violators train their full τ steps but miss the synchronous
  aggregate; their update is banked and joins the NEXT round's FedAvg at a
  staleness-discounted weight (``FLConfig(aggregation="buffered")``) — the
  round stays bounded by the on-time members, and the straggler's work is
  not thrown away.

Masks and weights feed ``FedRAC.cluster_round`` (``rounds_per_dispatch ==
1``) or ``FedRAC.dispatch_rounds`` (fused blocks of up to R rounds between
events, the bank riding the block), so the simulator runs the engine's own
training paths.  Everything on the host — events, prices, MAR decisions,
bytes, the clock — is numpy float64 arithmetic in the JAX package's order,
so the telemetry equals the JAX engine's on the same trace.

``mode="async"`` replaces the global round barrier with the continuous-time
async server (``sim.async_server``): per-cluster clocks, blocks that pull a
server version and commit at their own completion time, staleness in
server versions.  Run-state checkpoints (``repro_torch.ckpt``) make a run
crash-safe: a resumed run is bit-identical to an uninterrupted one.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.core import aggregation, cost_model
from repro_torch.core.server import FedRAC
from repro_torch.core.tree import tree_map
from repro_torch.data import device_sampler
from repro_torch.obs import NULL_OBS
from repro_torch.sim.async_server import AsyncPlaneServer, MasterBlock
from repro_torch.sim.clock import ClusterClock, EventQueue, SimClock
from repro_torch.sim.events import (Arrival, ClusterDone, Departure,
                                    ResourceDrift, SpikeEnd, StragglerSpike)
from repro_torch.sim.faults import NULL_FAULTS
from repro_torch.sim.report import (ClusterRoundStats, RoundRecord, SimReport,
                                    decode_rows, decode_stats, encode_rows,
                                    encode_stats)
from repro_torch.sim.traces import Trace

log = logging.getLogger("repro_torch.sim")


def _host(x) -> np.ndarray:
    """A host copy of a device plane as fp32 numpy.  Always a copy: on the
    CPU ``.numpy()`` would alias the tensor, and a dispatch block writes
    its result into its input plane (donation) after the snapshot."""
    return x.detach().to("cpu", torch.float32, copy=True).numpy()


@dataclass
class SimConfig:
    rounds: int = 10
    mar_policy: str = "drop"          # drop | mask | wait | buffer
    schedule: str = "parallel"        # Eq. 9 parallel | Eq. 10 sequential
    eval_every: int = 0               # 0 → evaluate only after the last round
    min_speed: float = 0.05           # drift clamps (GHz / Mbps / GB floors)
    min_rate: float = 0.1
    min_mem: float = 0.25
    select: str = "all"               # all | fedcs (per-cluster selection)
    select_budget: int = 0            # fedcs: max clients/cluster (0 = ∞)
    mode: str = "sync"                # sync | async (continuous-time server)
    max_staleness: int | None = None  # async: max committed-round lead over
    #                                   the slowest cluster; 0 = barrier
    #                                   (reproduces the sync buffered path),
    #                                   None = unbounded


class HeterogeneitySim:
    """Couples a set-up ``FedRAC`` with a ``Trace`` and runs the event loop.

    ``obs`` (an ``Observability`` bundle) is shared with the engine when the
    engine has none.  ``checkpoint`` (a ``repro_torch.ckpt.run_state.
    RunCheckpointer``) arms crash-safe resumable runs: a versioned run-state
    snapshot — planes, buffered bank, sampler position, participant
    resources, assignment, event queue, clock, report rows, metrics tables —
    is captured at every round boundary (every merge event in async mode),
    written at the configured cadence, and (with ``resume=True``) restored
    from the newest valid checkpoint so a killed run continues
    bit-identically.  ``faults`` (a ``repro_torch.sim.faults.FaultInjector``)
    kills the process at the boundary and mid-dispatch-block hook points."""

    KIND = "hetero-sim"

    def __init__(self, fedrac: FedRAC, trace: Trace, cfg: SimConfig,
                 obs=None, checkpoint=None, faults=None):
        if cfg.mar_policy not in ("drop", "mask", "wait", "buffer"):
            raise ValueError(f"unknown mar_policy {cfg.mar_policy!r}")
        if cfg.schedule not in ("parallel", "sequential"):
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        if cfg.select not in ("all", "fedcs"):
            raise ValueError(f"unknown select {cfg.select!r}")
        if cfg.mar_policy == "buffer" and fedrac.cfg.aggregation != "buffered":
            raise ValueError(
                'mar_policy "buffer" needs FLConfig(aggregation="buffered")')
        if cfg.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.mode == "async" and cfg.schedule == "sequential":
            # Eq. 10 serializes master → slaves inside every round, a global
            # order that contradicts independent cluster clocks
            raise ValueError('mode "async" requires schedule "parallel"')
        self.fl = fedrac
        self.trace = trace
        self.cfg = cfg
        self.obs = obs if obs is not None else NULL_OBS
        if obs is not None and getattr(fedrac, "obs", NULL_OBS) is NULL_OBS:
            fedrac.obs = obs     # share one registry/tracer across the stack
        self.clock = SimClock()
        self.queue = EventQueue()
        for t, ev in trace.events:
            self.queue.push(t, ev)
        self.online = {p.pid for p in fedrac.parts} - set(trace.initially_offline)
        self._spikes: dict[int, tuple[float, int]] = {}  # pid -> (factor, token)
        self._spike_seq = 0
        self._rejoin_token: dict[int, int] = {}          # pid -> departure gen
        self._gone: set[int] = set()                     # permanent dropouts
        # buffered aggregation: level -> [{pid, params|plane, n_eff, round}]
        self._bank: dict[int, list] = {lvl: [] for lvl in range(fedrac.m)}
        self.checkpoint = checkpoint
        self.faults = faults if faults is not None else NULL_FAULTS
        self.report: SimReport | None = None
        self._pending_state = None   # newest boundary snapshot (shutdown)

    # ------------------------------------------------------------ events
    def _apply_events(self, r: int) -> list[str]:
        """Fire every due event (sync engine; async barrier sweeps).
        Arrivals first at equal timestamps: a scheduled rejoin and a fresh
        trace Departure landing on the same round net to "rejoined, then
        dropped again" (the queue's (time, priority, seq) key encodes this
        order)."""
        return self._apply_event_list(self.queue.pop_due(float(r)))

    def _apply_events_for(self, lvl: int, r: int) -> list[str]:
        """Async per-cluster event visibility: fire only the due events whose
        participant currently belongs to cluster ``lvl`` (each cluster
        observes device state at ITS dispatch boundaries; a migration lands
        at the owning cluster's dispatch and becomes visible to the target
        cluster at its own next dispatch).  Other entries keep their heap
        position, so the global total order is preserved."""
        owner = {pid: l for l, ms in self.fl.assignment.members.items()
                 for pid in ms}
        due = self.queue.pop_due_where(
            float(r), lambda ev: owner.get(ev.pid) == lvl)
        return self._apply_event_list(due)

    def _apply_event_list(self, due: list) -> list[str]:
        applied = []
        for t, ev in due:
            if isinstance(ev, Departure):
                # applies even while transiently offline: a fresh Departure
                # supersedes any pending rejoin (bumping the token below
                # invalidates it); later trace noise for a permanently
                # departed pid is ignored — only an explicit trace Arrival
                # re-registers the device
                if ev.pid in self._gone:
                    continue
                if ev.rejoin_after is None:
                    self._gone.add(ev.pid)
                self.online.discard(ev.pid)
                tok = self._rejoin_token.get(ev.pid, 0) + 1
                self._rejoin_token[ev.pid] = tok
                if ev.rejoin_after is not None:
                    self.queue.push(t + ev.rejoin_after,
                                    Arrival(ev.pid, token=tok))
                applied.append(
                    f"drop(p{ev.pid}"
                    + ("" if ev.rejoin_after is not None else ", perm")
                    + ")")
            elif isinstance(ev, Arrival):
                stale = (ev.token is not None
                         and ev.token != self._rejoin_token.get(ev.pid, 0))
                if not stale and ev.pid not in self.online:
                    self._gone.discard(ev.pid)   # trace arrival re-registers
                    self.online.add(ev.pid)
                    applied.append(f"join(p{ev.pid})")
            elif isinstance(ev, StragglerSpike):
                self._spike_seq += 1
                self._spikes[ev.pid] = (ev.factor, self._spike_seq)
                self.queue.push(t + ev.duration,
                                SpikeEnd(ev.pid, token=self._spike_seq))
                applied.append(f"spike(p{ev.pid} ×{ev.factor:.1f})")
            elif isinstance(ev, SpikeEnd):
                if self._spikes.get(ev.pid, (0.0, -1))[1] == ev.token:
                    del self._spikes[ev.pid]
            elif isinstance(ev, ResourceDrift):
                p = self.fl.parts[ev.pid]
                old, new = self.fl.update_resources(
                    ev.pid,
                    s=max(self.cfg.min_speed, p.s * ev.s_mult),
                    r=max(self.cfg.min_rate, p.r * ev.r_mult),
                    a=max(self.cfg.min_mem, p.a * ev.a_mult))
                tag = (f"C{old + 1}→C{new + 1}" if old != new
                       else f"C{new + 1}")
                applied.append(f"drift(p{ev.pid} {tag})")
            else:
                raise TypeError(f"unhandled event {ev!r}")
        return applied

    # ------------------------------------------------------------ pricing
    def _price_round(self, level: int, members: list[int]):
        """Per-member Eq. 2 round time under current slowdowns."""
        spec = self.fl.specs[level]
        times = {}
        for pid in members:
            p = self.fl.parts[pid]
            times[pid] = cost_model.round_time(
                p, spec.flops_per_sample, spec.model_bytes, spec.E,
                n_i=self.fl.assignment.n_eff.get(pid, p.n_data),
                compute_slowdown=self._spikes.get(pid, (1.0, 0))[0])
        return spec, times

    def _fedcs_select(self, spec, members: list[int], times: dict) -> set:
        """FedCS-style deadline-aware client selection (Nishio & Yonetani,
        arXiv:1804.08333), adapted to the Eq. 2 cost model: training runs in
        parallel across the selected set while uploads are sequential, so
        the estimated cluster round time is Θ(S) = max_i T_train + Σ_i
        T_comm.  Admission is the longest prefix in ascending round-time
        order with Θ ≤ MAR, capped at ``select_budget``; every admitted
        member satisfies T_i ≤ Θ ≤ MAR."""
        cand = [pid for pid in members if pid in self.online]
        if not cand:
            return set()
        t_comm = np.array([cost_model.comm_time(self.fl.parts[pid],
                                                spec.model_bytes)
                           for pid in cand])
        t_total = np.array([times[pid] for pid in cand])
        order = np.lexsort((np.asarray(cand), t_total))
        theta = (np.maximum.accumulate((t_total - t_comm)[order])
                 + np.cumsum(t_comm[order]))
        take = int(np.searchsorted(theta, spec.mar, side="right"))
        if self.cfg.select_budget:
            take = min(take, self.cfg.select_budget)
        return {cand[i] for i in order[:take]}

    def _mar_decisions(self, level: int, members: list[int]):
        """Returns (stats, step_masks, weights, cluster_time)."""
        cfg, fl = self.cfg, self.fl
        S = fl.cfg.steps_per_round
        spec, times = self._price_round(level, members)
        stats = ClusterRoundStats(level=level, time=0.0)
        masks = np.zeros((len(members), S), np.float32)
        weights = np.zeros(len(members), np.float32)
        selected = (self._fedcs_select(spec, members, times)
                    if cfg.select == "fedcs" else None)
        contrib_times = []
        for i, pid in enumerate(members):
            if pid not in self.online:
                stats.offline.append(pid)
                continue
            if selected is not None and pid not in selected:
                # not admitted: selection precedes distribution, so no bytes
                # move and no MAR policy applies
                stats.unselected.append(pid)
                continue
            n_eff = fl.assignment.n_eff.get(pid, 1)
            t = times[pid]
            if t > spec.mar:
                stats.violations.append(pid)
                if cfg.mar_policy == "drop":
                    stats.dropped.append(pid)
                    stats.bytes += cost_model.round_bytes(
                        spec.model_bytes, upload=False)
                    continue
                if cfg.mar_policy == "buffer":
                    # full local work, zero sync weight: the update is banked
                    # after the round and joins the next aggregate
                    # discounted; its late upload does not bound the round
                    masks[i] = 1.0
                    stats.banked.append(pid)
                    stats.bytes += cost_model.round_bytes(spec.model_bytes)
                    continue
                if cfg.mar_policy == "mask":
                    # only the train part scales with steps; comm is fixed,
                    # so grant ⌊S·(MAR − T_c)/T_a⌋ steps (0 if comm alone
                    # blows the deadline → download-only drop)
                    t_comm = cost_model.comm_time(fl.parts[pid],
                                                  spec.model_bytes)
                    t_train = t - t_comm
                    granted = (int(S * (spec.mar - t_comm) / t_train)
                               if spec.mar > t_comm and t_train > 0 else 0)
                    if granted == 0:
                        stats.dropped.append(pid)
                        stats.bytes += cost_model.round_bytes(
                            spec.model_bytes, upload=False)
                        continue
                    masks[i, :granted] = 1.0
                    weights[i] = n_eff * granted / S
                    stats.masked[pid] = granted
                    stats.active.append(pid)
                    stats.bytes += cost_model.round_bytes(spec.model_bytes)
                    contrib_times.append(t_train * granted / S + t_comm)
                    continue
                # wait: tolerated, falls through to a full contribution
            masks[i] = 1.0
            weights[i] = n_eff
            stats.active.append(pid)
            stats.bytes += cost_model.round_bytes(spec.model_bytes)
            contrib_times.append(t)
        stats.time = max(contrib_times, default=0.0)
        return stats, masks, weights, stats.time

    # ------------------------------------------------------------ round loop
    def run(self, test) -> SimReport:
        fl = self.fl
        test = fl._to_device(test)
        if self.cfg.mode == "async":
            return self._run_async(test)
        if fl.cfg.rounds_per_dispatch > 1:
            return self._run_dispatch(test)
        cfg, tr = self.cfg, self.obs.tracer
        report = SimReport(scenario=self.trace.name,
                           mar_policy=cfg.mar_policy, schedule=cfg.schedule,
                           obs=self.obs if self.obs.on else None)
        self.report = report
        with tr.span("sim.run", cat="engine", mode="legacy",
                     rounds=cfg.rounds):
            with tr.span("init_params", cat="engine"):
                resumed = self._maybe_resume(report, plane_mode=False)
                if resumed is None:
                    r0 = 0
                    params = {lvl: fl.init_params(lvl)
                              for lvl in range(fl.m)}
                else:
                    r0, params = resumed
                tr.fence(params)
            for r in range(r0, cfg.rounds):
                with tr.span("round", cat="engine", round=r):
                    self._legacy_round(r, params, report, test)
                self._round_boundary(r + 1, params, report, plane_mode=False)
            with tr.span("terminal_flush", cat="engine"):
                self._terminal_flush(params, cfg.rounds, report)
            with tr.span("final_eval", cat="engine"):
                for lvl in range(fl.m):
                    if not fl.assignment.members.get(lvl):
                        continue
                    last = (report.rows[-1].clusters[lvl].acc
                            if report.rows else None)
                    report.final_acc[lvl] = (
                        last if last is not None
                        else fl.evaluate(lvl, params[lvl], test))
        self.params = params
        return report

    def _legacy_round(self, r: int, params: dict, report: SimReport,
                      test) -> None:
        """One communication round on the one-round path: MAR decisions,
        per-cluster vmapped update, bank bookkeeping, record append."""
        fl, cfg, tr = self.fl, self.cfg, self.obs.tracer
        ev_log = self._apply_events(r)
        master_before = params[0]
        clusters, times = [], []
        for lvl in range(fl.m):
            members = list(fl.assignment.members.get(lvl, []))
            if not members:
                clusters.append(ClusterRoundStats(level=lvl, time=0.0))
                times.append(0.0)
                continue
            stats, masks, weights, t_cluster = self._mar_decisions(
                lvl, members)
            ripe = [b for b in self._bank[lvl] if b["round"] < r]
            live = float(weights.sum()) > 0.0
            if live or stats.banked or ripe:
                teacher = None
                if lvl > 0:
                    teacher = (master_before if cfg.schedule == "parallel"
                               else params[0])
                buffered = None
                if ripe:
                    self._bank[lvl] = [b for b in self._bank[lvl]
                                       if b["round"] >= r]
                    stats.flushed = len(ripe)
                    if live:
                        us = aggregation.staleness_weights(
                            [b["n_eff"] for b in ripe],
                            [r - b["round"] for b in ripe],
                            fl.cfg.staleness_discount)
                        buffered = [(b["params"], u)
                                    for b, u in zip(ripe, us)]
                    else:
                        # no live contributor to anchor the convex
                        # combination inside cluster_round: anchor the
                        # current aggregate at the cluster's live weight,
                        # as the terminal flush does
                        params[lvl] = self._anchored_merge(
                            params[lvl], ripe, r, lvl)
                if live or stats.banked:
                    # buffered mode always asks for the stack, so one
                    # program serves rounds with and without violators
                    want_stack = fl.cfg.aggregation == "buffered"
                    with tr.span("cluster_round", cat="engine",
                                 level=lvl, round=r):
                        out = fl.cluster_round(
                            lvl, members, params[lvl], r, teacher=teacher,
                            step_masks=masks, weights=weights,
                            buffered=buffered, return_stack=want_stack)
                        tr.fence(out[0])
                    params[lvl], losses = out[0], out[1]
                    for pid in stats.banked:
                        i = members.index(pid)
                        # a copy of the member's row, so the bank holds no
                        # view into the round's whole member stack
                        self._bank[lvl].append({
                            "pid": pid, "round": r,
                            "n_eff": fl.assignment.n_eff.get(pid, 1),
                            "params": tree_map(lambda x, i=i: x[i].clone(),
                                               out[2])})
                    contributing = weights > 0
                    if contributing.any():
                        stats.mean_loss = float(np.mean(
                            losses.cpu().numpy()[contributing]))
            if cfg.eval_every and (r + 1) % cfg.eval_every == 0:
                stats.acc = fl.evaluate(lvl, params[lvl], test)
            clusters.append(stats)
            times.append(t_cluster)
        duration = (max(times, default=0.0) if cfg.schedule == "parallel"
                    else sum(times))
        report.add(RoundRecord(round=r, t_start=self.clock.now,
                               duration=duration, clusters=clusters,
                               events=ev_log))
        self.clock.advance(duration)

    # ------------------------------------------------------------ dispatch
    def _block_len(self, r: int) -> int:
        """Longest fused block starting at round r: capped by the dispatch
        width, the horizon, the next pending event (device/cluster state
        must be frozen across a block), and the next eval boundary
        (evaluation happens at block ends)."""
        cfg, fl = self.cfg, self.fl
        L = min(fl.cfg.rounds_per_dispatch, cfg.rounds - r)
        nt = self.queue.next_time()
        if nt is not None:
            L = min(L, max(1, math.ceil(nt) - r))
        if cfg.eval_every:
            e = cfg.eval_every
            L = min(L, (e - ((r + 1) % e)) % e + 1)
        return max(1, L)

    def _run_dispatch(self, test) -> SimReport:
        """Block mode (``FLConfig(rounds_per_dispatch>1)``): between events,
        up to R communication rounds per cluster run as one dispatch block
        over the flat parameter plane, with the buffered schedule's bank
        riding the block.  MAR decisions are frozen while no event fires,
        so per-round telemetry within a block is equal by construction and
        the per-round losses come back stacked — the records are as exact
        as the one-round path's.  KD teachers refresh at round granularity
        inside a block (``_teacher_planes``), so R = 1 and R > 1 give the
        same rounds under both schedules."""
        fl, cfg, tr = self.fl, self.cfg, self.obs.tracer
        report = SimReport(scenario=self.trace.name,
                           mar_policy=cfg.mar_policy, schedule=cfg.schedule,
                           obs=self.obs if self.obs.on else None)
        self.report = report
        buffered = fl.cfg.aggregation == "buffered"
        # which member forward the blocks run: "tp" (tensor-parallel over
        # the model axis) or "gather" (the plane's columns gathered each
        # round for a replicated forward) on a 2D mesh, else "replicated"
        fwd = ("tp" if getattr(fl, "_tp", False) else
               "gather" if getattr(fl, "_mesh_m", 1) > 1 else "replicated")
        with tr.span("sim.run", cat="engine", mode="dispatch",
                     member_forward=fwd, rounds=cfg.rounds):
            with tr.span("init_params", cat="engine"):
                resumed = self._maybe_resume(report, plane_mode=True)
                if resumed is None:
                    r = 0
                    planes = {lvl: fl.plane_of(lvl, fl.init_params(lvl))
                              for lvl in range(fl.m)}
                else:
                    r, planes = resumed
                tr.fence(planes)
            while r < cfg.rounds:
                with tr.span("round_block", cat="engine", round=r):
                    r = self._dispatch_block(r, planes, report, test,
                                             buffered)
                self._round_boundary(r, planes, report, plane_mode=True)
            with tr.span("terminal_flush", cat="engine"):
                self._terminal_flush(planes, cfg.rounds, report,
                                     merge=self._anchored_merge_plane)
            with tr.span("final_eval", cat="engine"):
                for lvl in range(fl.m):
                    if not fl.assignment.members.get(lvl):
                        continue
                    last = (report.rows[-1].clusters[lvl].acc
                            if report.rows else None)
                    report.final_acc[lvl] = (
                        last if last is not None
                        else fl.evaluate(lvl, fl.params_of(lvl, planes[lvl]),
                                         test))
                self.params = {lvl: fl.params_of(lvl, planes[lvl])
                               for lvl in range(fl.m)}
        return report

    def _dispatch_block(self, r: int, planes: dict, report: SimReport,
                        test, buffered: bool) -> int:
        """One fused block starting at round ``r``; returns the next round
        index (``r`` advanced by the realized block length)."""
        fl, cfg, tr = self.fl, self.cfg, self.obs.tracer
        with tr.span("mar_decisions", cat="engine", round=r):
            ev_log = self._apply_events(r)
            L = self._block_len(r)
            decisions = {}
            for lvl in range(fl.m):
                members = list(fl.assignment.members.get(lvl, []))
                if not members:
                    continue
                stats, masks, weights, t_cluster = self._mar_decisions(
                    lvl, members)
                ripe = [b for b in self._bank[lvl] if b["round"] < r]
                live = float(weights.sum()) > 0.0
                if not live and (ripe or stats.banked):
                    # anchored flush / bank-only edge round: keep it
                    # un-fused so the host-side anchor math applies
                    L = 1
                decisions[lvl] = (members, stats, masks, weights,
                                  t_cluster, ripe, live)
        kd = fl.m > 1 and fl.cfg.use_kd
        # the pre-flush, pre-block master plane: a copy, because the
        # master's block writes its result into planes[0] (donation) and the
        # parallel-cadence teacher stack still needs the block-start value
        # afterwards (the sequential cadence reads only post-round planes)
        master_start = (planes[0].clone()
                        if kd and cfg.schedule == "parallel" else None)
        master_hist = None                         # (L, D0) post-round
        rows = [[] for _ in range(L)]
        times = []
        for lvl in range(fl.m):
            if lvl not in decisions:
                for j in range(L):
                    rows[j].append(ClusterRoundStats(level=lvl, time=0.0))
                times.append(0.0)
                continue
            members, stats, masks, weights, t_cluster, ripe, live = \
                decisions[lvl]
            losses = None
            if live or stats.banked or ripe:
                if ripe:
                    self._bank[lvl] = [b for b in self._bank[lvl]
                                       if b["round"] >= r]
                    if not live:
                        with tr.span("bank_flush", cat="engine", level=lvl,
                                     entries=len(ripe)):
                            planes[lvl] = self._anchored_merge_plane(
                                planes[lvl], ripe, r, lvl)
                            tr.fence(planes[lvl])
                if live or stats.banked:
                    bank = (self._bank_carry(lvl, members,
                                             ripe if live else [],
                                             stats.banked, r)
                            if buffered else None)
                    kw = {}
                    if lvl == 0:
                        # per-round master planes feed the slaves' teacher
                        # stacks (only needed for fused blocks)
                        kw["want_history"] = kd and L > 1
                    elif kd:
                        with tr.span("kd_teacher", cat="engine",
                                     level=lvl):
                            kw["teacher_planes"] = self._teacher_planes(
                                L, master_start, master_hist, planes[0])
                    with tr.span("dispatch", cat="engine", level=lvl,
                                 round=r, block_len=L):
                        out = fl.dispatch_rounds(
                            lvl, members, planes[lvl], r, L,
                            step_masks=masks, weights=weights, bank=bank,
                            **kw)
                        tr.fence(out.plane)
                    planes[lvl] = out.plane
                    if lvl == 0 and kw.get("want_history"):
                        master_hist = out.history
                    losses = out.losses.cpu().numpy()
                    for pid in stats.banked:
                        i = members.index(pid)
                        # a copy: the row must not alias the block's bank
                        # buffer, which a later block may write into
                        self._bank[lvl].append({
                            "pid": pid, "round": r + L - 1,
                            "n_eff": fl.assignment.n_eff.get(pid, 1),
                            "plane": out.bank[0][i].clone()})
            contributing = weights > 0
            for j in range(L):
                s = self._clone_stats(stats)
                s.flushed = (len(ripe) if j == 0
                             else len(stats.banked) if live else 0)
                if losses is not None and contributing.any():
                    s.mean_loss = float(np.mean(losses[j][contributing]))
                rows[j].append(s)
            if cfg.eval_every and (r + L) % cfg.eval_every == 0:
                with tr.span("eval", cat="engine", level=lvl):
                    rows[L - 1][-1].acc = fl.evaluate(
                        lvl, fl.params_of(lvl, planes[lvl]), test)
            times.append(t_cluster)
        # fault-injection point: the block's programs ran, nothing recorded —
        # a kill here loses the whole in-flight block, and resume recomputes
        # it bit-identically from the last boundary checkpoint
        self.faults.mid_block(r, r + L)
        with tr.span("record_rounds", cat="engine", round=r, block_len=L):
            duration = (max(times, default=0.0)
                        if cfg.schedule == "parallel" else sum(times))
            for j in range(L):
                report.add(RoundRecord(round=r + j, t_start=self.clock.now,
                                       duration=duration, clusters=rows[j],
                                       events=ev_log if j == 0 else []))
                self.clock.advance(duration)
        return r + L

    def _teacher_planes(self, L: int, start, hist, cur):
        """Per-round KD teacher planes for a slave block, at the schedule's
        cadence.  Parallel (Eq. 9): the teacher for round r+j is the master
        BEFORE that round — the block-start plane, then the master's
        post-round planes shifted by one.  Sequential (Eq. 10): the teacher
        is the master AFTER round r+j.  When the master ran no fused block
        (empty or flush-only master round, or a length-1 block), ``hist``
        is None and the teacher is the one appropriate plane, which is the
        one-round path's behaviour."""
        if hist is not None:
            if self.cfg.schedule == "parallel":
                return self.fl.place_plane_stack(
                    torch.cat([start[None], hist[:-1]]))
            return hist
        t = start if self.cfg.schedule == "parallel" else cur
        return self.fl.place_plane_stack(t.expand(L, *t.shape))

    @staticmethod
    def _clone_stats(s: ClusterRoundStats) -> ClusterRoundStats:
        """Fresh per-round copy of a block's frozen MAR decision stats."""
        return replace(s, active=list(s.active), dropped=list(s.dropped),
                       offline=list(s.offline), masked=dict(s.masked),
                       violations=list(s.violations), banked=list(s.banked),
                       unselected=list(s.unselected),
                       flushed=0, mean_loss=float("nan"), acc=None)

    def _bank_carry(self, lvl: int, members: list[int], ripe: list,
                    banked_pids: list, r: int):
        """The bank a block carries: entering rows = the ripe host entries
        at their staleness-discounted weights; ``bank_gain`` = the weight
        each round's re-banked violator rows carry into the NEXT round's
        aggregate (n_eff · discount, age 1 inside a block)."""
        fl = self.fl
        cap = fl._capacity(len(members))
        dp = fl.plane_spec(lvl).d_pad
        us = aggregation.version_staleness_weights(
            [b["n_eff"] for b in ripe], [b["round"] for b in ripe], r,
            fl.cfg.staleness_discount)
        # membership may have shrunk below the banked backlog (event between
        # blocks): Σu-preserving compression fits it into the carry slots
        rows, us = aggregation.compress_bank_rows(
            [b["plane"] for b in ripe], us, cap, obs=self.obs)
        bank_plane = torch.zeros((cap, dp), dtype=torch.float32,
                                 device=fl.device)
        bank_w = np.zeros(cap, np.float32)
        if rows:
            bank_plane[:len(rows)] = torch.stack(rows)
            bank_w[:len(rows)] = us
        bank_gain = np.zeros(cap, np.float32)
        for pid in banked_pids:
            bank_gain[members.index(pid)] = (
                fl.assignment.n_eff.get(pid, 1) * fl.cfg.staleness_discount)
        return (fl.place_member_plane(bank_plane),
                fl.place_member_sharded(bank_w),
                fl.place_member_sharded(bank_gain))

    def _anchor_weights(self, entries: list, r: int, lvl: int):
        """Shared anchor math for flushes with no live contributors: the
        cluster's full live n_eff weight W anchors the convex combination,
        so discounted stale updates nudge — never replace — the model;
        ``anchored_merge_weights`` carries the zero-total contract.
        Returns (anchor weight, normalized per-entry weights)."""
        fl = self.fl
        W = float(sum(fl.assignment.n_eff.get(pid, 1)
                      for pid in fl.assignment.members.get(lvl, [])))
        us = aggregation.version_staleness_weights(
            [b["n_eff"] for b in entries], [b["round"] for b in entries],
            r, fl.cfg.staleness_discount)
        return aggregation.anchored_merge_weights(W, us)

    def _anchored_merge(self, cur, entries: list, r: int, lvl: int):
        """Anchored flush over pytree params (one-round path)."""
        wa, us = self._anchor_weights(entries, r, lvl)
        anchored = tree_map(lambda x: wa * x, cur)
        return aggregation.merge_buffered(
            anchored, [b["params"] for b in entries], us, obs=self.obs)

    def _anchored_merge_plane(self, cur, entries: list, r: int, lvl: int):
        """Anchored flush over the flat parameter plane (dispatch path):
        one fedagg contraction over the (entries, D_pad) stack."""
        wa, us = self._anchor_weights(entries, r, lvl)
        return self.fl.place_plane(
            wa * cur + aggregation.aggregate_plane(
                torch.stack([b["plane"] for b in entries]),
                torch.tensor(us, dtype=torch.float32, device=cur.device)))

    # ------------------------------------------------------------ async
    def _run_async(self, test) -> SimReport:
        """Continuous-time asynchronous parameter server: every cluster runs
        on its own clock.  A dispatch pulls the cluster's current server
        state and version, runs its block eagerly, and registers a
        completion on a deterministic (time, priority, seq) queue; popping a
        completion COMMITS the block — a merge event: the server version
        advances by the block length, ledger staleness re-prices in server
        versions, the conservation invariant re-checks, and the cluster may
        dispatch again subject to ``max_staleness`` (committed-round lead
        over the slowest unfinished cluster; 0 degenerates to barrier
        sweeps that reproduce the sync buffered path bit-for-bit).
        Checkpoints and fault hooks re-anchor on merge events."""
        fl, cfg, tr = self.fl, self.cfg, self.obs.tracer
        plane = self._async_plane = fl.cfg.rounds_per_dispatch > 1
        report = SimReport(scenario=self.trace.name,
                           mar_policy=cfg.mar_policy, schedule=cfg.schedule,
                           obs=self.obs if self.obs.on else None)
        self.report = report
        self._aclk = {lvl: ClusterClock() for lvl in range(fl.m)}
        self._servers: dict[int, AsyncPlaneServer] = {}
        self._pending_blocks: dict[int, dict] = {}
        self._done_q = EventQueue()
        self._row_buf: dict[int, dict] = {}
        self._ev_buf: dict[int, list] = {}
        self._emitted = 0
        self._merge_step = 0
        self._master_block = None
        with tr.span("sim.run", cat="engine", mode="async",
                     rounds=cfg.rounds):
            with tr.span("init_params", cat="engine"):
                if self._maybe_resume_async(report) is None:
                    for lvl in range(fl.m):
                        init = fl.init_params(lvl)
                        state = fl.plane_of(lvl, init) if plane else init
                        self._servers[lvl] = AsyncPlaneServer(
                            lvl, state, ledger=self._bank[lvl])
                tr.fence({l: s.state for l, s in self._servers.items()})
            while True:
                with tr.span("async_schedule", cat="engine",
                             step=self._merge_step):
                    self._async_schedule(report, test)
                nxt = self._done_q.pop()
                if nxt is None:
                    break
                t_done, ev = nxt
                with tr.span("merge_event", cat="engine", level=ev.level,
                             step=self._merge_step):
                    self._async_commit(ev.level, t_done, report)
                    self._async_emit_rows(report)
                self._merge_step += 1
                self._async_boundary(report)
            if self._row_buf:
                raise RuntimeError(
                    "async round assembly incomplete: rounds "
                    f"{sorted(self._row_buf)} missing cluster contributions")
            states = {lvl: self._servers[lvl].state for lvl in range(fl.m)}
            with tr.span("terminal_flush", cat="engine"):
                self._terminal_flush(
                    states, cfg.rounds, report,
                    merge=self._anchored_merge_plane if plane else None)
                for lvl in range(fl.m):
                    self._servers[lvl].state = states[lvl]
            with tr.span("final_eval", cat="engine"):
                for lvl in range(fl.m):
                    if not fl.assignment.members.get(lvl):
                        continue
                    last = (report.rows[-1].clusters[lvl].acc
                            if report.rows else None)
                    report.final_acc[lvl] = (
                        last if last is not None
                        else fl.evaluate(lvl, self._async_params(lvl), test))
                self.params = {lvl: self._async_params(lvl)
                               for lvl in range(fl.m)}
            report.registry.gauge("async/wall_clock_s").set(
                max((c.now for c in self._aclk.values()), default=0.0))
        return report

    def _async_params(self, lvl: int):
        s = self._servers[lvl].state
        return self.fl.params_of(lvl, s) if self._async_plane else s

    def _async_schedule(self, report: SimReport, test) -> None:
        """Dispatch every ready cluster.  Ready = unfinished, nothing in
        flight, and within ``max_staleness`` committed rounds of the slowest
        unfinished cluster (the frontier cluster is never stalled, so
        progress is guaranteed).  ``max_staleness=0`` degenerates to barrier
        sweeps: all clusters dispatch together at the shared round with a
        shared block length — the sync buffered path's exact structure."""
        fl, cfg = self.fl, self.cfg
        unfinished = [l for l in range(fl.m)
                      if self._servers[l].version < cfg.rounds]
        if not unfinished:
            return
        frontier = min(self._servers[l].version for l in unfinished)
        ready = [l for l in unfinished
                 if l not in self._pending_blocks
                 and (cfg.max_staleness is None
                      or self._servers[l].version - frontier
                      <= cfg.max_staleness)]
        if not ready:
            return
        reg = report.registry
        for lvl in ready:
            reg.gauge(f"async/version_lag/{lvl}").set(
                float(self._servers[lvl].version - frontier))
        if cfg.max_staleness == 0:
            if len(ready) < len(unfinished):
                return                    # barrier: wait for in-flight
            self._async_sweep(ready, report, test)
        else:
            for lvl in ready:
                self._async_dispatch_one(lvl, report, test)

    def _async_decision(self, lvl: int):
        """(frozen MAR decision of cluster ``lvl``'s next block or None when
        it is empty, whether the block must be one round long: an anchored
        flush or a bank-only round with no live member)."""
        members = list(self.fl.assignment.members.get(lvl, []))
        if not members:
            return None, False
        stats, masks, weights, t_cluster = self._mar_decisions(lvl, members)
        ripe = self._servers[lvl].ripe()
        live = float(weights.sum()) > 0.0
        return ((members, stats, masks, weights, t_cluster, ripe, live),
                not live and bool(ripe or stats.banked))

    def _async_sweep(self, levels: list, report: SimReport, test) -> None:
        """Barrier sweep (``max_staleness=0``): all clusters at the same
        round, one global event pop and a shared block length — including
        the anchored-flush L=1 force — exactly as ``_dispatch_block``."""
        r = self._servers[levels[0]].version
        ev_log = self._apply_events(r)
        if ev_log:
            self._ev_buf.setdefault(r, []).extend(ev_log)
        L = self._block_len(r)
        decisions = {}
        for lvl in levels:
            decisions[lvl], one_round = self._async_decision(lvl)
            if one_round:
                L = 1
        for lvl in levels:
            self._async_exec(lvl, r, L, decisions[lvl], report, test)

    def _async_dispatch_one(self, lvl: int, report: SimReport, test) -> None:
        """Independent-clock dispatch: the cluster pops only its own
        participants' due events, freezes MAR decisions, and runs its block
        at its own round cursor with a per-cluster block length."""
        r = self._servers[lvl].version
        ev_log = self._apply_events_for(lvl, r)
        if ev_log:
            self._ev_buf.setdefault(r, []).extend(ev_log)
        L = self._block_len(r)
        dec, one_round = self._async_decision(lvl)
        self._async_exec(lvl, r, 1 if one_round else L, dec, report, test)

    def _async_exec(self, lvl: int, r: int, L: int, dec, report: SimReport,
                    test) -> None:
        """Eagerly run one cluster block [r, r+L): ripe-ledger flush, bank
        carry, the dispatch block (or the one-round program), per-round
        row cloning and block-end eval — then register the pending commit
        at the cluster's own completion time on the completion queue."""
        fl, cfg, tr = self.fl, self.cfg, self.obs.tracer
        server = self._servers[lvl]
        buffered = fl.cfg.aggregation == "buffered"
        kd = fl.m > 1 and fl.cfg.use_kd
        mb_start = None
        if lvl == 0 and kd:
            # the pre-flush, pre-block master state: the parallel-cadence KD
            # teacher anchor (a copy on the plane path, sharing memory with
            # no plane a block writes into; the one-round path builds new
            # parameter trees)
            mb_start = (server.state.clone() if self._async_plane
                        else server.state)
        new_state, losses, hist, t_cluster = None, None, None, 0.0
        if dec is not None:
            members, stats, masks, weights, t_cluster, ripe, live = dec
            if live or stats.banked or ripe:
                state = server.state
                if ripe:
                    h = report.registry.histogram("async/staleness")
                    for b in ripe:
                        h.observe(float(server.lag_of(b)))
                    server.drop_ripe()
                if self._async_plane:
                    if ripe and not live:
                        with tr.span("bank_flush", cat="engine", level=lvl,
                                     entries=len(ripe)):
                            state = self._anchored_merge_plane(
                                state, ripe, r, lvl)
                            tr.fence(state)
                        new_state = state
                    if live or stats.banked:
                        bank = (self._bank_carry(lvl, members,
                                                 ripe if live else [],
                                                 stats.banked, r)
                                if buffered else None)
                        kw = {}
                        if lvl == 0:
                            kw["want_history"] = kd and L > 1
                        elif kd:
                            with tr.span("kd_teacher", cat="engine",
                                         level=lvl):
                                kw["teacher_planes"] = self._async_teacher(
                                    r, L)
                        with tr.span("dispatch", cat="engine", level=lvl,
                                     round=r, block_len=L):
                            # the block writes its result into its input
                            # plane; the server keeps its committed state
                            # until the commit event, so the block gets a
                            # copy
                            out = fl.dispatch_rounds(
                                lvl, members, state.clone(), r, L,
                                step_masks=masks, weights=weights,
                                bank=bank, **kw)
                            tr.fence(out.plane)
                        new_state = out.plane
                        if lvl == 0 and kw.get("want_history"):
                            hist = out.history
                        losses = out.losses.cpu().numpy()
                        for pid in stats.banked:
                            i = members.index(pid)
                            # a copy: the row must not alias the block's
                            # bank buffer
                            server.ledger.append({
                                "pid": pid, "round": r + L - 1,
                                "n_eff": fl.assignment.n_eff.get(pid, 1),
                                "plane": out.bank[0][i].clone()})
                else:
                    teacher = (self._async_teacher_legacy(r)
                               if kd and lvl > 0 else None)
                    contribs = None
                    if ripe and live:
                        us = aggregation.version_staleness_weights(
                            [b["n_eff"] for b in ripe],
                            [b["round"] for b in ripe], r,
                            fl.cfg.staleness_discount)
                        contribs = [(b["params"], u)
                                    for b, u in zip(ripe, us)]
                    elif ripe:
                        state = self._anchored_merge(state, ripe, r, lvl)
                        new_state = state
                    if live or stats.banked:
                        with tr.span("cluster_round", cat="engine",
                                     level=lvl, round=r):
                            out = fl.cluster_round(
                                lvl, members, state, r, teacher=teacher,
                                step_masks=masks, weights=weights,
                                buffered=contribs, return_stack=buffered)
                            tr.fence(out[0])
                        new_state = out[0]
                        losses = out[1].cpu().numpy()[None]
                        for pid in stats.banked:
                            i = members.index(pid)
                            server.ledger.append({
                                "pid": pid, "round": r,
                                "n_eff": fl.assignment.n_eff.get(pid, 1),
                                "params": tree_map(
                                    lambda x, i=i: x[i].clone(), out[2])})
        if lvl == 0 and kd:
            self._master_block = MasterBlock(r, L, mb_start, hist)
        if dec is None:
            rows = [ClusterRoundStats(level=lvl, time=0.0)
                    for _ in range(L)]
        else:
            contributing = weights > 0
            rows = []
            for j in range(L):
                s = self._clone_stats(stats)
                s.flushed = (len(ripe) if j == 0
                             else len(stats.banked) if live else 0)
                if losses is not None and contributing.any():
                    s.mean_loss = float(np.mean(losses[j][contributing]))
                rows.append(s)
            if cfg.eval_every and (r + L) % cfg.eval_every == 0:
                state_now = (new_state if new_state is not None
                             else server.state)
                with tr.span("eval", cat="engine", level=lvl):
                    rows[-1].acc = fl.evaluate(
                        lvl,
                        fl.params_of(lvl, state_now) if self._async_plane
                        else state_now, test)
        self.faults.mid_block(r, r + L)
        clk = self._aclk[lvl]
        self._pending_blocks[lvl] = {
            "r0": r, "L": L, "rows": rows, "t_round": float(t_cluster),
            "state": new_state,
            "members_n": len(members) if dec is not None else 0}
        self._done_q.push(clk.now + L * float(t_cluster),
                          ClusterDone(-1, level=lvl))

    def _async_teacher(self, r: int, L: int):
        """Per-round KD teacher stack for a slave block in async mode:
        round-aligned with the master's latest block → the exact
        parallel-cadence stack the sync schedule uses; misaligned (clusters
        drifted apart under unbounded staleness) → the master's latest
        committed plane repeated over the block (a stride-0 view that
        nothing writes into) — a stale teacher, the KD analogue of a stale
        gradient."""
        mb = self._master_block
        if mb is not None and mb.r0 == r and mb.length == L:
            return self._teacher_planes(L, mb.start, mb.hist,
                                        self._servers[0].state)
        t = self._servers[0].state
        return self.fl.place_plane_stack(t.expand(L, *t.shape))

    def _async_teacher_legacy(self, r: int):
        """One-round-path teacher params: the master's pre-round state when
        round-aligned, else its latest committed state (stale teacher)."""
        mb = self._master_block
        if mb is not None and mb.r0 == r:
            return mb.start
        return self._servers[0].state

    def _async_commit(self, lvl: int, t_done: float,
                      report: SimReport) -> None:
        """Merge event: install the block's state at the server, advance
        version and cluster clock, verify conservation, and file the
        per-round rows into the global-round assembly buffer."""
        p = self._pending_blocks.pop(lvl)
        server = self._servers[lvl]
        server.commit(p["state"] if p["state"] is not None else server.state,
                      p["L"])
        clk = self._aclk[lvl]
        for j, s in enumerate(p["rows"]):
            self._check_conservation(s, p["members_n"], p["r0"] + j)
            self._row_buf.setdefault(p["r0"] + j, {})[lvl] = (
                s, clk.now + j * p["t_round"], p["t_round"])
        clk.advance(p["L"] * p["t_round"], rounds=p["L"])
        self.clock.now = max(self.clock.now, float(t_done))
        report.registry.counter("async/merges").inc()

    @staticmethod
    def _check_conservation(s: ClusterRoundStats, n: int, r: int) -> None:
        """Per-merge-event conservation invariant: every member at dispatch
        time lands in exactly one bucket (masked ⊂ active)."""
        got = (len(s.active) + len(s.dropped) + len(s.offline)
               + len(s.unselected) + len(s.banked))
        if got != n:
            raise RuntimeError(
                f"conservation violated at round {r} level {s.level}: "
                f"{got} bucketed of {n} members")

    def _async_emit_rows(self, report: SimReport) -> None:
        """Emit assembled ``RoundRecord``s in global round order once every
        cluster has contributed its row for that round.  t_start is the
        earliest per-cluster round start, duration the slowest cluster's
        per-round time — for a single cluster both collapse to the sync
        engine's values."""
        fl, cfg = self.fl, self.cfg
        while self._emitted < cfg.rounds:
            per = self._row_buf.get(self._emitted)
            if per is None or len(per) < fl.m:
                return
            del self._row_buf[self._emitted]
            t_start = min(t for _, t, _ in per.values())
            duration = max(d for _, _, d in per.values())
            report.add(RoundRecord(
                round=self._emitted, t_start=t_start, duration=duration,
                clusters=[per[lvl][0] for lvl in range(fl.m)],
                events=self._ev_buf.pop(self._emitted, [])))
            self._emitted += 1

    def _async_boundary(self, report: SimReport) -> None:
        """After each merge event: retain and, when due, write a checkpoint
        (step = the monotonic merge-event counter — async has no global
        round), then fire the boundary fault hook (``kill_at_round=k``
        kills at the k-th merge event in async mode)."""
        step = self._merge_step
        if self.checkpoint is not None:
            meta, arrays = self._capture_state_async(report)
            self._pending_state = (step, meta, arrays)
            if self.checkpoint.due(step):
                self.checkpoint.save(step, self.KIND, meta, arrays)
        self.faults.round_boundary(step)

    def _capture_state_async(self, report: SimReport) -> tuple[dict, dict]:
        """Async snapshot = the sync capture at the frontier round (committed
        server states, ledger, participant/trace state, rows, metrics) plus
        the async section: per-cluster clocks, server version/merge
        counters, the completion queue, pending (in-flight) block outputs
        and the partial round-assembly buffers."""
        fl = self.fl
        plane = self._async_plane
        unfinished = [l for l in range(fl.m)
                      if self._servers[l].version < self.cfg.rounds]
        frontier = (min(self._servers[l].version for l in unfinished)
                    if unfinished else self.cfg.rounds)
        states = {lvl: self._servers[lvl].state for lvl in range(fl.m)}
        meta, arrays = self._capture_state(frontier, states, report, plane)
        meta["mode"] = "async"
        a = {
            "step": int(self._merge_step),
            "emitted": int(self._emitted),
            "plane_mode": bool(plane),
            "clocks": [[int(lvl), float(c.now), int(c.round)]
                       for lvl, c in sorted(self._aclk.items())],
            "servers": [[int(lvl), int(s.version), int(s.merges)]
                        for lvl, s in sorted(self._servers.items())],
            "done_q": self._done_q.encode(),
            "ev_buf": [[int(r), [str(e) for e in evs]]
                       for r, evs in sorted(self._ev_buf.items())],
            "row_buf": [[int(r),
                         [[int(lvl), encode_stats(s), float(t), float(d)]
                          for lvl, (s, t, d) in sorted(per.items())]]
                        for r, per in sorted(self._row_buf.items())],
            "pending": {str(lvl): {
                "r0": int(p["r0"]), "L": int(p["L"]),
                "t_round": float(p["t_round"]),
                "members_n": int(p["members_n"]),
                "has_state": p["state"] is not None,
                "rows": [encode_stats(s) for s in p["rows"]],
            } for lvl, p in sorted(self._pending_blocks.items())},
            "master_block": None,
        }
        for lvl, p in self._pending_blocks.items():
            if p["state"] is not None:
                row = p["state"] if plane else fl.plane_of(lvl, p["state"])
                arrays[f"async/pending/{lvl}/state"] = _host(row)
        mb = self._master_block
        if mb is not None:
            a["master_block"] = {"r0": int(mb.r0), "L": int(mb.length),
                                 "has_hist": mb.hist is not None}
            row = mb.start if plane else fl.plane_of(0, mb.start)
            arrays["async/mb/start"] = _host(row)
            if mb.hist is not None:
                arrays["async/mb/hist"] = _host(mb.hist)
        meta["async"] = a
        return meta, arrays

    def _maybe_resume_async(self, report: SimReport):
        """Restore the full async state (servers, clocks, pending blocks,
        completion queue, assembly buffers) from the newest valid
        checkpoint; returns None to start fresh."""
        ck = self.checkpoint
        if ck is None or not ck.resume:
            return None
        got = ck.load_latest(self.KIND)
        if got is None:
            log.warning("resume requested but no valid checkpoint under "
                        "%s; starting from scratch", ck.manager.dir)
            return None
        step, meta, arrays = got
        return self._load_state_async(meta, arrays, report)

    def _load_state_async(self, meta: dict, arrays: dict,
                          report: SimReport) -> bool:
        fl = self.fl
        plane = self._async_plane
        a = meta.get("async")
        if a is not None and bool(a["plane_mode"]) != plane:
            raise CheckpointError(
                "async checkpoint was written with rounds_per_dispatch "
                f"{'> 1' if a['plane_mode'] else '== 1'}; the engine's "
                "pending-block representation does not translate")
        _, states = self._load_state(meta, arrays, report, plane,
                                     async_mode=True)
        for lvl in range(fl.m):
            self._servers[lvl] = AsyncPlaneServer(lvl, states[lvl],
                                                  ledger=self._bank[lvl])
        for lvl, ver, merges in a["servers"]:
            self._servers[int(lvl)].version = int(ver)
            self._servers[int(lvl)].merges = int(merges)
        self._aclk = {int(lvl): ClusterClock(float(now), int(rd))
                      for lvl, now, rd in a["clocks"]}
        self._done_q.load_encoded(a["done_q"])
        self._merge_step = int(a["step"])
        self._emitted = int(a["emitted"])
        self._ev_buf = {int(r): [str(e) for e in evs]
                        for r, evs in a["ev_buf"]}
        self._row_buf = {
            int(r): {int(lvl): (decode_stats(s), float(t), float(d))
                     for lvl, s, t, d in per}
            for r, per in a["row_buf"]}
        self._pending_blocks = {}
        for l_str, p in a["pending"].items():
            lvl = int(l_str)
            state = None
            if p["has_state"]:
                state = self._restored_state(
                    lvl, arrays[f"async/pending/{lvl}/state"], plane)
            self._pending_blocks[lvl] = {
                "r0": int(p["r0"]), "L": int(p["L"]),
                "t_round": float(p["t_round"]),
                "members_n": int(p["members_n"]), "state": state,
                "rows": [decode_stats(s) for s in p["rows"]]}
        mb = a.get("master_block")
        self._master_block = None
        if mb is not None:
            start = self._restored_state(0, arrays["async/mb/start"], plane)
            hist = (fl.place_plane_stack(
                torch.as_tensor(arrays["async/mb/hist"]))
                if mb["has_hist"] else None)
            self._master_block = MasterBlock(int(mb["r0"]), int(mb["L"]),
                                             start, hist)
        log.info("resumed async run at merge step %d from %s",
                 self._merge_step, self.checkpoint.manager.dir)
        return True

    # ------------------------------------------------------------ checkpoint
    def _round_boundary(self, r: int, params: dict, report: SimReport,
                        plane_mode: bool) -> None:
        """After ``r`` rounds completed: retain a host-side run-state
        snapshot (the graceful-shutdown payload), write it at the
        checkpointer's cadence, then fire the boundary fault hook."""
        if self.checkpoint is not None:
            meta, arrays = self._capture_state(r, params, report, plane_mode)
            self._pending_state = (r, meta, arrays)
            if self.checkpoint.due(r):
                self.checkpoint.save(r, self.KIND, meta, arrays)
        self.faults.round_boundary(r)

    def save_now(self):
        """Write the newest retained boundary snapshot immediately (the
        SIGTERM/SIGINT path).  Returns the step written, or None when no
        boundary was reached or checkpointing is off."""
        if self.checkpoint is None or self._pending_state is None:
            return None
        r, meta, arrays = self._pending_state
        self.checkpoint.save(r, self.KIND, meta, arrays)
        return r

    def _capture_state(self, r: int, params: dict, report: SimReport,
                       plane_mode: bool) -> tuple[dict, dict]:
        """Snapshot at the start of round ``r`` (events for round ``r`` not
        yet applied).  Model state is serialized uniformly as per-level
        (D_pad,) fp32 planes, host copies of the device planes — exact for
        the fp32 families on both paths — so a checkpoint is path-agnostic:
        a one-round-path run can resume a dispatch checkpoint and the
        reverse."""
        fl = self.fl
        asg = fl.assignment
        reg_meta, reg_arrays = report.registry.state()
        meta = {
            "mode": "dispatch" if plane_mode else "legacy",
            "round": int(r),
            "clock": float(self.clock.now),
            "sampler": {
                "seed": int(fl.cfg.seed), "round": int(r),
                "fingerprint": device_sampler.stream_fingerprint(
                    int(fl.cfg.seed), int(r))},
            "online": sorted(int(p) for p in self.online),
            "gone": sorted(int(p) for p in self._gone),
            "spikes": [[int(p), float(f), int(tok)]
                       for p, (f, tok) in sorted(self._spikes.items())],
            "spike_seq": int(self._spike_seq),
            "rejoin_token": [[int(p), int(t)]
                             for p, t in sorted(self._rejoin_token.items())],
            "queue": self.queue.encode(),
            "assignment": {
                "members": {str(l): [int(p) for p in v]
                            for l, v in asg.members.items()},
                "n_eff": [[int(p), int(v)]
                          for p, v in sorted(asg.n_eff.items())],
                "tau": [[int(p), int(v)]
                        for p, v in sorted(asg.tau.items())],
                "demotions": int(asg.demotions),
                "diagnostics": [[int(p), int(l), str(why)]
                                for p, l, why in asg.diagnostics],
            },
            "bank": {str(l): [{"pid": int(b["pid"]), "round": int(b["round"]),
                               "n_eff": int(b["n_eff"])} for b in entries]
                     for l, entries in self._bank.items()},
            "rows": encode_rows(report.rows),
            "final_acc": [[int(l), float(a)]
                          for l, a in sorted(report.final_acc.items())],
            "obs": reg_meta,
        }
        arrays = {}
        for lvl in range(fl.m):
            plane = (params[lvl] if plane_mode
                     else fl.plane_of(lvl, params[lvl]))
            arrays[f"plane/{lvl}"] = _host(plane)
        for lvl, entries in self._bank.items():
            for i, b in enumerate(entries):
                row = (b["plane"] if plane_mode
                       else fl.plane_of(lvl, b["params"]))
                arrays[f"bank/{lvl}/{i}"] = _host(row)
        arrays["parts/V"] = np.array([[p.s, p.r, p.a] for p in fl.parts],
                                     np.float64)
        arrays["parts/n_data"] = np.array([p.n_data for p in fl.parts],
                                          np.int64)
        for k, v in reg_arrays.items():
            arrays[f"obs/{k}"] = v
        return meta, arrays

    def _restored_state(self, lvl: int, row: np.ndarray, plane_mode: bool):
        """A checkpointed (D_pad,) plane on the device: the plane itself on
        the dispatch path, its params tree (views into it) on the
        one-round path."""
        plane = self.fl.place_plane(torch.as_tensor(row))
        return plane if plane_mode else self.fl.params_of(lvl, plane)

    def _maybe_resume(self, report: SimReport, plane_mode: bool):
        """(r0, params-or-planes) from the newest valid checkpoint, or None
        to start from scratch (resume off, or no checkpoint validates —
        graceful degradation, never a crash)."""
        ck = self.checkpoint
        if ck is None or not ck.resume:
            return None
        got = ck.load_latest(self.KIND)
        if got is None:
            log.warning("resume requested but no valid checkpoint under "
                        "%s; starting from round 0", ck.manager.dir)
            return None
        step, meta, arrays = got
        return self._load_state(meta, arrays, report, plane_mode)

    def _load_state(self, meta: dict, arrays: dict, report: SimReport,
                    plane_mode: bool, async_mode: bool = False):
        """Overlay a captured run state onto this (freshly constructed)
        engine.  The engine must have been built from the same seed and
        config — everything ``setup()`` derives deterministically (data,
        clustering, specs) is rebuilt, only the mutated state is restored.
        Returns (r0, params-or-planes)."""
        if bool(meta.get("async")) != bool(async_mode):
            # a sync engine cannot honour pending async blocks (they would
            # be silently dropped) and an async engine cannot synthesize
            # per-cluster clocks from a global round cursor
            raise CheckpointError(
                "checkpoint mode mismatch: {}-mode checkpoint cannot "
                "resume a {}-mode run".format(
                    "async" if meta.get("async") else "sync",
                    "async" if async_mode else "sync"))
        fl = self.fl
        r0 = int(meta["round"])
        samp = meta["sampler"]
        if int(samp["seed"]) != int(fl.cfg.seed):
            raise CheckpointError(
                f"checkpoint sampler seed {samp['seed']} != configured "
                f"seed {fl.cfg.seed}")
        fp = device_sampler.stream_fingerprint(int(samp["seed"]),
                                               int(samp["round"]))
        if fp != int(samp["fingerprint"]):
            raise CheckpointError(
                "sampler stream fingerprint mismatch — the (absolute "
                "round, global slot) stream diverged since this checkpoint "
                "was written (or another package wrote it); resuming would "
                "not be bit-identical")
        # participant resources (drift events mutate them in place)
        V = arrays["parts/V"]
        nd = arrays["parts/n_data"]
        if len(V) != len(fl.parts):
            raise CheckpointError(
                f"checkpoint has {len(V)} participants, engine has "
                f"{len(fl.parts)}")
        if fl.fleet is not None:
            fl.fleet.V[:] = V
            fl.fleet.n_data[:] = nd
        else:
            for p, row, n in zip(fl.parts, V, nd):
                p.s, p.r, p.a = float(row[0]), float(row[1]), float(row[2])
                p.n_data = int(n)
        am = meta["assignment"]
        asg = fl.assignment
        asg.members = {int(l): [int(p) for p in v]
                       for l, v in am["members"].items()}
        asg.n_eff = {int(p): int(v) for p, v in am["n_eff"]}
        asg.tau = {int(p): int(v) for p, v in am["tau"]}
        asg.demotions = int(am["demotions"])
        asg.diagnostics = [(int(p), int(l), str(w))
                           for p, l, w in am["diagnostics"]]
        self.online = {int(p) for p in meta["online"]}
        self._gone = {int(p) for p in meta["gone"]}
        self._spikes = {int(p): (float(f), int(tok))
                        for p, f, tok in meta["spikes"]}
        self._spike_seq = int(meta["spike_seq"])
        self._rejoin_token = {int(p): int(t) for p, t in meta["rejoin_token"]}
        self.queue.load_encoded(meta["queue"])
        self.clock.now = float(meta["clock"])
        self._bank = {lvl: [] for lvl in range(fl.m)}
        for l_str, entries in meta["bank"].items():
            lvl = int(l_str)
            for i, b in enumerate(entries):
                entry = {"pid": int(b["pid"]), "round": int(b["round"]),
                         "n_eff": int(b["n_eff"])}
                entry["plane" if plane_mode else "params"] = \
                    self._restored_state(lvl, arrays[f"bank/{lvl}/{i}"],
                                         plane_mode)
                self._bank[lvl].append(entry)
        report.rows = decode_rows(meta["rows"])
        report.final_acc = {int(l): float(a) for l, a in meta["final_acc"]}
        report.registry.load_state(
            meta["obs"], {k[len("obs/"):]: v for k, v in arrays.items()
                          if k.startswith("obs/")})
        params = {}
        for lvl in range(fl.m):
            plane = arrays[f"plane/{lvl}"]
            if plane.shape != (fl.plane_spec(lvl).d_pad,):
                raise CheckpointError(
                    f"level {lvl} plane shape {plane.shape} != "
                    f"({fl.plane_spec(lvl).d_pad},) — model family "
                    "changed since the checkpoint")
            params[lvl] = self._restored_state(lvl, plane, plane_mode)
        log.info("resumed %s run at round %d from %s", meta["mode"], r0,
                 self.checkpoint.manager.dir)
        return r0, params

    def _terminal_flush(self, params: dict, rounds: int, report,
                        merge=None) -> None:
        """Merge updates still sitting in the bank when the sim ends (banked
        in the last round, or in a cluster that never ran again), so 'no
        work is thrown away' holds for the last round too.  ``merge``
        selects the representation (the pytree path by default; the
        dispatch path passes ``_anchored_merge_plane``)."""
        merge = merge or self._anchored_merge
        for lvl, entries in self._bank.items():
            if not entries:
                continue
            params[lvl] = merge(params[lvl], entries, rounds, lvl)
            report.bump_flushed(lvl, len(entries))
            self._bank[lvl] = []
