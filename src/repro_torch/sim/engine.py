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

This is the synchronous engine.  The continuous-time async server
(``mode="async"``) is ROADMAP item 7's remaining part, and checkpoints and
resume are item 8: both raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import aggregation, cost_model
from repro_torch.core.server import FedRAC
from repro_torch.core.tree import tree_map
from repro_torch.obs import NULL_OBS
from repro_torch.sim.clock import EventQueue, SimClock
from repro_torch.sim.events import (Arrival, Departure, ResourceDrift,
                                    SpikeEnd, StragglerSpike)
from repro_torch.sim.faults import NULL_FAULTS
from repro_torch.sim.report import ClusterRoundStats, RoundRecord, SimReport
from repro_torch.sim.traces import Trace


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
    mode: str = "sync"                # sync (async: ROADMAP item 7)


class HeterogeneitySim:
    """Couples a set-up ``FedRAC`` with a ``Trace`` and runs the event loop.

    ``obs`` (an ``Observability`` bundle) is shared with the engine when the
    engine has none.  ``checkpoint`` must be None and ``faults`` defaults to
    the hooks that never fire: run-state checkpoints, resume and fault
    injection are ROADMAP item 8."""

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
            raise ValueError('mode "async" requires schedule "parallel"')
        if cfg.mode == "async":
            raise NotImplementedError(
                'mode "async" (the continuous-time async server) is not '
                "ported yet (ROADMAP item 7, async part)")
        if checkpoint is not None:
            raise NotImplementedError(
                "run-state checkpoints and resume are not ported yet "
                "(ROADMAP item 8)")
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
        self.faults = faults if faults is not None else NULL_FAULTS
        self.report: SimReport | None = None

    # ------------------------------------------------------------ events
    def _apply_events(self, r: int) -> list[str]:
        """Fire every due event.  Arrivals first at equal timestamps: a
        scheduled rejoin and a fresh trace Departure landing on the same
        round net to "rejoined, then dropped again" (the queue's (time,
        priority, seq) key encodes this order)."""
        return self._apply_event_list(self.queue.pop_due(float(r)))

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
                params = {lvl: fl.init_params(lvl) for lvl in range(fl.m)}
                tr.fence(params)
            for r in range(cfg.rounds):
                with tr.span("round", cat="engine", round=r):
                    self._legacy_round(r, params, report, test)
                self.faults.round_boundary(r + 1)
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
        with tr.span("sim.run", cat="engine", mode="dispatch",
                     member_forward="replicated", rounds=cfg.rounds):
            with tr.span("init_params", cat="engine"):
                r = 0
                planes = {lvl: fl.plane_of(lvl, fl.init_params(lvl))
                          for lvl in range(fl.m)}
                tr.fence(planes)
            while r < cfg.rounds:
                with tr.span("round_block", cat="engine", round=r):
                    r = self._dispatch_block(r, planes, report, test,
                                             buffered)
                self.faults.round_boundary(r)
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
        # fault-injection point: the fused programs ran, nothing recorded
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

    def save_now(self):
        """Write a final run-state checkpoint: ROADMAP item 8."""
        raise NotImplementedError(
            "run-state checkpoints are not ported yet (ROADMAP item 8)")
