"""Fed-RAC orchestrator (Algorithm 1): cluster -> compact -> assign ->
train the master by FedAvg -> train the slaves under master KD.

Model-family-agnostic via ``FLModelFamily``.  A cluster's members train
together under one ``torch.func.vmap`` (``core.client``).  Two training
paths, chosen by ``FLConfig.rounds_per_dispatch``:

* R = 1, ``cluster_round``: host-sampled numpy batches (seed + 977 pid +
  round, as the JAX package) and a pytree FedAvg;
* R > 1, ``dispatch_rounds``: R rounds per block over device-resident
  member shards, parameters carried as one flat fp32 plane, and the FedAvg
  on the plane through the fedagg kernel.  Batch indices come from a stream
  keyed on (seed, absolute round, member slot), so any two R agree.

Member data reaches the dispatch path through two hooks with the JAX
package's contracts: ``_member_shard(pid)`` gives one member's shard (any
pytree; its first leaf's leading axis is the shard length), and
``_batch_from_gathered`` turns one member's gathered (steps, batch, ...)
slice into the family's batch.  The defaults serve ``{"x", "y"}`` data; a
token-only LM federation overrides them.

The buffered schedule (``FLConfig(aggregation="buffered")``) folds banked
late updates into the FedAvg: ``cluster_round(buffered=...)`` on the
one-round path, and on the dispatch path a bank (rows, weights, gain) that
rides the block's round loop, merged into each round's FedAvg by the fedagg
kernel.  A dispatch block takes a fixed KD teacher or an (R, D_master)
stack of per-round teacher planes (the simulator's path).  ``self.obs``
(``NULL_OBS`` unless set) counts transfers, blocks and program builds and
traces the block and pack spans, as in the JAX package; it also counts the
initial draws' segments (``fl/init_draw_segments``) and the levels drawn
serially (``fl/init_draw_serial_levels``; ``core.init_draw``).

Everything runs on ``device``: ``cuda`` unless the caller asks for ``cpu``.

With ``mesh=`` (a ``launch.mesh`` mesh, one rank per process, every rank
running the same engine) the dispatch blocks shard the member axis along
``data``: each rank trains its member rows, contracts them with the fedagg
kernel and one ``all_reduce`` a round finishes the FedAvg.  A ``model``
axis of more than one rank also splits the plane, bank and teacher stacks
by columns inside the block.  With ``tp_forward=True`` (the default, as in
JAX) and a family with ``param_specs``, the planes take the tensor-parallel
layout (``core.plane.TPPlaneSpec``): each rank's column block is exactly
the leaves its slice of the model uses, and the member forward and
backward run Megatron-split over ``model`` (``models.tp``), so no plane
column is gathered inside a block.  ``tp_forward=False`` gathers the
plane's columns each round for a replicated member forward.  Between
blocks every rank holds the global plane (in the TP layout when TP), where
JAX keeps it sharded.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import aggregation, assignment as asg, clustering
from repro_torch.core import compaction, cost_model, init_draw, rounds as rnd
from repro_torch.core.client import local_update, make_cluster_update
from repro_torch.core.plane import (make_plane_spec, make_tp_plane_spec,
                                    plane_specs)
from repro_torch.core.resources import (LAMBDA_PAPER, Fleet, Participant,
                                        resource_matrix)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import device_sampler
from repro_torch.data.sampler import class_balanced_batches, sample_batches
from repro_torch.launch import sharding
from repro_torch.launch.mesh import axis_size
from repro_torch.models.tp import tp_shard_ctx
from repro_torch.obs import NULL_OBS, observing
from repro_torch.obs.trace import synchronize


@dataclass
class FLModelFamily:
    """init(generator, level) -> params on the CPU;
    loss_and_logits(level, params, batch) -> (mean loss, logits)."""
    init: Callable
    loss_and_logits: Callable
    model_bytes: Callable          # level -> bytes
    flops_per_sample: Callable     # level -> flops
    # (level, template, msize, axis) -> per-leaf {axis: dim} split specs,
    # for the tensor-parallel member forward on a 2D mesh
    param_specs: Callable | None = None


@dataclass
class FLConfig:
    alpha: float = 0.5
    kd_T: float = 2.0
    kd_alpha: float = 0.3
    E: int = 2
    local_batch: int = 16
    steps_per_round: int = 4
    lr: float = 0.05
    lam: tuple = LAMBDA_PAPER
    q_target: float = 0.05
    delta: float | None = None
    theta: float = 100.0
    # MAR time budget; None -> auto-calibrate so the master-cluster budget
    # admits roughly the fastest ~40% of participants
    mar: float | None = None
    kappa: float = 0.7
    compact_to: int | None = None
    rounds: int = 20
    seed: int = 0
    class_balanced: bool = True
    use_kd: bool = True
    # one vmapped update per cluster round; False trains members one by one
    # (the per-pid reference loop, ``_train_cluster_loop``)
    vmap_clusters: bool = True
    # let a vmap_clusters=False engine still take the dispatch path when
    # rounds_per_dispatch > 1 (the loop itself cannot be fused)
    allow_loop_dispatch: bool = False
    # round every cluster's member count up to a capacity bucket (next
    # power of two up to pad_max, then multiples of pad_max) with zero rows
    pad_clusters: bool = True
    pad_max: int = 64
    # "sync": FedAvg over this round's contributors; "buffered": banked late
    # updates join later aggregates at n * staleness_discount**age
    aggregation: str = "sync"
    staleness_discount: float = 0.6
    # >1 runs that many rounds per dispatch block on the parameter plane
    rounds_per_dispatch: int = 1
    # a dispatch block writes its final plane (and bank plane) into the
    # caller's input buffers and returns them, as the JAX package donates
    # them: the caller must not read the input expecting the old values
    donate_plane: bool = True
    # on a 2D (data x model) mesh, run the member forward tensor-parallel
    # over the model axis on a TP-layout plane (needs the family's
    # param_specs); False gathers the plane's columns for a replicated
    # forward
    tp_forward: bool = True
    consts: rnd.ConvergenceConstants = field(
        default_factory=rnd.ConvergenceConstants)


@dataclass
class DispatchOut:
    """Result of one dispatch block (``FedRAC.dispatch_rounds``)."""
    plane: torch.Tensor               # (D_pad,) fp32
    losses: torch.Tensor              # (R, C) per-round per-member losses
    bank: tuple | None                # (bank_plane, bank_w) after the block
    history: torch.Tensor | None      # (R, D_pad) per-round planes


@dataclass
class FedRACResult:
    k_optimal: int
    m: int
    di_values: dict
    labels: np.ndarray
    assignment: asg.Assignment
    history: dict            # level -> [acc per round]
    final_acc: dict          # level -> acc
    global_acc: float
    rounds_used: dict


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises (the
    engine never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


class _Program:
    """One cached round or block program and the number of times it was
    built (``FedRAC.compile_stats``).

    With observability on (``obs``), the first call is timed to the end of
    its device work and recorded as the JAX package records a compile
    (``fl/compiles/<label>``, ``fl/compile_s/<label>``, ``fl/compile_total``,
    the ``fl/compile_s`` histogram and a ``compile`` span): the port builds
    nothing ahead of time, so the first call is where a program's one-time
    cost lands (cuDNN's per-shape set-up, the first ``torch.func`` pass)."""
    __slots__ = ("fn", "builds", "_obs", "_label", "_called")

    def __init__(self, fn, obs=None, label: str = ""):
        self.fn = fn
        self.builds = 1
        self._obs = obs
        self._label = label
        self._called = False

    def __call__(self, *args):
        if self._obs is None or self._called:
            return self.fn(*args)
        self._called = True
        t0 = time.perf_counter_ns()
        out = self.fn(*args)
        synchronize(out)
        dt_ns = time.perf_counter_ns() - t0
        reg = self._obs.registry
        reg.counter(f"fl/compiles/{self._label}").inc()
        reg.gauge(f"fl/compile_s/{self._label}").set(dt_ns / 1e9)
        reg.counter("fl/compile_total").inc()
        reg.histogram("fl/compile_s").observe(dt_ns / 1e9)
        self._obs.tracer.complete("compile", t0, dt_ns, cat="fl",
                                  program=self._label)
        return out


def check_mesh_config(cfg: FLConfig, mesh) -> None:
    """The mesh contract: a mesh shards the dispatch path, so it needs
    ``rounds_per_dispatch > 1``."""
    if cfg.rounds_per_dispatch == 1:
        raise ValueError(
            "a mesh shards the device-resident dispatch path — set "
            "rounds_per_dispatch>1 (the legacy one-round path would "
            "silently ignore it)")


class FedRAC:
    def __init__(self, parts: "list[Participant] | Fleet",
                 client_data: list[dict], family: FLModelFamily,
                 cfg: FLConfig, classes: int, *, device=None, mesh=None,
                 mesh_axis: str = "data", mesh_model_axis: str = "model"):
        if cfg.aggregation not in ("sync", "buffered"):
            raise ValueError(f"unknown aggregation {cfg.aggregation!r}")
        if (cfg.rounds_per_dispatch > 1 and not cfg.vmap_clusters
                and not cfg.allow_loop_dispatch):
            raise ValueError(
                "rounds_per_dispatch>1 needs vmap_clusters=True: the per-pid "
                "loop cannot run as a dispatch block (set "
                "allow_loop_dispatch=True to route a loop-configured engine "
                "through the dispatch path anyway)")
        # a mesh: each rank holds the global plane, bank and stacks between
        # blocks, and a block works on the rank's member rows (and, with a
        # model axis of more than one rank, its column slice), one
        # all_reduce over the data axis a round
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._mesh_n = self._mesh_m = 1
        if mesh is not None:
            check_mesh_config(cfg, mesh)
            self._mesh_n = axis_size(mesh, mesh_axis)
            self._mesh_m = axis_size(mesh, mesh_model_axis)
        self.model_axis = mesh_model_axis if self._mesh_m > 1 else None
        self._pspecs = plane_specs(mesh_axis, self.model_axis)
        self.device = resolve_device(device)
        if isinstance(parts, Fleet):
            self.fleet = parts
            self.parts = parts.participants()
        else:
            self.fleet = None
            self.parts = parts
        self.client_data = client_data        # per pid: a shard pytree
        self.family = family
        self.cfg = cfg
        self.classes = classes
        # metrics registry + tracer; NULL_OBS keeps every instrumented site
        # on its single-branch no-op path
        self.obs = NULL_OBS
        self._programs = {}               # program key -> _Program
        self._plane_specs = {}            # level -> PlaneSpec
        self._draw_plans = {}             # level -> init_draw.DrawPlan
        self._init_draws = None           # the train() call's InitDraws
        self._shard_packs = {}            # (level, members, cap, bal) -> pack
        # newest pack per (level, capacity, balanced): the base of a delta
        # update when membership churns
        self._pack_prev = {}
        self._shard_len_pad = None
        self._class_m_pad = None
        self._class_tables = {}           # pid -> (table, counts)
        # the tensor-parallel member forward: a 2D mesh, tp_forward and a
        # family with per-leaf split rules (else the columns are gathered)
        self._tp = (self._mesh_m > 1 and cfg.tp_forward
                    and family.param_specs is not None)
        self._t_plane_cache = None        # (teacher pytree, its TP plane)
        if self._tp:
            self.plane_spec(0)            # the master's TP layout, up front

    # ------------------------------------------------------------ setup
    def setup(self):
        cfg = self.cfg
        V = resource_matrix(self.fleet if self.fleet is not None
                            else self.parts)
        res = clustering.optimal_clusters(V, cfg.lam, seed=cfg.seed)
        labels = clustering.order_clusters_by_resources(res.normalized,
                                                        res.labels, cfg.lam)
        self.k_optimal = res.k
        self.di_values = res.di_values
        if cfg.compact_to is not None and cfg.compact_to < res.k:
            labels = compaction.compact(labels, res.normalized,
                                        cfg.compact_to)
        self.labels = labels
        self.m = len(np.unique(labels))
        sizes = [(self.family.model_bytes(l), self.family.flops_per_sample(l))
                 for l in range(self.m)]
        mar = cfg.mar
        if mar is None:
            t_master = np.array([cost_model.round_time(
                p, sizes[0][1], sizes[0][0], cfg.E) for p in self.parts])
            mar = (float(np.percentile(t_master, 40))
                   / (cfg.kappa ** (self.m - 1)))
        self.mar = mar
        self.specs = asg.build_cluster_specs(
            sizes, cfg.consts, E=cfg.E, q_target=cfg.q_target,
            delta=cfg.delta, theta=cfg.theta, mar=mar, kappa=cfg.kappa,
            batch_size=cfg.local_batch)
        self.assignment = asg.assign(self.parts, self.specs, cfg.consts,
                                     cfg.lr)
        return self

    def update_resources(self, pid: int, *, s: float | None = None,
                         r: float | None = None, a: float | None = None):
        """§IV-A dynamic resources: update a participant's (s, r, a) and
        re-run the Procedure-2 placement.  Returns (old_level, new_level)."""
        p = self.parts[pid]
        if s is not None:
            p.s = s
        if r is not None:
            p.r = r
        if a is not None:
            p.a = a
        return asg.reassign(p, self.assignment, self.specs,
                            self.cfg.consts, self.cfg.lr)

    # ------------------------------------------------------------ data
    def _to_device(self, tree):
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), tree)

    def _member_shard(self, pid: int):
        """Hook: one member's full data shard (pytree, leading axis = n_i)
        for the dispatch path.  Subclasses with non-{"x","y"} data override
        this plus ``_batch_from_gathered``."""
        return self.client_data[pid]

    def _batch_from_gathered(self, gathered):
        """Hook: post-gather transform from one member's (steps, batch, ...)
        shard slice to the loss_fn batch format.  The block program applies
        it under ``torch.func.vmap`` over the member axis, so it sees one
        member, as in the JAX package."""
        return gathered

    def _class_table(self, pid: int):
        """Per-member class index table for balanced sampling, padded to
        the fleet-wide max class count so shapes are stable under
        Procedure-2 churn."""
        if self._class_m_pad is None:
            m = 1
            for q in range(len(self.parts)):
                y = np.asarray(self._member_shard(q)["y"])
                if y.size:
                    m = max(m, int(np.bincount(y, minlength=self.classes)
                                   .max()))
            self._class_m_pad = 1 << (m - 1).bit_length()
        if pid not in self._class_tables:
            self._class_tables[pid] = device_sampler.build_class_table(
                np.asarray(self._member_shard(pid)["y"]), self.classes,
                self._class_m_pad)
        return self._class_tables[pid]

    def _client_batches(self, pid: int, rng_round: int, balanced: bool):
        """The one-round path's host numpy stream (seed + 977 pid + round)."""
        d = self.client_data[pid]
        steps = self.cfg.steps_per_round
        seed = self.cfg.seed + 977 * pid + rng_round
        if balanced:
            return class_balanced_batches(d["x"], d["y"], self.cfg.local_batch,
                                          steps, self.classes, seed=seed)
        return sample_batches(d["x"], d["y"], self.cfg.local_batch, steps,
                              seed=seed)

    def _capacity(self, C: int) -> int:
        """Bucket a live member count to its padded capacity: next power of
        two capped at pad_max, then multiples of pad_max.  On a mesh the
        capacity is also rounded up to a multiple of the data-axis size, so
        every rank holds as many member rows; the extra rows are zero-weight
        padding like the buckets'."""
        cfg = self.cfg
        cap = C
        if cfg.pad_clusters and C > 0:
            if C >= cfg.pad_max:
                cap = -(-C // cfg.pad_max) * cfg.pad_max
            else:
                cap = min(1 << (C - 1).bit_length(), cfg.pad_max)
        if self._mesh_n > 1 and cap > 0:
            cap = -(-cap // self._mesh_n) * self._mesh_n
        return cap

    def _stacked_batches(self, members: list[int], rng_round: int,
                         level: int, capacity: int | None = None):
        """Per-member batches stacked to (capacity, steps, batch, ...) on the
        device; slots past len(members) are zero rows (they train under a
        zero step mask and zero weight)."""
        balanced = self.cfg.class_balanced and level == 0
        per = [self._client_batches(pid, rng_round, balanced)
               for pid in members]
        pad = (capacity or len(members)) - len(members)
        out = {}
        for k in per[0]:
            arr = np.stack([b[k] for b in per])
            if pad:
                arr = np.concatenate(
                    [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
            out[k] = torch.as_tensor(arr).to(self.device)
        if self.obs.on:
            self.obs.registry.counter("fl/h2d_bytes").inc(
                sum(x.nbytes for x in out.values()))
        return out

    # ------------------------------------------------------------ params
    def init_params(self, level: int):
        """A level's initial parameters, drawn from a generator seeded with
        ``seed + level`` and moved to the device.  The draw runs as segments
        of the generator's stream on host threads (``core.init_draw``), with
        the serial draw's values: queued by ``train()`` at its start, else
        here; ``init_params.draw`` is the wait for the level's tree."""
        tracer = self.obs.tracer
        with tracer.span("init_params.draw", cat="fl", level=level):
            draws = self._init_draws
            if draws is not None and level in draws:
                params, segments = draws.take(level)
            else:
                with init_draw.InitDraws(init_draw.workers()) as own:
                    self._queue_draw(own, level)
                    params, segments = own.take(level)
        if self.obs.on:
            reg = self.obs.registry
            reg.counter("fl/init_draw_segments").inc(segments)
            if segments == 1:
                reg.counter("fl/init_draw_serial_levels").inc()
        with tracer.span("init_params.to_device", cat="fl", level=level):
            return self._to_device(params)

    def _queue_draw(self, draws: "init_draw.InitDraws", level: int) -> None:
        """Queue a level's draw; its plan (shapes only) is cached."""
        if level not in self._draw_plans:
            self._draw_plans[level] = init_draw.plan_draws(self.family.init,
                                                           level)
        draws.submit(self.family.init, level, self.cfg.seed + level,
                     self._draw_plans[level])

    def plane_spec(self, level: int):
        """Flat-plane recipe of one level (cached; built from a template
        draw, whose values are not used).  On a 2D mesh D pads to a
        multiple of ``model_size × PLANE_ALIGN``, so each rank's column
        slice stays aligned for the fedagg kernel; with the TP forward it
        is the family's tensor-parallel layout (``TPPlaneSpec``)."""
        if level not in self._plane_specs:
            template = self.family.init(torch.Generator().manual_seed(0),
                                        level)
            if self._tp:
                specs = self.family.param_specs(level, template,
                                                self._mesh_m, self.model_axis)
                self._plane_specs[level] = make_tp_plane_spec(
                    template, specs, msize=self._mesh_m,
                    axis=self.model_axis)
            else:
                self._plane_specs[level] = make_plane_spec(
                    template, model_size=self._mesh_m)
        return self._plane_specs[level]

    def plane_of(self, level: int, params) -> torch.Tensor:
        """Ravel a params pytree into its (D_pad,) fp32 plane."""
        with self.obs.tracer.span("plane_of", cat="fl", level=level):
            return self.plane_spec(level).to_plane(params)

    def params_of(self, level: int, plane):
        """Unravel a plane into a params pytree (views into the plane, or
        their copies out of a TP-layout plane)."""
        with self.obs.tracer.span("params_of", cat="fl", level=level):
            return self.plane_spec(level).to_params(plane)

    # The JAX package commits planes, stacks and member rows to their mesh
    # shardings through these four.  The port's engine keeps the global
    # buffer on every rank between blocks (a block takes its rank's block
    # of each by ``plane_specs``), so each is a move to the device.
    def place_plane(self, x) -> torch.Tensor:
        """A (D,) plane on the engine's device."""
        return x.to(self.device)

    def place_plane_stack(self, x) -> torch.Tensor:
        """An (R, D) teacher or history plane stack on the device."""
        return x.to(self.device)

    def place_member_plane(self, x) -> torch.Tensor:
        """A (capacity, D) member or bank plane on the device."""
        return x.to(self.device)

    def place_member_sharded(self, x) -> torch.Tensor:
        """A member-axis array (bank weights, masks) on the device."""
        return torch.as_tensor(x).to(self.device)

    def _teacher_logits(self, teacher, batches):
        """Master logits for a (C, steps, batch, ...) batch stack: one
        forward of the master over the flattened batch."""
        lead = batches["y"].shape
        flat = {k: v.reshape(-1, *v.shape[len(lead):])
                for k, v in batches.items()}
        with torch.no_grad():
            _, logits = self.family.loss_and_logits(0, teacher, flat)
        return logits.reshape(*lead, -1)

    # ------------------------------------------------------------ one round
    def _cluster_programs(self, level: int, use_kd: bool, capacity: int,
                          want_stack: bool = False):
        """Cached whole-round program for one cluster: broadcast the shared
        params over the member axis, run every member's local steps under
        one vmap (teacher logits for slave clusters), then FedAvg.
        ``want_stack`` programs also return the per-member updated params
        (the buffered schedule's banking hook)."""
        cfg = self.cfg
        key = (level, use_kd, capacity, want_stack, cfg.lr, cfg.kd_T,
               cfg.kd_alpha)
        if key not in self._programs:
            loss_fn = partial(self.family.loss_and_logits, level)
            kw = dict(kd_T=cfg.kd_T, kd_alpha=cfg.kd_alpha) if use_kd else {}
            update = make_cluster_update(loss_fn, cfg.lr, **kw)

            def round_fn(params, batches, step_masks, weights, teacher):
                C = step_masks.shape[0]
                tracer = self.obs.tracer
                p_stack = tree_map(lambda x: x.expand(C, *x.shape), params)
                teachers = None
                if use_kd:
                    with tracer.span("teacher_forward", cat="fl"):
                        teachers = self._teacher_logits(teacher, batches)
                with tracer.span("member_update", cat="fl"):
                    new_stack, losses = update(p_stack, batches, step_masks,
                                               teachers)
                agg = aggregation.aggregate(new_stack, weights)
                if want_stack:
                    return agg, losses, new_stack
                return agg, losses

            self._programs[key] = self._program(
                round_fn, f"round_L{level}_cap{capacity}_R1"
                + ("_kd" if use_kd else "") + ("_stack" if want_stack else ""))
        return self._programs[key]

    def _program(self, fn, label: str) -> _Program:
        return _Program(fn, self.obs if self.obs.on else None, label)

    def compile_stats(self) -> dict:
        """{program key -> times built}; every key should read 1."""
        return {key: prog.builds for key, prog in self._programs.items()}

    def cluster_round(self, level: int, members: list[int], params, r: int,
                      *, teacher=None, step_masks=None, weights=None,
                      buffered=None, return_stack: bool = False):
        """One communication round for a cluster: every member's local steps
        under one vmapped update, then FedAvg.

        ``step_masks`` (C, steps) zeroes out SGD steps per member (a zero
        row leaves that member at the incoming params).  ``weights`` are raw
        non-negative aggregation weights (default n_eff), renormalized over
        the contributors; all-zero weights leave ``params`` unchanged.  The
        live C is padded to its capacity bucket with zero rows.

        ``buffered`` is a list of (params_pytree, raw_weight) banked
        contributions (already staleness-discounted); they join this round's
        FedAvg as extra members at their stale params.  ``return_stack=True``
        also returns the per-member updated params stack, the banking hook
        of the buffered schedule: the program then runs even when no live
        weight remains (a stack-only round), and a round with banked
        weight but no live weight runs no program (a bank-only round).

        Returns (new_params, member_losses[, member_params_stack])."""
        cfg = self.cfg
        C = len(members)
        if weights is None:
            weights = [self.assignment.n_eff.get(pid, 1) for pid in members]
        w = np.asarray(weights, np.float32)
        buffered = list(buffered) if buffered else []
        u = np.asarray([bw for _, bw in buffered], np.float32)
        total = float(w.sum()) + float(u.sum())
        if total <= 0.0 and not return_stack:
            # everyone dropped: partial aggregation is a no-op
            return params, torch.zeros(C, device=self.device)
        cap = self._capacity(C)
        run_program = float(w.sum()) > 0.0 or return_stack
        stack = None
        denom = total if total > 0.0 else 1.0
        if run_program:
            batches = self._stacked_batches(members, r, level, cap)
            steps = batches["y"].shape[1]
            masks = np.zeros((cap, steps), np.float32)
            masks[:C] = (1.0 if step_masks is None
                         else np.asarray(step_masks, np.float32))
            w_pad = np.zeros(cap, np.float32)
            w_pad[:C] = w / denom
            use_kd = teacher is not None and cfg.use_kd
            round_fn = self._cluster_programs(level, use_kd, cap,
                                              want_stack=return_stack)
            out = round_fn(params, batches,
                           torch.as_tensor(masks).to(self.device),
                           torch.as_tensor(w_pad).to(self.device), teacher)
            partial_p, losses = out[0], out[1]
            if return_stack:
                stack = out[2]
        else:                           # only banked updates contribute
            partial_p = tree_map(torch.zeros_like, params)
            losses = torch.zeros(cap, device=self.device)
        if total <= 0.0:                # stack-only round: aggregate no-op
            return params, losses[:C], stack
        if buffered:
            partial_p = aggregation.merge_buffered(
                partial_p, [p for p, _ in buffered], u / total)
        losses = losses[:C]
        return ((partial_p, losses, stack) if return_stack
                else (partial_p, losses))

    # ------------------------------------------------------------ dispatch
    def _delta_shards(self, level: int, members: list[int], capacity: int,
                      balanced: bool):
        """Delta shard-pack update on membership churn: when a previous pack
        exists at the same (level, capacity, balanced) signature, surviving
        member rows are permuted on the device (one gather and a row mask)
        and only new members' shards are copied from the host, so a
        Procedure-2 migration of one participant moves one row, not the
        whole (capacity, N_pad, ...) stack.  Returns the new shards tree and
        the bytes copied, or None when a full build is better (no base
        pack, more than half the rows new, or a mesh: a rank holds only its
        rows of the base)."""
        prev = self._pack_prev.get((level, capacity, balanced))
        if prev is None or self.mesh is not None:
            return None
        prev_members, prev_shards = prev
        pos = {pid: i for i, pid in enumerate(prev_members)}
        src = np.zeros(capacity, np.int64)
        keep = np.zeros(capacity, bool)
        fresh = []
        for i, pid in enumerate(members):
            j = pos.get(pid)
            if j is None:
                fresh.append(i)
            else:
                src[i] = j
                keep[i] = True
        if len(fresh) > max(1, len(members) // 2):
            return None
        src_d = torch.as_tensor(src, device=self.device)
        keep_d = torch.as_tensor(keep, device=self.device)

        def permute(a):
            g = a[src_d]
            mask = keep_d.reshape((capacity,) + (1,) * (g.dim() - 1))
            return torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                                    device=g.device))

        shards = tree_map(permute, prev_shards)
        moved = 0
        if fresh:
            host_rows = tree_map(
                lambda *xs: _padded_rows(xs, len(fresh), self._shard_len_pad),
                *[self._member_shard(members[i]) for i in fresh])
            idx = torch.as_tensor(np.asarray(fresh), device=self.device)
            shards = tree_map(
                lambda a, f: a.index_copy(
                    0, idx, torch.as_tensor(f).to(self.device)),
                shards, host_rows)
            moved = sum(x.nbytes for x in tree_leaves(host_rows))
        return shards, moved

    def _shard_pack(self, level: int, members: list[int], capacity: int,
                    balanced: bool):
        """Device-resident member data for the dispatch path: every
        member's full shard stacked to (capacity, N_pad, ...) once (padded
        rows are zeros and never drawn), plus host copies of the lengths
        and, for balanced levels, the class tables the draws need.  N_pad
        and the table width are fleet-wide powers of two, so shapes do not
        change with membership.  Under churn the shards come from the
        previous pack of the same signature (``_delta_shards``).  On a
        mesh the device holds only this rank's member rows; the lengths and
        class tables stay global, since every rank draws for every slot and
        keeps its own (``_local_rows``)."""
        key = (level, tuple(members), capacity, balanced)
        if key in self._shard_packs:
            pack = self._shard_packs.pop(key)      # LRU: refresh on hit
            self._shard_packs[key] = pack
            return pack
        t0 = time.perf_counter_ns()
        if self._shard_len_pad is None:
            n_max = max(max((_shard_len(self._member_shard(q))
                             for q in range(len(self.parts))), default=1), 1)
            self._shard_len_pad = 1 << (n_max - 1).bit_length()
        N = self._shard_len_pad
        shards = [self._member_shard(pid) for pid in members]
        delta = self._delta_shards(level, members, capacity, balanced)
        if delta is not None:
            packed, nbytes = delta
        else:
            packed = tree_map(lambda *xs: torch.as_tensor(np.array(
                self._local_rows(_padded_rows(xs, capacity, N)))
            ).to(self.device), *shards)
            nbytes = sum(x.nbytes for x in tree_leaves(packed))
        n = np.zeros(capacity, np.int64)
        n[:len(members)] = [_shard_len(s) for s in shards]
        pack = {"shards": packed, "n": n, "tables": None, "counts": None}
        if balanced and members:
            self._class_table(members[0])              # sizes _class_m_pad
            tables = np.zeros((capacity, self.classes, self._class_m_pad),
                              np.int32)
            counts = np.zeros((capacity, self.classes), np.int32)
            for i, pid in enumerate(members):
                tables[i], counts[i] = self._class_table(pid)
            pack["tables"], pack["counts"] = tables, counts
        if len(self._shard_packs) >= 16:               # bound device memory
            self._shard_packs.pop(next(iter(self._shard_packs)))
        self._shard_packs[key] = pack
        if self.mesh is None:
            self._pack_prev[(level, capacity, balanced)] = (tuple(members),
                                                            packed)
        if self.obs.on:
            # the shards are the pack's only device copy: lengths and class
            # tables stay on the host, where the draws are made
            reg = self.obs.registry
            reg.counter("fl/h2d_bytes").inc(nbytes)
            reg.counter("fl/pack_builds").inc()
            if delta is not None:
                reg.counter("fl/pack_delta").inc()
            self.obs.tracer.complete(
                "pack_h2d", t0, time.perf_counter_ns() - t0, cat="fl",
                level=level, bytes=nbytes, delta=delta is not None)
        return pack

    def _local_rows(self, x):
        """This rank's member rows of a global (capacity, ...) array (the
        whole array off a mesh)."""
        if self.mesh is None:
            return x
        return sharding.local_block(self.mesh, x, self._pspecs["rows"])

    def _draw_indices(self, pack, r: int, balanced: bool) -> np.ndarray:
        """(capacity, steps, batch) sample indices of round ``r`` for every
        member slot of ``pack``.  The hook parity tests override to inject
        another stream."""
        cfg = self.cfg
        if balanced:
            return device_sampler.balanced_indices(
                cfg.seed, r, cfg.steps_per_round, cfg.local_batch,
                pack["tables"], pack["counts"])
        return device_sampler.uniform_indices(
            cfg.seed, r, cfg.steps_per_round, cfg.local_batch, pack["n"])

    def _dispatch_programs(self, level: int, use_kd: bool, capacity: int,
                           R: int, balanced: bool, banked: bool,
                           want_history: bool, t_per_round: bool = False):
        """Cached block program: R communication rounds.  Each round gathers
        every member's batches from the device-resident shards by the
        block's pre-drawn indices (through ``_batch_from_gathered``, per
        member), runs the teacher forward on them for a KD cluster, then
        the vmapped member update from the plane's parameters, and
        aggregates the (capacity, D_pad) member plane with the fedagg
        kernel (on a CUDA plane).  A round whose weights sum to zero leaves
        the plane unchanged.

        ``banked`` programs carry the buffered schedule's bank through the
        rounds: each round merges the previous round's bank rows (weights
        already staleness-discounted) into its FedAvg with a second fedagg
        contraction, then re-banks this round's member rows at
        ``bank_gain``.  ``t_per_round`` programs take an (R, D_master)
        stack of teacher planes, round j's teacher being its row j, instead
        of one fixed teacher.

        On a mesh every input arrives global and each rank works on its
        block of it (``plane_specs``): its member rows of the masks,
        weights, indices and bank (the shard pack holds only those rows),
        and, on a 2D mesh, its column slice of the plane, bank and teacher
        stack.  Each round gathers the plane's (and the round teacher's)
        columns along ``model`` for a replicated member forward, keeps its
        column slice of the updated member rows, contracts its (rows ×
        columns) block with the fedagg kernel and sums it over ``data``
        with one ``all_reduce``; the round's weight total comes from the
        global weight vectors, so it is the unsharded program's.  The
        block's outputs are gathered back to global tensors at its end.

        With the TP forward the column slice of a TP-layout plane is the
        rank's chunk: its member stack comes from ``local_params`` (the
        teacher's too), the update runs Megatron-split inside
        ``tp_shard_ctx``, and ``local_to_chunk`` writes the (C/n, d_loc)
        rows back for fedagg.  Nothing is gathered over ``model`` inside
        the block but the forward's own activations."""
        cfg = self.cfg
        key = ("dispatch", level, use_kd, capacity, R, balanced, banked,
               want_history, t_per_round, cfg.lr, cfg.kd_T, cfg.kd_alpha,
               cfg.seed, cfg.steps_per_round, cfg.local_batch)
        if key in self._programs:
            return self._programs[key]
        loss_fn = partial(self.family.loss_and_logits, level)
        kw = dict(kd_T=cfg.kd_T, kd_alpha=cfg.kd_alpha) if use_kd else {}
        update = make_cluster_update(loss_fn, cfg.lr, **kw)
        spec = self.plane_spec(level)
        mesh, axis, maxis, sp = (self.mesh, self.mesh_axis, self.model_axis,
                                 self._pspecs)
        tp = self._tp
        t_spec = self.plane_spec(0) if tp and use_kd else None

        def local(x, split):
            """This rank's block of a global block input."""
            if mesh is None:
                return x
            return sharding.local_block(mesh, x, split)

        def gathered(x, split):
            """The global tensor of a block output."""
            if mesh is None:
                return x
            return sharding.gather_block(mesh, x, split)

        def gather_cols(plane_loc):
            """This rank's column slice of a plane -> the whole plane."""
            if maxis is None:
                return plane_loc
            return sharding.all_gather(mesh, plane_loc, maxis, 0)

        def local_cols(member_plane):
            """(C, D_pad) member rows -> this rank's (C, D_pad/m) slice."""
            if maxis is None:
                return member_plane
            return sharding.local_block(mesh, member_plane,
                                        {maxis: 1}).contiguous()

        def member_params(g):
            """This rank's column block of the plane -> the params its
            member forward takes."""
            if tp:
                return spec.local_params(g)
            return spec.to_params(gather_cols(g))

        def member_block(new_stack):
            """Updated (C, ...) member params -> this rank's (C, D_pad/m)
            block of the member plane."""
            if tp:
                return spec.local_to_chunk(new_stack)
            return local_cols(spec.to_plane(new_stack))

        def teacher_params(t):
            """A teacher plane's column block -> the teacher's params."""
            if tp:
                return t_spec.local_params(t)
            return self.params_of(0, gather_cols(t))

        def one_round(g, bank_p, bank_w, total, idx, shards, step_masks,
                      weights, teacher):
            # ranges that label the round's device work: never fenced
            tracer = self.obs.tracer
            C = step_masks.shape[0]
            rows = torch.arange(C, device=g.device)[:, None, None]
            batches = vmap(self._batch_from_gathered)(
                tree_map(lambda v: v[rows, idx], shards))
            params = member_params(g)
            p_stack = tree_map(lambda x: x.expand(C, *x.shape), params)
            teachers = None
            if use_kd:
                with tracer.span("teacher_forward", cat="fl"):
                    teachers = self._teacher_logits(teacher, batches)
            with tracer.span("member_update", cat="fl"):
                new_stack, losses = update(p_stack, batches, step_masks,
                                           teachers)
            new_plane = member_block(new_stack)           # (C, D_pad/m)
            denom = torch.where(total > 0.0, total, torch.ones_like(total))
            agg = aggregation.aggregate_plane(new_plane, weights / denom)
            if banked:
                agg = aggregation.merge_buffered_plane(agg, bank_p,
                                                       bank_w / denom)
            if mesh is not None:
                agg = sharding.all_reduce(mesh, agg, axis)
            # the member plane lives on only as the next round's bank: a
            # block without one frees it here, not a round later
            return (torch.where(total > 0.0, agg, g),
                    new_plane if banked else None, losses)

        def block_fn(plane, shards, idx, step_masks, weights, teacher, bank):
            w_total = weights.sum()
            g = local(plane, sp["plane"])
            idx = local(idx, {axis: 1})           # (R, capacity, steps, B)
            step_masks = local(step_masks, sp["masks"])
            weights = local(weights, sp["rows"])
            if t_per_round:
                teacher = local(teacher, sp["stack"])
            elif tp and use_kd:            # a fixed teacher as a TP plane
                teacher = t_spec.local_params(local(teacher, sp["plane"]))
            bank_p = bank_w = bank_gain = None
            if banked:
                bank_p, bank_w, bank_gain = bank
                totals = (w_total + bank_w.sum(), w_total + bank_gain.sum())
                bank_p = local(bank_p, sp["members"]).contiguous()
                bank_w = local(bank_w, sp["rows"])
                bank_gain = local(bank_gain, sp["rows"])
            losses, history = [], []
            with tp_shard_ctx(mesh, maxis) if tp else nullcontext():
                for i in range(R):
                    t = teacher_params(teacher[i]) if t_per_round else teacher
                    total = totals[min(i, 1)] if banked else w_total
                    g, rows, l = one_round(g, bank_p, bank_w, total, idx[i],
                                           shards, step_masks, weights, t)
                    if banked:
                        bank_p, bank_w = rows, bank_gain
                    del rows
                    losses.append(l)
                    if want_history:
                        history.append(g)
            return (gathered(g, sp["plane"]),
                    (gathered(bank_p, sp["members"]), bank[2]) if banked
                    else None,
                    gathered(torch.stack(losses), sp["losses"]),
                    gathered(torch.stack(history), sp["stack"])
                    if want_history else None)

        self._programs[key] = self._program(
            block_fn, f"dispatch_L{level}_cap{capacity}_R{R}"
            + ("_kd" if use_kd else "") + ("_bank" if banked else ""))
        return self._programs[key]

    def dispatch_rounds(self, level: int, members: list[int], plane,
                        r0: int, n_rounds: int, *, teacher=None,
                        teacher_planes=None, step_masks=None, weights=None,
                        bank=None, want_history: bool = False) -> DispatchOut:
        """Run rounds r0 .. r0 + n_rounds - 1 of one cluster as one block.

        ``plane`` is the cluster's (D_pad,) parameter plane; with
        ``donate_plane`` the block writes its result into it (and into the
        bank plane) and returns it, so the caller must not expect the old
        values there.  ``bank`` is the buffered schedule's carry
        ``(bank_plane (cap, D_pad), bank_w (cap,), bank_gain (cap,))``:
        rows merged into the first round at ``bank_w``, each round's member
        updates re-banked at ``bank_gain`` (zero = not banked).  The KD
        teacher is either ``teacher`` (one params pytree, fixed for the
        block, as in ``train``, whose master is fully trained first) or
        ``teacher_planes`` (an (n_rounds, D_master) stack, one teacher per
        round: the simulator's path, where the master co-trains).
        ``weights`` (raw) and ``step_masks`` may come pre-padded to the
        capacity as device tensors.  Returns per-round member losses, the
        bank after the block, and, with ``want_history``, the per-round
        planes."""
        cfg = self.cfg
        C = len(members)
        with self.obs.tracer.span("dispatch.prepare", cat="fl",
                                  level=level):
            cap, prog, args, h2d = self._prepare_block(
                level, members, r0, n_rounds, teacher, teacher_planes,
                weights, step_masks, bank, want_history)
        banked, bank = bank is not None, args[-1]
        with self.obs.tracer.span("block_exec", cat="fl", level=level,
                                  R=n_rounds, capacity=cap, members=C):
            new_plane, bank_out, losses, history = prog(plane, *args)
            if cfg.donate_plane:
                new_plane = plane.copy_(new_plane)
                if banked:
                    bank_out = (bank[0].copy_(bank_out[0]), bank_out[1])
            self.obs.tracer.fence(new_plane)
        losses = losses[:, :C]
        if self.obs.on:
            reg = self.obs.registry
            reg.counter("fl/dispatch_blocks").inc()
            reg.counter("fl/dispatch_rounds").inc(n_rounds)
            reg.counter("fl/h2d_bytes").inc(h2d)
            # per-round member losses are the block's host-bound output
            reg.counter("fl/d2h_bytes").inc(
                losses.numel() * losses.element_size())
            if self.mesh is not None:
                # one all_reduce over the data axis per round
                reg.counter("fl/psum_count").inc(n_rounds)
        return DispatchOut(plane=new_plane, losses=losses, bank=bank_out,
                           history=history)

    def _prepare_block(self, level, members, r0, n_rounds, teacher,
                       teacher_planes, weights, step_masks, bank,
                       want_history):
        """The host work of ``dispatch_rounds`` before its block is
        enqueued: the shard pack, the index draws, and the masks, weights
        and indices padded to the capacity on the device.  Returns the
        capacity, the block program, its arguments after the plane and the
        bytes copied to the device."""
        cfg = self.cfg
        C = len(members)
        cap = self._capacity(C)
        balanced = cfg.class_balanced and level == 0
        use_kd = cfg.use_kd and (teacher is not None
                                 or teacher_planes is not None)
        t_per_round = use_kd and teacher_planes is not None
        if t_per_round and teacher_planes.shape[0] != n_rounds:
            raise ValueError(
                f"teacher_planes carries {teacher_planes.shape[0]} rounds "
                f"for a {n_rounds}-round block")
        banked = bank is not None
        pack = self._shard_pack(level, members, cap, balanced)
        S = cfg.steps_per_round
        h2d = 0
        if isinstance(weights, torch.Tensor) and weights.shape == (cap,):
            w = weights
        else:
            if weights is None:
                weights = [self.assignment.n_eff.get(pid, 1)
                           for pid in members]
            w = np.zeros(cap, np.float32)
            w[:C] = np.asarray(weights, np.float32)
            h2d += w.nbytes
            w = torch.as_tensor(w).to(self.device)
        if (isinstance(step_masks, torch.Tensor)
                and step_masks.shape == (cap, S)):
            masks = step_masks
        else:
            masks = np.zeros((cap, S), np.float32)
            masks[:C] = (1.0 if step_masks is None
                         else np.asarray(step_masks, np.float32))
            h2d += masks.nbytes
            masks = torch.as_tensor(masks).to(self.device)
        prog = self._dispatch_programs(level, use_kd, cap, n_rounds,
                                       balanced, banked, want_history,
                                       t_per_round=t_per_round)
        idx = np.stack([self._draw_indices(pack, r, balanced)
                        for r in range(r0, r0 + n_rounds)])
        h2d += idx.nbytes
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        t_arg = (teacher_planes if t_per_round
                 else teacher if use_kd else None)
        if use_kd and not t_per_round and self._tp:
            # the TP block takes a fixed teacher as a TP-layout plane,
            # converted once per teacher pytree
            if (self._t_plane_cache is None
                    or self._t_plane_cache[0] is not teacher):
                self._t_plane_cache = (teacher, self.plane_of(0, teacher))
            t_arg = self._t_plane_cache[1]
        if banked:
            bank = (bank[0], bank[1],
                    torch.as_tensor(bank[2], dtype=torch.float32
                                    ).to(self.device))
        return cap, prog, (pack["shards"], idx, masks, w, t_arg, bank), h2d

    # ------------------------------------------------------------ training
    def _train_cluster(self, level: int, members: list[int], n_rounds: int,
                       test, teacher=None, record_every: int = 1):
        cfg = self.cfg
        params = self.init_params(level)
        if not members:
            return params, []
        if not cfg.vmap_clusters and not (cfg.allow_loop_dispatch
                                          and cfg.rounds_per_dispatch > 1):
            return self._train_cluster_loop(level, members, n_rounds, test,
                                            params, teacher, record_every)
        if cfg.rounds_per_dispatch > 1:
            return self._train_cluster_dispatch(level, members, n_rounds,
                                                test, params, teacher,
                                                record_every)
        history = []
        weights = [self.assignment.n_eff.get(pid, 1) for pid in members]
        for r in range(n_rounds):
            params, _ = self.cluster_round(level, members, params, r,
                                           teacher=teacher, weights=weights)
            if (r + 1) % record_every == 0:
                history.append(self.evaluate(level, params, test))
        return params, history

    def _train_cluster_dispatch(self, level: int, members: list[int],
                                n_rounds: int, test, params, teacher=None,
                                record_every: int = 1):
        """Chunk ``n_rounds`` into blocks of ``rounds_per_dispatch`` rounds;
        the per-round history stays exact through the block's per-round
        planes when a record boundary falls inside a block."""
        cfg = self.cfg
        R = cfg.rounds_per_dispatch
        plane = self.plane_of(level, params)
        # masks and weights are the same for every block: pad them once
        cap = self._capacity(len(members))
        weights = np.zeros(cap, np.float32)
        weights[:len(members)] = [self.assignment.n_eff.get(pid, 1)
                                  for pid in members]
        weights = torch.as_tensor(weights).to(self.device)
        masks = torch.zeros((cap, cfg.steps_per_round), device=self.device)
        masks[:len(members)] = 1.0
        history = []
        r = 0
        while r < n_rounds:
            L = min(R, n_rounds - r)
            rec = [rr for rr in range(r, r + L)
                   if (rr + 1) % record_every == 0]
            want_hist = any(rr != r + L - 1 for rr in rec)
            out = self.dispatch_rounds(level, members, plane, r, L,
                                       teacher=teacher, step_masks=masks,
                                       weights=weights,
                                       want_history=want_hist)
            plane = out.plane
            for rr in rec:
                p = self.params_of(level, out.history[rr - r] if want_hist
                                   else plane)
                history.append(self.evaluate(level, p, test))
            r += L
        return self.params_of(level, plane), history

    def _train_cluster_loop(self, level: int, members: list[int],
                            n_rounds: int, test, params, teacher=None,
                            record_every: int = 1):
        """Reference per-pid loop (``vmap_clusters=False``): each member's
        local steps run on its own from the one-round path's host batches,
        then the FedAvg over the members."""
        cfg = self.cfg
        loop_key = ("loop", level, cfg.lr, cfg.kd_T, cfg.kd_alpha)
        if loop_key not in self._programs:
            loss_fn = partial(self.family.loss_and_logits, level)
            self._programs[loop_key] = _Program(
                (partial(local_update, loss_fn, lr=cfg.lr, kd_T=cfg.kd_T,
                         kd_alpha=cfg.kd_alpha),
                 partial(local_update, loss_fn, lr=cfg.lr)))
        upd, upd_plain = self._programs[loop_key].fn
        use_kd = teacher is not None and cfg.use_kd
        balanced = cfg.class_balanced and level == 0
        history = []
        weights = aggregation.normalized_weights(
            [self.assignment.n_eff.get(pid, 1) for pid in members],
            device=self.device)
        for r in range(n_rounds):
            new_params = []
            for pid in members:
                batches = self._to_device(
                    self._client_batches(pid, r, balanced))
                if use_kd:
                    tl = self._teacher_logits(teacher, batches)
                    p_new, _ = upd(params, batches, teacher_logits=tl)
                else:
                    p_new, _ = upd_plain(params, batches)
                new_params.append(p_new)
            stack = tree_map(lambda *xs: torch.stack(xs), *new_params)
            params = aggregation.aggregate(stack, weights)
            if (r + 1) % record_every == 0:
                history.append(self.evaluate(level, params, test))
        return params, history

    def evaluate(self, level: int, params, test) -> float:
        with self.obs.tracer.span("evaluate", cat="fl", level=level):
            test = self._to_device(test)
            with torch.no_grad():
                _, logits = self.family.loss_and_logits(level, params, test)
            return float((torch.argmax(logits, -1) == test["y"]).float()
                         .mean())

    def train(self, test, rounds_per_cluster: dict | None = None
              ) -> FedRACResult:
        """Train the master, then each slave with members.  Their initial
        draws are queued on host threads first, so a slave's draw runs
        behind the master's training; nothing drawn outlives the call.
        ``self.obs`` is current (``obs.current``) for the call, so that
        model code can open spans and count (the MoE layer does)."""
        members = self.assignment.members
        self._init_draws = init_draw.InitDraws(init_draw.workers())
        try:
            for level in range(self.m):
                if level == 0 or members.get(level):
                    self._queue_draw(self._init_draws, level)
            with observing(self.obs):
                return self._train(test, rounds_per_cluster)
        finally:
            self._init_draws.close()
            self._init_draws = None

    def _train(self, test, rounds_per_cluster: dict | None) -> FedRACResult:
        cfg = self.cfg
        test = self._to_device(test)
        members = self.assignment.members
        n_rounds = {l: (rounds_per_cluster or {}).get(l, cfg.rounds)
                    for l in range(self.m)}
        tracer = self.obs.tracer
        with tracer.span("cluster", cat="fl", level=0,
                         members=len(members.get(0, []))):
            master_params, hist0 = self._train_cluster(
                0, members.get(0, []), n_rounds[0], test)
        history = {0: hist0}
        final = {0: hist0[-1] if hist0 else 0.0}
        self.master_params = master_params
        self.cluster_params = {0: master_params}
        for level in range(1, self.m):
            mem = members.get(level, [])
            if not mem:
                history[level] = []
                final[level] = float("nan")
                continue
            with tracer.span("cluster", cat="fl", level=level,
                             members=len(mem)):
                p, h = self._train_cluster(level, mem, n_rounds[level],
                                           test, teacher=master_params)
            history[level] = h
            final[level] = h[-1] if h else 0.0
            self.cluster_params[level] = p
        accs = [a for a in final.values() if a == a]
        return FedRACResult(
            k_optimal=self.k_optimal, m=self.m, di_values=self.di_values,
            labels=self.labels, assignment=self.assignment, history=history,
            final_acc=final, global_acc=float(np.mean(accs)),
            rounds_used=n_rounds)


def _padded_rows(shards, rows: int, n_pad: int) -> np.ndarray:
    """Stack member shards (leading axis = shard length) into one
    zero-padded (rows, n_pad, ...) array."""
    first = np.asarray(shards[0])
    out = np.zeros((rows, n_pad) + first.shape[1:], first.dtype)
    for i, x in enumerate(shards):
        x = np.asarray(x)
        out[i, :x.shape[0]] = x
    return out


def _shard_len(shard) -> int:
    """A shard's length: the leading axis of its first leaf."""
    return int(np.asarray(tree_leaves(shard)[0]).shape[0])


def rounds_to_reach(history: list[float], target: float) -> int | None:
    for i, a in enumerate(history):
        if a >= target:
            return i + 1
    return None
