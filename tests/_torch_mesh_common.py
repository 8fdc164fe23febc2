"""Shared set-up of the port's mesh tests (``test_torch_mesh*.py``): running
a function on a world of gloo ranks, and the rank-side halves of the tests.

``run_world`` starts one process per rank (``torch.multiprocessing``'s
spawn), rendezvouses them through a file under the test's ``tmp_path`` (no
fixed port, so parallel test workers never collide) and returns every
rank's result.  Each rank runs torch on one thread.  This module imports
neither JAX nor the JAX package, so the ranks start with torch alone.
"""
import os
import pickle

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch import interop
from repro_torch.core import aggregation, server as t_srv
from repro_torch.core.families import mlp_family
from repro_torch.core.plane import make_plane_spec
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification, train_test_split
from repro_torch.launch import mesh as mesh_lib

WORLD = 8
MESHES = ("8", "4x2")


def run_world(fn, tmp_path, *args, world: int = WORLD):
    """[fn(rank, *args) for every rank], each rank a process in one gloo
    world."""
    return start_world(fn, tmp_path, *args, world=world)()


def start_world(fn, tmp_path, *args, world: int = WORLD):
    """``run_world`` without waiting: starts the ranks and returns a
    function that waits for them and returns their results."""
    tmp_path = str(tmp_path)
    ctx = mp.spawn(_entry, args=(fn, world, f"file://{tmp_path}/rendezvous",
                                 tmp_path, args), nprocs=world, join=False)

    def results():
        while not ctx.join():
            pass
        out = []
        for r in range(world):
            with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    return results


def _entry(rank, fn, world, init_method, out_dir, args):
    torch.set_num_threads(1)
    mesh_lib.init_world(rank, world, init_method, "gloo")
    try:
        res = fn(rank, *args)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


class FedaggShapes:
    """Records the (rows, columns) of every plane this process hands the
    fedagg route (``aggregation.aggregate_plane``)."""

    def __init__(self):
        self.shapes = []
        self._orig = aggregation.aggregate_plane

    def __enter__(self):
        def rec(plane, weights):
            self.shapes.append(tuple(plane.shape))
            return self._orig(plane, weights)
        aggregation.aggregate_plane = rec
        return self

    def __exit__(self, *exc):
        aggregation.aggregate_plane = self._orig


# ------------------------------------------------------------ the ops
def op_inputs(C: int, D: int, seed: int):
    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((C, D)).astype(np.float32)
    w = np.arange(1, C + 1, dtype=np.float32)
    stack = {"w": rng.standard_normal((C, 33)).astype(np.float32),
             "b": rng.standard_normal((C, 5, 3)).astype(np.float32)}
    return plane, w / w.sum(), stack


def ops_rank(rank, cases):
    """Every sharded op on both meshes at every (C, D) case; the rank's
    results and the shapes it handed fedagg, per (mesh, case)."""
    out = {}
    for shape in MESHES:
        mesh = mesh_lib.make_sim_mesh(shape)
        maxis = "model" if mesh_lib.axis_size(mesh, "model") > 1 else None
        for C, D, seed in cases:
            plane, w, stack = op_inputs(C, D, seed)
            plane, w = torch.tensor(plane), torch.tensor(w)
            g = plane[0]
            with FedaggShapes() as rec:
                agg = aggregation.aggregate_plane_sharded(
                    mesh, plane, w, model_axis=maxis)
            res = {"aggregate": agg.numpy(), "shapes": rec.shapes,
                   "delta": aggregation.fedavg_delta_plane_sharded(
                       mesh, g, plane, w, model_axis=maxis).numpy(),
                   "merge": aggregation.merge_buffered_plane_sharded(
                       mesh, agg * 0.5, plane, w * 0.5,
                       model_axis=maxis).numpy(),
                   "zero_delta": aggregation.fedavg_delta_plane_sharded(
                       mesh, g, plane, torch.zeros(C),
                       model_axis=maxis).numpy(),
                   "tree": {k: v.numpy() for k, v in
                            aggregation.aggregate_sharded(
                                mesh, interop.params_from_numpy(stack),
                                w).items()}}
            out[(shape, C, D)] = res
    out["data_axes"] = mesh_lib.data_axes(mesh)
    # a mesh shards the dispatch path: without dispatch blocks it is refused
    try:
        t_srv.FedRAC([], [], mlp_family(), t_srv.FLConfig(), classes=10,
                     device="cpu", mesh=mesh_lib.make_sim_mesh(8))
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


# ------------------------------------------------------------ federations
SEED, N_PART = 3, 10
CFG = dict(steps_per_round=2, local_batch=8, lr=0.08, seed=SEED,
           compact_to=2, rounds=4, rounds_per_dispatch=2)


def federation():
    """10 Table-III participants on synth-mnist, Dirichlet(1.0)."""
    ds = make_classification("synth-mnist", 500, seed=SEED)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, N_PART, alpha=1.0, seed=SEED)
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_PART)]
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return V, [len(p) for p in idx], cd, {"x": test.x, "y": test.y}


class InjectedFedRAC(t_srv.FedRAC):
    """Port engine with given initial parameters ({level: numpy tree}) and
    batch-index draws ({(level, round): (members, steps, batch)}), so a
    mesh run and the runs it is held against train from the same draws."""
    init_trees: dict = {}
    draws: dict = {}

    def init_params(self, level):
        return interop.params_from_numpy(self.init_trees[level], self.device)

    def _shard_pack(self, level, members, capacity, balanced):
        pack = super()._shard_pack(level, members, capacity, balanced)
        pack["level"] = level
        return pack

    def _draw_indices(self, pack, r, balanced):
        d = self.draws[(pack["level"], r)]
        out = np.zeros((len(pack["n"]),) + d.shape[1:], d.dtype)
        out[:len(d)] = d
        return out


def make_engine(cls, aggregation_kind, mesh=None, **extra):
    V, n_data, cd, test = federation()
    cfg = t_srv.FLConfig(**dict(CFG, aggregation=aggregation_kind, **extra))
    eng = cls(participants_from_matrix(V, n_data=n_data), cd, mlp_family(),
              cfg, classes=10, device="cpu", mesh=mesh).setup()
    return eng, test


def _padded(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in np.shape(x))] = x
    return out


def scenario(eng, test, inputs: dict, kind: str) -> dict:
    """The run every engine is held to, with results cut to the true
    member count and plane length: ``train()`` for "sync"; for "buffered",
    an R = 2 banked block per level (rows entering the bank, member 0
    re-banked every round, the slave on a per-round teacher stack)."""
    out = {}
    if kind == "sync":
        res = eng.train(test)
        for lvl, p in eng.cluster_params.items():
            out[("plane", lvl)] = eng.plane_of(lvl, p)[
                :eng.plane_spec(lvl).d].numpy()
        out["history"] = res.history
        return out
    for lvl in (0, 1):
        members = eng.assignment.members[lvl]
        C, cap = len(members), eng._capacity(len(members))
        spec = eng.plane_spec(lvl)
        kw = {}
        if lvl:
            d0 = eng.plane_spec(0).d_pad
            kw["teacher_planes"] = torch.tensor(
                _padded(inputs["teacher"], (2, d0)))
        o = eng.dispatch_rounds(
            lvl, members, torch.tensor(_padded(inputs["plane", lvl],
                                               (spec.d_pad,))), 0, 2,
            weights=inputs["weights", lvl],
            bank=(torch.tensor(_padded(inputs["rows", lvl],
                                       (cap, spec.d_pad))),
                  torch.tensor(_padded(inputs["bank_w", lvl], (cap,))),
                  torch.tensor(_padded(inputs["gain", lvl], (cap,)))),
            want_history=True, **kw)
        out[("plane", lvl)] = o.plane[:spec.d].numpy()
        out[("losses", lvl)] = o.losses.numpy()
        out[("history", lvl)] = o.history[:, :spec.d].numpy()
        out[("bank", lvl)] = o.bank[0][:C, :spec.d].numpy()
        out[("bank_w", lvl)] = o.bank[1][:C].numpy()
    return out


def fedrac_rank(rank, init_trees, draws, inputs):
    """Every (mesh, aggregation) case of the federation on this rank, with
    the shapes each case handed fedagg."""
    InjectedFedRAC.init_trees, InjectedFedRAC.draws = init_trees, draws
    out = {}
    for shape in MESHES:
        mesh = mesh_lib.make_sim_mesh(shape)
        for kind in ("sync", "buffered"):
            eng, test = make_engine(InjectedFedRAC, kind, mesh=mesh,
                                    tp_forward=False)
            with FedaggShapes() as rec:
                res = scenario(eng, test, inputs, kind)
            res["fedagg"] = rec.shapes
            res["capacity"] = {lvl: eng._capacity(len(m)) for lvl, m in
                               eng.assignment.members.items()}
            res["d_pad"] = {lvl: eng.plane_spec(lvl).d_pad
                            for lvl in eng.assignment.members}
            out[(shape, kind)] = res
        # the tensor-parallel forward on a 2D mesh: train() on TP-layout
        # planes, the results in the unsharded layout
        if mesh_lib.axis_size(mesh, "model") > 1:
            eng, test = make_engine(InjectedFedRAC, "sync", mesh=mesh,
                                    tp_forward=True)
            res = eng.train(test)
            out["tp"] = {("plane", lvl): make_plane_spec(p).to_plane(p)[
                :eng.plane_spec(lvl).d].numpy()
                for lvl, p in eng.cluster_params.items()}
            out["tp"]["history"] = res.history
            out["tp_forward"] = eng._tp
    return out
