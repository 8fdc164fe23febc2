"""FedAvg aggregation of client-stacked weights (§III-B).

``aggregate`` is the pytree form the one-round path uses; the ``*_plane``
forms work on the dispatch path's flat ``(C, D)`` parameter plane, where the
contraction is the fedagg kernel on a CUDA tensor and its plain version on a
CPU tensor.  Every op has a zero-total guard: a round in which nobody
contributes leaves the parameters as they were, never NaN.

The ``*_sharded`` forms run on a ``launch.mesh`` mesh, one rank per
process: every rank passes the same global inputs, pads the member rows
(zero weights) and the columns to what the mesh divides, contracts its own
(C/n, D/m) block (the fedagg kernel on a CUDA block) and one
``all_reduce`` over the ``data`` sub-group finishes the §III-B upload.
The ``model`` axis needs no reduction; its column blocks are gathered
into the global result every rank returns.
"""
from __future__ import annotations

import torch

from repro_torch.core.plane import pad_member_rows
from repro_torch.core.tree import tree_map
from repro_torch.kernels.fedagg import ops as fedagg_ops
from repro_torch.launch import sharding
from repro_torch.launch.mesh import axis_size


def aggregate(params_stack, weights):
    """params_stack: pytree with leading client dim C; weights: (C,)."""
    w = torch.as_tensor(weights)
    return tree_map(lambda x: torch.tensordot(
        w.to(device=x.device, dtype=x.dtype), x, dims=([0], [0])),
        params_stack)


def normalized_weights(n_list, device=None) -> torch.Tensor:
    """Raw non-negative weights normalized to sum 1.  An all-zero input
    (every member dropped) gives zeros, which every aggregation here treats
    as the no-op, instead of the NaNs of an unguarded n / sum(n)."""
    n = torch.as_tensor(n_list, dtype=torch.float32, device=device)
    total = n.sum()
    return n / torch.where(total > 0.0, total, torch.ones_like(total))


def fedavg_delta(global_params, params_stack, weights):
    """Server update as an aggregated delta.  A zero total weight gives a
    zero delta, not ``-global_params``."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    live = bool(w.sum() > 0.0)
    agg = aggregate(params_stack, w)
    return tree_map(lambda a, g: a - g if live else torch.zeros_like(g),
                    agg, global_params)


def aggregate_plane(plane: torch.Tensor, weights) -> torch.Tensor:
    """plane: (C, D) fp32; weights: (C,) raw or normalized -> (D,)
    sum_i w_i p_i, through the fedagg kernel on a CUDA plane."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=plane.device)
    return fedagg_ops.aggregate_plane(plane, w)


def fedavg_delta_plane(global_plane, plane, weights):
    """Server update as an aggregated delta on the plane.  Zero total
    weight gives a zero delta."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=plane.device)
    return torch.where(w.sum() > 0.0,
                       aggregate_plane(plane, w) - global_plane,
                       torch.zeros_like(global_plane))


def merge_buffered_plane(partial_plane, bank_plane, bank_weights):
    """Fold banked rows (weights already normalized by the live + buffered
    total) into a partial plane sum: one contraction."""
    return partial_plane + aggregate_plane(bank_plane, bank_weights)


# ------------------------------------------------------- sharded flat plane
def _plane_rows_for_mesh(mesh, C: int, axis: str) -> int:
    """Smallest row count >= C divisible by the mesh ``axis`` size."""
    n = axis_size(mesh, axis)
    return -(-C // n) * n


def aggregate_sharded(mesh, params_stack, weights, axis: str = "data"):
    """Pytree FedAvg with the clients split along ``axis``: each rank
    contracts its rows (zero-weight padding rows up to a multiple of the
    axis) and one ``all_reduce`` per leaf sums the partial results, which
    every rank returns."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    C = w.shape[0]
    rows = _plane_rows_for_mesh(mesh, C, axis)

    def pad(x):
        if rows == C:
            return x
        return torch.cat([x, x.new_zeros((rows - C,) + tuple(x.shape[1:]))])

    w = torch.cat([w, w.new_zeros(rows - C)])
    local = aggregate(tree_map(lambda x: sharding.local_block(
        mesh, pad(x), {axis: 0}), params_stack),
        sharding.local_block(mesh, w, {axis: 0}))
    return tree_map(lambda x: sharding.all_reduce(mesh, x, axis), local)


def _block_of(mesh, plane, weights, axis, model_axis):
    """Pad a global (C, D) plane and its (C,) weights to the mesh and take
    this rank's (C/n, D/m) block; returns (plane block, weight rows, D)."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=plane.device)
    plane, w = pad_member_rows(plane, w, _plane_rows_for_mesh(
        mesh, plane.shape[0], axis))
    D = plane.shape[1]
    m = axis_size(mesh, model_axis) if model_axis else 1
    if D % m:
        # zero columns contract to zero columns, sliced back off below
        plane = torch.cat([plane, plane.new_zeros(plane.shape[0], -D % m)],
                          dim=1)
    spec = {axis: 0, **({model_axis: 1} if model_axis else {})}
    return (sharding.local_block(mesh, plane, spec),
            sharding.local_block(mesh, w, {axis: 0}), D)


def aggregate_plane_sharded(mesh, plane, weights, *, axis: str = "data",
                            model_axis: str | None = None):
    """plane: global (C, D) fp32; weights: (C,) raw or normalized -> the
    global (D,) sum_i w_i p_i on every rank.  Each rank contracts its
    (rows x columns) block, one ``all_reduce`` over ``axis`` sums the rows,
    and the column blocks are gathered along ``model_axis``."""
    blk, w, D = _block_of(mesh, plane, weights, axis, model_axis)
    out = sharding.all_reduce(mesh, aggregate_plane(blk.contiguous(), w),
                              axis)
    if model_axis:
        out = sharding.all_gather(mesh, out, model_axis, 0)
    return out[:D]


def fedavg_delta_plane_sharded(mesh, global_plane, plane, weights, *,
                               axis: str = "data",
                               model_axis: str | None = None):
    """Sharded server update as an aggregated delta on the plane.  Zero
    total weight gives a zero delta."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=plane.device)
    agg = aggregate_plane_sharded(mesh, plane, w, axis=axis,
                                  model_axis=model_axis)
    return torch.where(w.sum() > 0.0, agg - global_plane,
                       torch.zeros_like(global_plane))


def merge_buffered_plane_sharded(mesh, partial_plane, bank_plane,
                                 bank_weights, *, axis: str = "data",
                                 model_axis: str | None = None):
    """Sharded ``merge_buffered_plane``: the bank rows split like member
    rows, and their contraction joins the partial sum through the same
    block contraction and ``all_reduce``."""
    return partial_plane + aggregate_plane_sharded(
        mesh, bank_plane, bank_weights, axis=axis, model_axis=model_axis)


# ------------------------------------------------------------ buffered async
def compress_bank_rows(rows: list, us: list, cap: int, *, obs=None):
    """Fit a banked backlog into ``cap`` carry slots: when there are more
    rows than slots, all rows compress into ONE weighted-average row.  The
    total sum(u) and sum(u * p) are kept, so a later merge, which sees only
    those, is unchanged.  Returns (rows, us) untouched when they fit.

    ``obs``: optional Observability bundle; counts each compression and
    the rows it folded (``agg/bank_compressions``,
    ``agg/bank_rows_compressed``)."""
    if len(rows) <= cap:
        return rows, us
    if obs is not None and obs.on:
        obs.registry.counter("agg/bank_compressions").inc()
        obs.registry.counter("agg/bank_rows_compressed").inc(len(rows))
    u = torch.as_tensor(us, dtype=torch.float32, device=rows[0].device)
    total = float(u.sum())
    return [aggregate_plane(torch.stack(rows), u / total)], [total]


def staleness_weights(n_list, age_list, discount: float) -> list[float]:
    """Raw weights for banked (late) contributions: n_b * discount**age with
    age >= 1."""
    return [float(n) * discount ** max(1, int(age))
            for n, age in zip(n_list, age_list)]


def version_staleness_weights(n_list, version_list, current_version: int,
                              discount: float) -> list[float]:
    """Staleness measured in server versions: an entry tagged ``v`` merging
    at version ``V`` weighs ``n * discount**max(1, V - v)``."""
    return staleness_weights(
        n_list, [int(current_version) - int(v) for v in version_list],
        discount)


def anchored_merge_weights(anchor_weight: float, us) -> tuple[float, list]:
    """Normalize an anchored stale merge.  When everything is zero the
    anchor keeps weight 1 and the ledger gets zeros: a zero delta."""
    total = float(anchor_weight) + float(sum(us))
    if total <= 0.0:
        return 1.0, [0.0 for _ in us]
    return float(anchor_weight) / total, [float(u) / total for u in us]


def merge_buffered(partial, contribs, norm_weights, *, obs=None):
    """Fold banked contributions (pytrees, weights normalized by the total
    of live and buffered weight) into a partial FedAvg sum.  ``obs``
    (optional Observability bundle) counts merges and rows
    (``agg/bank_merges``, ``agg/bank_rows_merged``)."""
    if obs is not None and obs.on and contribs:
        obs.registry.counter("agg/bank_merges").inc()
        obs.registry.counter("agg/bank_rows_merged").inc(len(contribs))
    out = partial
    for p, nw in zip(contribs, norm_weights):
        w = float(nw)
        out = tree_map(lambda a, b: a + w * b.to(a.dtype), out, p)
    return out
