"""FedAvg aggregation of client-stacked weights (§III-B), single device.

``aggregate`` is the pytree form the one-round path uses; the ``*_plane``
forms work on the dispatch path's flat ``(C, D)`` parameter plane, where the
contraction is the fedagg kernel on a CUDA tensor and its plain version on a
CPU tensor.  Every op has a zero-total guard: a round in which nobody
contributes leaves the parameters as they were, never NaN.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels.fedagg import ops as fedagg_ops


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
    return fedagg_ops.weighted_aggregate(plane, w.contiguous())


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
