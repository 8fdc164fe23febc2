"""Sharding of the FL dispatch path over a ``launch.mesh`` mesh, the
torch counterpart of ``repro.launch.sharding``'s member-axis half and of its
tensor-parallel name rules (``tp_specs``; the launch stack's ``param_specs``,
``batch_specs``, ``cache_specs`` and ``to_named`` wait for ROADMAP item 12).

A spec says which tensor dim each mesh axis splits: ``{"data": 0}`` (the
member axis: JAX's ``member_specs``) splits dim 0 into ``data``-size
contiguous row blocks, ``{"data": 0, "model": 1}`` also splits dim 1 along
``model``, ``{}`` replicates (``replicated_specs``); an axis the spec does
not name holds the whole tensor, as DTensor's ``Shard(dim)`` and
``Replicate()`` placements would.  ``core.plane.plane_specs`` gives the
spec of every buffer of the dispatch path.  Every rank holds the same
global tensor at a dispatch block's boundary and works on its
``local_block`` (JAX's ``shard_member_tree``, as a row slice);
``gather_block`` is the inverse (one ``all_gather`` per split axis), and
``all_reduce`` sums over one axis's sub-group.  On an axis of one rank
these are no-ops and start no collective.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_size

# leaf name -> dim to split along ``model`` (negative = from the end, so the
# stacked superblock axis in front does not count); ``embed`` / ``lm_head``
# split the vocabulary (dim 0)
PARAM_DIM = {
    "embed": 0, "lm_head": 0,
    "wq": -1, "wk": -1, "wv": -1, "w_up": -1, "up": -1,
    "up_g": -1, "up_v": -1, "in_proj": -1, "x_proj": -1, "wx": -1,
    "conv_w": -1, "conv_b": -1, "D": -1, "dt_bias": -1, "skip": -1,
    "dt_proj": -1, "w_gate": -1,
    "wo": -2, "w_down": -2, "down": -2, "out_proj": -2, "A_log": -2,
}
# MoE expert tensors can split the EXPERT axis instead (expert parallelism)
MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _leaf_name(path) -> str:
    """The last dict key on a leaf's path (list indices skipped)."""
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tp_specs(cfg, params, msize: int, axis: str = "model"):
    """Megatron name rules for a model-axis size (no mesh): each leaf's
    spec, ``{axis: dim}`` for a leaf split along ``dim`` or ``{}`` for a
    replicated one.  A dim that does not divide ``msize`` is replicated.
    ``params``: a pytree of tensors (or anything with ``.shape``)."""

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        is_moe = (name in MOE_LEAVES and cfg.n_experts > 0
                  and nd >= 3 and shape[nd - 3] == cfg.n_experts)
        if is_moe and cfg.moe_shard == "ep" and shape[nd - 3] % msize == 0:
            return {axis: nd - 3}
        if name in PARAM_DIM:
            dim = PARAM_DIM[name]
            dim = dim if dim >= 0 else nd + dim
            if 0 <= dim < nd and shape[dim] % msize == 0:
                return {axis: dim}
        return {}

    return _map_with_path(spec, params)


def _rank_on(mesh, axis: str) -> int:
    return int(mesh.get_local_rank(axis))


def local_block(mesh, x, spec: dict):
    """This rank's block of the global tensor or numpy array ``x`` (a
    view): for each split axis of ``spec``, its rank's contiguous chunk of
    that dim, which must divide evenly."""
    for axis, dim in spec.items():
        n = axis_size(mesh, axis)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways along {axis!r}")
        k = x.shape[dim] // n
        a = _rank_on(mesh, axis) * k
        x = x[(slice(None),) * dim + (slice(a, a + k),)]
    return x


def all_reduce(mesh, x, axis: str):
    """Sum ``x`` over ``axis``'s sub-group, in place; returns ``x``."""
    if axis_size(mesh, axis) > 1:
        import torch.distributed as dist
        dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def all_gather(mesh, x, axis: str, dim: int):
    """Concatenate every ``axis`` rank's ``x`` along ``dim``, in rank
    order (the inverse of ``local_block`` along one axis)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    import torch
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def gather_block(mesh, x, spec: dict):
    """The global tensor from this rank's ``local_block``."""
    for axis, dim in reversed(list(spec.items())):
        x = all_gather(mesh, x, axis, dim)
    return x
