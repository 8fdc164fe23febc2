"""Member-axis sharding of the FL dispatch path over a
``launch.mesh`` mesh, the torch counterpart of the member-axis half of
``repro.launch.sharding`` (the tensor-parallel rules wait for ROADMAP item
11b).

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
