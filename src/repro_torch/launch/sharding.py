"""Sharding over a ``launch.mesh`` mesh, the torch counterpart of
``repro.launch.sharding``: the FL dispatch path's member-axis specs, the
tensor-parallel name rules (``tp_specs``), and the compile analysis's
rules (``param_specs``, ``batch_specs``, ``cache_specs``, ``to_named``).

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

The compile analysis's rules (``launch.dryrun``) need a dim split over
several axes at once (FSDP, the sequence-sharded cache), which a
``{axis: dim}`` spec cannot say.  They give each leaf a ``Spec``: one
entry per tensor dim, each ``None``, an axis name or a tuple of axis names
(major first), as ``PartitionSpec``'s entries are.  ``to_named`` turns a
``Spec`` into DTensor placements and ``spec_dims`` into the ``{axis: dim}``
form ``local_block`` slices by.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_size, mesh_shape

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


def _tp_dim(cfg, path, leaf, msize: int):
    """The dim the Megatron name rules split a leaf along, or None."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    nd = len(shape)
    is_moe = (name in MOE_LEAVES and cfg.n_experts > 0
              and nd >= 3 and shape[nd - 3] == cfg.n_experts)
    if is_moe and cfg.moe_shard == "ep" and shape[nd - 3] % msize == 0:
        return nd - 3
    if name in PARAM_DIM:
        dim = PARAM_DIM[name]
        dim = dim if dim >= 0 else nd + dim
        if 0 <= dim < nd and shape[dim] % msize == 0:
            return dim
    return None


def tp_specs(cfg, params, msize: int, axis: str = "model"):
    """Megatron name rules for a model-axis size (no mesh): each leaf's
    spec, ``{axis: dim}`` for a leaf split along ``dim`` or ``{}`` for a
    replicated one.  A dim that does not divide ``msize`` is replicated.
    ``params``: a pytree of tensors (or anything with ``.shape``)."""

    def spec(path, leaf):
        dim = _tp_dim(cfg, path, leaf, msize)
        return {} if dim is None else {axis: dim}

    return _map_with_path(spec, params)


# ------------------------------------------------ the compile analysis's rules
class Spec(tuple):
    """A leaf's per-dim spec: entry ``i`` is None (dim ``i`` whole), an
    axis name, or a tuple of axis names (major first) dim ``i`` is split
    over.  A ``tuple`` subclass, so pytree code that walks tuples must
    stop at it (``map_specs``)."""

    def __repr__(self):
        return "Spec" + tuple.__repr__(self)


def P(*entries) -> Spec:
    return Spec(entries)


def _shape(mesh) -> dict:
    """{axis: size} of a mesh, or of a dict already in that form (the
    rules need only the sizes, so tests build no world)."""
    return dict(mesh) if isinstance(mesh, dict) else mesh_shape(mesh)


def _size(shape: dict, axes) -> int:
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return n


def map_specs(fn, tree, path=()):
    """``fn(path, spec)`` over every ``Spec`` of a pytree of specs."""
    if isinstance(tree, Spec) or tree is None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(cfg, params_shape, mesh):
    """params_shape: a pytree of tensors (meta tensors: ``launch.specs``)."""
    if cfg.shard_mode == "fsdp":
        return _fsdp_param_specs(params_shape, mesh)
    msize = _shape(mesh).get("model", 1)

    def spec(path, leaf):
        out = [None] * leaf.dim()
        dim = _tp_dim(cfg, path, leaf, msize)
        if dim is not None:
            out[dim] = "model"
        return Spec(out)

    return _map_with_path(spec, params_shape)


def _fsdp_param_specs(params_shape, mesh):
    """ZeRO-3 style: every parameter fully sharded over ('data','model')
    along its largest divisible dim, else over 'data' alone, else
    replicated; the step gathers each leaf whole at its use."""
    axes = ("data", "model")
    shape = _shape(mesh)
    total = _size(shape, axes)
    dsize = shape.get("data", 1)

    def spec(path, leaf):
        dims = tuple(leaf.shape)
        out = [None] * len(dims)
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if dims[i] % total == 0:
                out[i] = axes
                return Spec(out)
        for i in order:
            if dims[i] % dsize == 0:
                out[i] = "data"
                return Spec(out)
        return Spec(out)

    return _map_with_path(spec, params_shape)


def batch_axes(cfg, mesh) -> tuple:
    """The axes a batch splits over: ('pod', 'data'), and 'model' too in
    FSDP mode."""
    dp = tuple(a for a in _shape(mesh) if a in ("pod", "data"))
    return dp + ("model",) if cfg.shard_mode == "fsdp" else dp


def batch_specs(cfg, batch_shape, mesh):
    """The batch dim along the longest prefix of ``batch_axes`` whose
    size divides it (replicated if none does)."""
    dp = batch_axes(cfg, mesh)
    shape = _shape(mesh)

    def spec(path, leaf):
        b = leaf.shape[0]
        lead = None
        for k in range(len(dp), 0, -1):
            if b % _size(shape, dp[:k]) == 0:
                lead = dp[:k]
                break
        return Spec((lead,) + (None,) * (leaf.dim() - 1))

    return _map_with_path(spec, batch_shape)


def cache_specs(cfg, cache_shape, mesh, *, shard_seq: bool):
    """KV caches: batch along the data axes (``cache_shard`` "hd": head
    dim along 'model'; "seq": the sequence along it); with ``shard_seq``
    (batch-1 long-context decode) the sequence axis splits instead."""
    shape = _shape(mesh)
    dp = tuple(a for a in shape if a in ("pod", "data"))
    dp_size = _size(shape, dp)
    msize = shape.get("model", 1)

    def spec(path, leaf):
        name = _leaf_name(path)
        dims = tuple(leaf.shape)
        nd = len(dims)
        out = [None] * nd
        # layouts (leading superblock / layer axis): k/v (L,B,S,KV,hd),
        # h (L,B,di,st), conv (L,B,k,di), C (L,B,H,hd,hd), n/c/h/m (L,B,H,hd)
        if name in ("k", "v", "xk", "xv") and nd == 5:
            if shard_seq:
                seq = cfg.cache_shard == "seq"
                seq_axes = dp + ("model",) if seq else dp
                seq_total = dp_size * (msize if seq else 1)
                if dims[2] % seq_total == 0:
                    out[2] = seq_axes
                elif dims[2] % dp_size == 0:
                    out[2] = dp
                if cfg.cache_shard == "hd" and dims[4] % msize == 0:
                    out[4] = "model"
                return Spec(out)
            if dims[1] % dp_size == 0:
                out[1] = dp
            if cfg.cache_shard == "hd" and dims[4] % msize == 0:
                out[4] = "model"
            elif cfg.cache_shard == "seq" and dims[2] % msize == 0:
                out[2] = "model"
        elif name == "h" and nd == 4:
            if dims[1] % dp_size == 0 and not shard_seq:
                out[1] = dp
            if dims[2] % msize == 0:
                out[2] = "model"
        elif name == "conv" and nd == 4:
            if dims[1] % dp_size == 0 and not shard_seq:
                out[1] = dp
            if dims[3] % msize == 0:
                out[3] = "model"
        elif name == "C" and nd == 5:
            if dims[1] % dp_size == 0 and not shard_seq:
                out[1] = dp
            if dims[3] % msize == 0:
                out[3] = "model"
        elif nd >= 2:
            if dims[1] % dp_size == 0 and not shard_seq:
                out[1] = dp
            if nd >= 4 and dims[-1] % msize == 0:
                out[-1] = "model"
        return Spec(out)

    return _map_with_path(spec, cache_shape)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_named(mesh, specs):
    """Each ``Spec`` as DTensor placements, one per mesh dim in mesh
    order: ``Shard(i)`` for the dim its entries split along that axis,
    else ``Replicate()`` (JAX's ``NamedSharding``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(_shape(mesh))

    def named(path, spec):
        spec = Spec(()) if spec is None else spec
        out = []
        for a in names:
            dims = [i for i, e in enumerate(spec) if a in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    return map_specs(named, specs)


def spec_dims(spec) -> dict:
    """A ``Spec`` as ``{axis: dim}``, major axes first, the form
    ``local_block`` and ``gather_block`` take."""
    return {a: i for i, e in enumerate(spec or ()) for a in _entry_axes(e)}


def local_shape(shape, spec, mesh) -> tuple:
    """A leaf's block shape on one rank under ``spec``."""
    sizes = _shape(mesh)
    return tuple(n // _size(sizes, _entry_axes(e))
                 for n, e in zip(shape, tuple(spec or ()) + (None,) * len(shape)))


def member_specs(tree, axis: str = "data"):
    """``{axis: 0}`` on the leading (member) axis of every leaf; None
    subtrees pass through."""
    return _map_with_path(lambda _, x: None if x is None else {axis: 0},
                          tree)


def replicated_specs(tree):
    """``{}`` on every leaf (tensors every rank holds whole)."""
    return _map_with_path(lambda _, x: None if x is None else {}, tree)


def shard_member_tree(mesh, tree, axis: str = "data"):
    """Every leaf's rows of this rank along the member axis (views), the
    counterpart of placing a tree row-sharded on the mesh once."""
    return _map_with_path(
        lambda _, x: None if x is None else local_block(mesh, x, {axis: 0}),
        tree)


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


def all_reduce(mesh, x, axis: str, op: str = "sum"):
    """Sum (``op="max"``: the elementwise max of) ``x`` over ``axis``'s
    sub-group, in place; returns ``x``."""
    if axis_size(mesh, axis) > 1:
        import torch.distributed as dist
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=mesh.get_group(axis))
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


def reduce_scatter(mesh, x, axis: str, dim: int):
    """Every ``axis`` rank's ``x`` summed, and this rank's contiguous
    slice of ``dim`` of the sum (the dual of ``all_gather``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    import torch
    import torch.distributed as dist
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def gather_block(mesh, x, spec: dict):
    """The global tensor from this rank's ``local_block``."""
    for axis, dim in reversed(list(spec.items())):
        x = all_gather(mesh, x, axis, dim)
    return x
