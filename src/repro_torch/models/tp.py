"""Tensor parallelism of the member forward over a mesh ``model`` axis.

JAX's ``repro.models.tp`` only advises GSPMD where the Megatron cut points
are (``shard_hint``); GSPMD then splits the program itself.  The port has
no partitioner, so each rank runs its own slice of the model explicitly:
its TP leaves are the local slices a ``core.plane.TPPlaneSpec`` chunk holds,
and the model code calls Megatron's four operations at the cut points:

* ``copy_to_tp``: identity forward, ``all_reduce`` backward, where a tensor
  every rank holds enters computation each rank does on its own slice;
* ``reduce_from_tp``: ``all_reduce`` forward, identity backward, where the
  ranks' partial sums (a row-parallel product) become the whole;
* ``gather_from_tp``: ``all_gather`` forward, slice backward, where the
  ranks' slices of a dim become the whole tensor;
* ``scatter_to_tp``: slice forward, ``all_gather`` backward, where a whole
  tensor feeds computation that takes only this rank's slice.

Each is an ``autograd.Function`` with ``setup_context`` and a ``vmap`` rule
that moves the vmapped axis (the FL member axis of ``core.client``) to the
front and runs the collective once on the whole batched tensor, so the
operations live inside the engine's ``vmap(grad_and_value(...))`` member
step; a backward that needs a collective calls the dual operation, whose
own rule batches it.  With no context active (``tp_shard_ctx``), every one
of them returns its input: single-device code paths do not change by a bit.

Three compositions serve the mixers whose split does not end at one
column-parallel / row-parallel pair (Mamba, the xLSTM cells, the MoE
experts).  Such a mixer runs *rank-partial*: from its input to its last,
row-parallel product each rank computes only its share of the output,
which one ``reduce_from_tp`` sums.  Every tensor that all ranks hold and
that enters that computation (the input, a whole leaf, a gathered
activation or leaf) goes through ``copy_to_tp`` once, so that its gradient
is the sum of the ranks' shares: ``whole`` gathers a tensor a rank holds a
slice of and copies it in, ``linear_whole`` is a product whose output
columns may be split, made whole, and ``own`` is this rank's slice of a
whole tensor inside that computation (a plain view).

``tp_shard_ctx(mesh, axis)`` and ``tp_ctx()`` keep JAX's names and
scoping: the server enters the context around a tensor-parallel dispatch
block.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from repro_torch.launch.mesh import axis_size

_CTX: "tuple | None" = None        # (mesh, model-axis name) or None


@contextmanager
def tp_shard_ctx(mesh, axis: str):
    """Run the member forward tensor-parallel over ``mesh``'s ``axis``
    within this block."""
    global _CTX
    prev = _CTX
    _CTX = (mesh, axis)
    try:
        yield
    finally:
        _CTX = prev


def tp_ctx():
    """The active (mesh, axis) TP context, or None."""
    return _CTX


def tp_size() -> int:
    """Ranks along the active model axis (1 without a context)."""
    return 1 if _CTX is None else axis_size(*_CTX)


def tp_rank() -> int:
    """This rank's index along the active model axis (0 without one)."""
    if _CTX is None:
        return 0
    mesh, axis = _CTX
    return int(mesh.get_local_rank(axis))


def splits(n: int) -> bool:
    """Whether a leaf dim of ``n`` is split over the active model axis:
    ``launch.sharding.tp_specs`` and ``core.plane.make_tp_plane_spec``
    demote a dim that does not divide to a replicated leaf."""
    m = tp_size()
    return m > 1 and n % m == 0


def _group():
    mesh, axis = _CTX
    return mesh.get_group(axis)


def _all_reduce(x, op=None):
    import torch.distributed as dist
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=_group())
    return y


def _all_gather(x, dim: int):
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp_size())]
    dist.all_gather(parts, x, group=_group())
    return torch.cat(parts, dim=dim)


def _slice(x, dim: int):
    k = x.shape[dim] // tp_size()
    return x.narrow(dim, tp_rank() * k, k).contiguous()


def _front(x, d):
    """The physical tensor of a vmapped input with its batch dim first."""
    return x if d is None else x.movedim(d, 0)


def _phys(dim: int, d) -> int:
    """A logical dim of a vmapped input, on its batch-first tensor."""
    return dim + 1 if d is not None and dim >= 0 else dim


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromTP.apply(g)

    @staticmethod
    def vmap(info, in_dims, x):
        return _CopyToTP.apply(_front(x, in_dims[0])), (
            None if in_dims[0] is None else 0)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _all_reduce(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g

    @staticmethod
    def vmap(info, in_dims, x):
        return _ReduceFromTP.apply(_front(x, in_dims[0])), (
            None if in_dims[0] is None else 0)


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(x, dim):
        return _all_gather(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        d = in_dims[0]
        return _GatherFromTP.apply(_front(x, d), _phys(dim, d)), (
            None if d is None else 0)


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(x, dim):
        return _slice(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GatherFromTP.apply(g, ctx.dim), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        d = in_dims[0]
        return _ScatterToTP.apply(_front(x, d), _phys(dim, d)), (
            None if d is None else 0)


class _MaxFromTP(torch.autograd.Function):
    """Elementwise max over the ranks; no gradient (callers pass a
    detached tensor, as a stabilizing shift of a logsumexp)."""

    @staticmethod
    def forward(x):
        import torch.distributed as dist
        return _all_reduce(x, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)

    @staticmethod
    def vmap(info, in_dims, x):
        return _MaxFromTP.apply(_front(x, in_dims[0])), (
            None if in_dims[0] is None else 0)


def copy_to_tp(x):
    """Identity forward; the backward sums the gradient over the ranks."""
    return x if _CTX is None else _CopyToTP.apply(x)


def reduce_from_tp(x):
    """The sum of every rank's ``x``; the backward passes the gradient."""
    return x if _CTX is None else _ReduceFromTP.apply(x)


def gather_from_tp(x, dim: int = -1):
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward keeps this rank's slice of the gradient."""
    return x if _CTX is None else _GatherFromTP.apply(x, dim)


def scatter_to_tp(x, dim: int = -1):
    """This rank's contiguous slice of ``dim``; the backward gathers the
    gradient."""
    return x if _CTX is None else _ScatterToTP.apply(x, dim)


def max_from_tp(x):
    """The elementwise max over the ranks of a tensor without gradient."""
    return x if _CTX is None else _MaxFromTP.apply(x)


def vocab_parallel_ce(logits, labels):
    """Per position ``logsumexp(logits) - logits[label]`` of logits split
    over the vocabulary (this rank's contiguous slice of it, in rank
    order): one max and two sums reduced over the model axis, so no rank
    holds the whole vocabulary.  The max is a constant shift (no
    gradient), as in Megatron's vocab-parallel cross-entropy."""
    v = logits.shape[-1]
    mx = max_from_tp(logits.detach().amax(dim=-1))
    lse = torch.log(reduce_from_tp(
        torch.exp(logits - mx[..., None]).sum(dim=-1))) + mx
    t = labels - tp_rank() * v
    inside = (t >= 0) & (t < v)
    picked = torch.gather(logits, -1, t.clamp(0, v - 1)[..., None])[..., 0]
    return lse - reduce_from_tp(picked * inside)


def whole(x, n: int, dim: int = -1, partial: bool = False):
    """``x`` whole on every rank: where its ``dim`` is this rank's slice of
    ``n`` (a split leaf, or a column-parallel product's output) every
    rank's slice is gathered.  ``partial``: it feeds rank-partial
    computation, so it enters through ``copy_to_tp`` (the backward sums
    the ranks' gradients, then keeps this rank's slice).  With no context,
    or a whole ``x`` outside rank-partial computation, returns ``x``."""
    if x.shape[dim] != n:
        x = gather_from_tp(x, dim)
    return copy_to_tp(x) if partial else x


def linear_whole(x, w, n: int, partial: bool = False):
    """``x @ w`` of ``n`` output columns, whole on every rank, where ``w``
    may hold this rank's slice of them.  A split ``w`` takes a
    column-parallel product and gathers its output (``x`` copied in
    unless it is already inside rank-partial computation); a whole ``w``
    is copied in when ``partial``."""
    if w.shape[-1] != n:
        return whole((x if partial else copy_to_tp(x)) @ w, n,
                     partial=partial)
    return x @ (copy_to_tp(w) if partial else w)


def own(x, dim: int = -1):
    """This rank's contiguous slice of ``dim`` of a whole tensor inside
    rank-partial computation: a plain view, its gradient this rank's share
    (summed upstream by ``copy_to_tp``).  ``x`` itself with no context."""
    if _CTX is None:
        return x
    k = x.shape[dim] // tp_size()
    return x.narrow(dim, tp_rank() * k, k)
