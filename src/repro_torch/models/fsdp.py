"""Fully sharded parameters (ZeRO-3) for the compile analysis's
``shard_mode="fsdp"`` programs: each parameter leaf lives as this rank's
slice (``launch.sharding.param_specs``' FSDP rule: its largest dim that
divides, over ``("data", "model")``, else over ``"data"``), and the model
gathers a leaf whole where it uses it.  JAX's XLA all-gathers every leaf
per use and reduce-scatters its gradient; ``gather`` does both, as an
``autograd.Function`` whose forward all-gathers over the leaf's split
axes and whose backward reduce-scatters the gradient back to the slice
(summed over those axes).

``fsdp_ctx(mesh, specs)`` binds the parameter tree's specs for a block;
the model code names each use by its path in the parameter tree
(``("embed",)``, ``("blocks",)``, ...).  A stacked superblock leaf is
gathered inside the superblock that uses it (``stack_slice`` outside,
``gather_slice`` inside), so under ``remat`` the gather runs inside
``transformer.Recompute`` and again in its backward: no gathered leaf
outlives its superblock.  Where the stack dim itself is the split one,
the superblock's slice lives on some ranks only, so the whole stack is
gathered and the superblock's slice taken.  With no context every
function returns its input (or the plain slice): single-device code does
not change.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

# (mesh, spec pytree of the params, spec pytree of their tensor-parallel
# blocks or None)
_CTX: "tuple | None" = None


@contextmanager
def fsdp_ctx(mesh, specs, tp_specs=None):
    """Within this block the parameters are FSDP slices laid out by
    ``specs`` (a pytree of ``launch.sharding.Spec``) over ``mesh``.
    ``tp_specs``: each gathered leaf is cut to this rank's block of that
    layout (a view), for a program that runs tensor-parallel on the
    gathered weights (the FSDP decode)."""
    global _CTX
    prev = _CTX
    _CTX = (mesh, specs, tp_specs)
    try:
        yield
    finally:
        _CTX = prev


def current():
    """The active context, or None; a superblock body keeps it so that
    its recomputation in the backward pass gathers alike."""
    return _CTX


def _pairs(mesh, spec, skip: int = -1) -> tuple:
    """((axis, dim), ...) the leaf splits along, major axes first, over
    axes of more than one rank; ``skip`` a dim left out."""
    from repro_torch.launch.mesh import axis_size
    from repro_torch.launch.sharding import spec_dims
    return tuple((a, d - (d > skip >= 0)) for a, d in spec_dims(spec).items()
                 if d != skip and axis_size(mesh, a) > 1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh, pairs):
        from repro_torch.launch import sharding
        for axis, dim in reversed(pairs):
            x = sharding.all_gather(mesh, x, axis, dim)
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.pairs = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        from repro_torch.launch import sharding
        for axis, dim in ctx.pairs:
            g = sharding.reduce_scatter(ctx.mesh, g, axis, dim)
        return g, None, None


def _gather(x, mesh, pairs):
    return _Gather.apply(x, mesh, pairs) if pairs else x


def _spec(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _zip(fn, tree, specs, tp_specs=None):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k], tp_specs and tp_specs[k])
                for k, v in tree.items()}
    return fn(tree, specs, tp_specs)


def _tp_block(mesh, x, tp_spec, skip: int = -1):
    """This rank's block of a whole leaf under its tensor-parallel spec
    (``x`` itself without one)."""
    if tp_spec is None:
        return x
    from repro_torch.launch.sharding import local_block
    return local_block(mesh, x, dict(_pairs(mesh, tp_spec, skip)))


def _zip_ctx(fn, tree, path, ctx):
    return _zip(fn, tree, _spec(ctx[1], path),
                ctx[2] and _spec(ctx[2], path))


def gather(tree, path: tuple, ctx=None):
    """A leaf or subtree at ``path`` of the parameter tree, every leaf
    gathered whole (``tree`` itself with no context)."""
    ctx = ctx or _CTX
    if ctx is None:
        return tree
    mesh = ctx[0]
    return _zip_ctx(lambda x, s, t: _tp_block(
        mesh, _gather(x, mesh, _pairs(mesh, s)), t), tree, path, ctx)


def stack_slice(tree, sb: int, path: tuple, ctx=None):
    """Superblock ``sb``'s inputs from the stacked leaves at ``path``:
    each leaf's slice ``sb`` (a view of this rank's block), or this rank's
    block of the whole stack where the stack dim is split."""
    ctx = ctx or _CTX

    def take(x, s, t):
        if any(d == 0 for _, d in _pairs(ctx[0], s)):
            return x
        return x[sb]

    if ctx is None:
        return _zip(lambda x, s, t: x[sb], tree, tree)
    return _zip_ctx(take, tree, path, ctx)


def gather_slice(tree, sb: int, path: tuple, ctx=None):
    """``stack_slice``'s inputs gathered whole: superblock ``sb``'s
    parameters (``tree`` itself with no context)."""
    ctx = ctx or _CTX
    if ctx is None:
        return tree

    mesh = ctx[0]

    def whole(x, s, t):
        pairs = _pairs(mesh, s)
        if any(d == 0 for _, d in pairs):
            x = _gather(x, mesh, pairs)[sb]
        else:
            x = _gather(x, mesh, _pairs(mesh, s, skip=0))
        return _tp_block(mesh, x, t, skip=0)

    return _zip_ctx(whole, tree, path, ctx)


def layer(tree, i: int, path: tuple):
    """Layer ``i``'s parameters from the stacked leaves at ``path``,
    gathered whole under a context."""
    return gather_slice(stack_slice(tree, i, path), i, path)
