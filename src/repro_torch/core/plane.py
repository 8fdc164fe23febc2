"""Flat parameter plane: the currency of the dispatch path.

A cluster's parameters are raveled into one contiguous fp32 vector padded to
a multiple of ``PLANE_ALIGN``, so that the multi-round dispatch block and the
fedagg kernel work on a single ``(capacity, D_pad)`` buffer.  Parameters
reappear as a pytree only inside the member forward (as views into the
plane) and at evaluation.

The element order is ``ravel_pytree``'s (``core.tree``): sorted dict keys,
then list order, each leaf raveled C-order in its reference layout (HWIO
conv weights, ``(in, out)`` dense weights).  A port plane therefore equals
the JAX package's plane of the same parameters element by element.

``to_params`` follows the dtype rule of JAX's ``ravel_pytree`` unravel:
a template whose leaves share one dtype unravels to views in the plane's
dtype (an fp32 plane of a bf16 model trains fp32 leaves, in both
packages), and a template of mixed dtypes gives each leaf its own dtype
back.  ``keep_dtypes=True`` gives every leaf its template dtype, which a
server reloading an fp32 plane into bf16 serving parameters asks for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten

# Multiple every plane length is padded to.  The fedagg kernel loads four
# columns per thread, and the JAX package pads to the same multiple, so
# padded lengths agree across packages.
PLANE_ALIGN = 128


@dataclass(frozen=True)
class PlaneSpec:
    """Ravel/unravel recipe for one cluster level's parameter pytree."""
    d: int                      # true parameter count
    d_pad: int                  # padded plane length (multiple of PLANE_ALIGN)
    template: object            # the params structure, leaves are None
    shapes: tuple               # leaf shapes in ravel order
    dtypes: tuple               # leaf dtypes in ravel order

    def to_plane(self, params) -> torch.Tensor:
        """params pytree -> (..., d_pad) fp32 plane.  Leading axes beyond a
        leaf's own shape (a member axis) are kept: a (C, ...) stack of
        params gives a (C, d_pad) member plane."""
        leaves = tree_leaves(params)
        lead = leaves[0].shape[:leaves[0].dim() - len(self.shapes[0])]
        flat = [x.reshape(*lead, -1).to(torch.float32) for x in leaves]
        if self.d_pad > self.d:
            flat.append(leaves[0].new_zeros(*lead, self.d_pad - self.d,
                                            dtype=torch.float32))
        return torch.cat(flat, dim=-1)

    def to_params(self, plane: torch.Tensor, *, keep_dtypes: bool = False):
        """(..., d_pad) plane -> params pytree.  Leaves are views into the
        plane unless cast: to their template dtypes when the template mixes
        dtypes (JAX's unravel) or when ``keep_dtypes``."""
        cast = keep_dtypes or len(set(self.dtypes)) > 1
        lead = plane.shape[:-1]
        leaves, off = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            n = math.prod(shape)
            leaf = plane[..., off:off + n].reshape(*lead, *shape)
            leaves.append(leaf.to(dtype) if cast else leaf)
            off += n
        return tree_unflatten(self.template, leaves)


def make_plane_spec(params_template, *, model_size: int = 1) -> PlaneSpec:
    """``model_size`` > 1 column-shards the plane over a mesh ``model``
    axis: D is padded to a multiple of ``model_size × PLANE_ALIGN`` so every
    rank's column slice is itself ``PLANE_ALIGN``-aligned, as the fedagg
    kernel wants it."""
    leaves = tree_leaves(params_template)
    shapes = tuple(tuple(x.shape) for x in leaves)
    d = sum(math.prod(s) for s in shapes)
    align = PLANE_ALIGN * max(1, int(model_size))
    d_pad = -(-d // align) * align
    return PlaneSpec(d=d, d_pad=d_pad,
                     template=tree_unflatten(params_template,
                                             [None] * len(shapes)),
                     shapes=shapes,
                     dtypes=tuple(x.dtype for x in leaves))


def plane_specs(data_axis: str = "data", model_axis: str | None = None):
    """How every plane-shaped buffer of the dispatch path splits over the
    (data, model) mesh, as ``launch.sharding`` specs ({mesh axis: tensor
    dim}; an axis not named holds the whole buffer).  Member rows (shard
    packs, step masks, weights, bank rows) split along ``data_axis``;
    plane COLUMNS split along ``model_axis`` when given: the global (D,)
    plane, the (capacity, D) member and bank planes and the (R, D) teacher
    and history stacks.  Aggregation then contracts each rank's (member
    rows × column slice) block and sums over ``data`` only: columns never
    need a reduction.  ``model_axis=None`` is the 1D member-sharded layout
    (the plane whole on every rank)."""
    cols = {model_axis: 0} if model_axis else {}
    return {
        "plane": cols,                                   # (D,)
        "members": {data_axis: 0,                        # (capacity, D)
                    **({model_axis: 1} if model_axis else {})},
        "stack": {model_axis: 1} if model_axis else {},  # (R, D)
        "rows": {data_axis: 0},                          # (capacity,)
        "masks": {data_axis: 0},                         # (capacity, S)
        "losses": {data_axis: 1},                        # (R, capacity)
    }


def pad_member_rows(plane: torch.Tensor, weights: torch.Tensor, rows: int):
    """Pad a (C, D) member plane and its (C,) weights with zero rows up to
    ``rows``.  A zero-weight row contributes nothing to any weighted
    contraction, so callers may round C up to a capacity bucket."""
    C = plane.shape[0]
    if rows < C:
        raise ValueError(f"cannot pad {C} member rows down to {rows}")
    weights = weights.to(torch.float32)
    if rows == C:
        return plane, weights
    plane = torch.cat([plane, plane.new_zeros(rows - C, plane.shape[1])])
    weights = torch.cat([weights, weights.new_zeros(rows - C)])
    return plane, weights
