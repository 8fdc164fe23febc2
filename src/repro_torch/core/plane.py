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


@dataclass(frozen=True)
class TPPlaneSpec:
    """Tensor-parallel plane recipe: a (d_pad,) plane whose LAYOUT matches
    the ``model``-axis split of every leaf, JAX's ``TPPlaneSpec`` byte for
    byte.

    The plane is ``msize`` contiguous chunks of ``d_loc`` entries; chunk
    ``i`` holds shard ``i`` of every split leaf (its split dim cut
    ``msize`` ways, the shard index moved in front of the leaf's own axes
    before raveling) and a whole copy of every replicated leaf.  Rank
    ``i`` of the model axis therefore holds, in its column block of the
    plane, exactly the leaves its slice of the model uses
    (``local_params``), and writes them back with ``local_to_chunk``.
    Replicated leaves are stored ``msize`` times; the plane algebra
    (FedAvg, deltas, bank merges) is linear and treats every copy alike.
    A TP plane is NOT element-compatible with a ``PlaneSpec`` plane of the
    same parameters: convert through pytrees (``to_params`` /
    ``to_plane``)."""
    d: int                  # true (unduplicated) parameter count
    d_pad: int              # plane length = msize · d_loc
    msize: int              # model-axis size the layout is built for
    d_loc: int              # per-chunk length (PLANE_ALIGN multiple)
    template: object        # the params structure, leaves are None
    recs: tuple             # per leaf: (shape, dtype, split dim | None,
    #                         chunk offset, per-chunk size)
    axis: str = "model"     # mesh axis name the layout splits along

    def leaf_specs(self):
        """Per-leaf specs the layout honours (``{axis: dim}`` or ``{}``;
        dims that do not divide ``msize`` already demoted)."""
        return tree_unflatten(self.template, [
            {} if k is None else {self.axis: k} for _, _, k, _, _ in self.recs])

    def to_plane(self, params) -> torch.Tensor:
        """params pytree -> (..., d_pad) fp32 TP-layout plane; leading
        axes beyond a leaf's own shape (a member axis) are kept."""
        leaves = tree_leaves(params)
        lead = tuple(leaves[0].shape[:leaves[0].dim()
                                     - len(self.recs[0][0])])
        nl, m = len(lead), self.msize
        pieces = []
        for x, (shape, _, k, _, s_loc) in zip(leaves, self.recs):
            x = x.to(torch.float32)
            if k is None:
                x = x.reshape(*lead, 1, s_loc).expand(*lead, m, s_loc)
            else:
                split = shape[:k] + (m, shape[k] // m) + shape[k + 1:]
                x = x.reshape(*lead, *split).movedim(nl + k, nl)
                x = x.reshape(*lead, m, s_loc)
            pieces.append(x)
        pad = self.d_loc - sum(r[4] for r in self.recs)
        if pad:
            pieces.append(leaves[0].new_zeros(*lead, m, pad,
                                              dtype=torch.float32))
        return torch.cat(pieces, dim=-1).reshape(*lead, m * self.d_loc)

    def to_params(self, plane: torch.Tensor):
        """(..., d_pad) plane -> the whole params pytree, every leaf cast
        to its template dtype, as JAX's TP unravel does: a bf16 model
        trains bf16 leaves on a TP plane, though ``PlaneSpec.to_params``
        gives an fp32 plane of a single-dtype template fp32 leaves (the
        two layouts' rules differ in both packages)."""
        m = self.msize
        lead = tuple(plane.shape[:-1])
        nl = len(lead)
        x2 = plane.reshape(*lead, m, self.d_loc)
        leaves = []
        for shape, dt, k, off, s_loc in self.recs:
            piece = x2[..., off:off + s_loc]
            if k is None:
                leaf = piece[..., 0, :].reshape(*lead, *shape)
            else:
                split = (m,) + shape[:k] + (shape[k] // m,) + shape[k + 1:]
                leaf = piece.reshape(*lead, *split).movedim(nl, nl + k)
                leaf = leaf.reshape(*lead, *shape)
            leaves.append(leaf.to(dt))
        return tree_unflatten(self.template, leaves)

    def local_params(self, chunk: torch.Tensor):
        """(..., d_loc) chunk of one model rank -> that rank's local leaves
        in their template dtypes (views where that is the chunk's): each
        split leaf's slice, each replicated leaf whole.  The chunk already
        is the rank's (``local_block`` of the plane along the model axis),
        so no rank index is needed; leading axes (a member axis) are
        kept."""
        lead = tuple(chunk.shape[:-1])
        leaves = []
        for shape, dt, k, off, s_loc in self.recs:
            loc = shape if k is None else (
                shape[:k] + (shape[k] // self.msize,) + shape[k + 1:])
            leaves.append(chunk[..., off:off + s_loc].reshape(*lead, *loc)
                          .to(dt))
        return tree_unflatten(self.template, leaves)

    def local_to_chunk(self, params) -> torch.Tensor:
        """The inverse of ``local_params``: a rank's local leaves (with any
        leading axes) -> its (..., d_loc) fp32 chunk."""
        leaves = tree_leaves(params)
        lead = tuple(leaves[0].shape[:leaves[0].dim()
                                     - len(self.recs[0][0])])
        flat = [x.reshape(*lead, -1).to(torch.float32) for x in leaves]
        pad = self.d_loc - sum(r[4] for r in self.recs)
        if pad:
            flat.append(leaves[0].new_zeros(*lead, pad, dtype=torch.float32))
        return torch.cat(flat, dim=-1)


def make_tp_plane_spec(params_template, specs, *, msize: int,
                       axis: str = "model") -> TPPlaneSpec:
    """The TP plane layout of one level from its params template and the
    family's per-leaf specs (``FLModelFamily.param_specs``; for the LM
    family ``launch.sharding.tp_specs``).  A leaf whose split dim does not
    divide ``msize`` is demoted to replicated, as ``tp_specs`` does."""
    leaves = tree_leaves(params_template)
    spec_leaves = _spec_leaves(params_template, specs)
    recs, off, d = [], 0, 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = tuple(leaf.shape)
        k = spec.get(axis)
        if k is not None and (k >= len(shape) or shape[k] % msize != 0):
            k = None
        size = math.prod(shape)
        s_loc = size // msize if k is not None else size
        recs.append((shape, leaf.dtype, k, off, s_loc))
        off += s_loc
        d += size
    d_loc = -(-off // PLANE_ALIGN) * PLANE_ALIGN
    return TPPlaneSpec(d=d, d_pad=msize * d_loc, msize=msize, d_loc=d_loc,
                       template=tree_unflatten(params_template,
                                               [None] * len(leaves)),
                       recs=tuple(recs), axis=axis)


def _spec_leaves(template, specs) -> list:
    """``specs`` (a spec dict per leaf of ``template``) in leaf order."""
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in _spec_leaves(template[k], specs[k])]
    if isinstance(template, (list, tuple)):
        return [x for t, s in zip(template, specs)
                for x in _spec_leaves(t, s)]
    return [specs]


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
