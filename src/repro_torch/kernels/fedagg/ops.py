"""Wrapper of the fedagg kernel (``csrc/fedagg.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel, or the call raises.  ``weighted_aggregate.launches`` counts the
kernel's launches.  ``aggregate_plane`` and ``aggregate_tree`` are JAX's
wrappers of the same names: the kernel on a plane of any width, and on a
client-stacked pytree.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels import _build
from repro_torch.kernels.fedagg import ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)
MAX_ROWS = 12 * 1024          # the weights live in 48 KB of shared memory


def weighted_aggregate(plane: torch.Tensor, weights: torch.Tensor):
    """plane (C, D) fp32, weights (C,) fp32 -> (D,) fp32
    ``out[d] = sum_c weights[c] * plane[c, d]``."""
    if plane.device.type == "cpu" and weights.device.type == "cpu":
        return ref.weighted_aggregate(plane, weights)
    if plane.device.type != "cuda" or weights.device != plane.device:
        raise ValueError(f"fedagg: plane on {plane.device}, weights on "
                         f"{weights.device}; both must be on one CUDA device")
    if plane.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"fedagg takes fp32, got {plane.dtype}/"
                        f"{weights.dtype}")
    if plane.dim() != 2 or weights.shape != (plane.shape[0],):
        raise ValueError(f"fedagg: plane {tuple(plane.shape)} and weights "
                         f"{tuple(weights.shape)} are not (C, D) and (C,)")
    C, D = plane.shape
    if not 1 <= C <= MAX_ROWS or D % 4 or D == 0:
        raise ValueError(f"fedagg: needs 1 <= C <= {MAX_ROWS} and D a "
                         f"positive multiple of 4, got C={C}, D={D}")
    if not (plane.is_contiguous() and weights.is_contiguous()):
        raise ValueError("fedagg: plane and weights must be contiguous")
    if plane.data_ptr() % 16:
        raise ValueError("fedagg: the plane must be 16-byte aligned")
    fn = _build.kernel_fn("fedagg", "fedagg_launch", _ARGTYPES)
    with torch.cuda.device(plane.device):
        out = torch.empty(D, device=plane.device, dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(plane.data_ptr(), weights.data_ptr(),
                        out.data_ptr(), C, D, stream), "fedagg")
    weighted_aggregate.launches += 1
    return out


weighted_aggregate.launches = 0


def aggregate_plane(plane: torch.Tensor, weights: torch.Tensor):
    """Weighted aggregate of a (C, D) plane of any D -> (D,) fp32.  The
    kernel loads four columns at a time, so a D that is not a multiple of
    4 is zero-padded to one and the result sliced back (JAX's wrapper
    halves its block instead); padded columns contract to nothing."""
    plane = plane.to(torch.float32)
    weights = weights.to(torch.float32).contiguous()
    D = plane.shape[1]
    pad = (-D) % 4
    if pad:
        plane = torch.nn.functional.pad(plane, (0, pad))
    return weighted_aggregate(plane.contiguous(), weights)[:D]


def aggregate_tree(params_stack, weights: torch.Tensor):
    """params_stack: a pytree whose leaves share a leading client axis C
    -> the aggregated pytree: every leaf flattened to (C, -1), the pieces
    concatenated into one fp32 plane, aggregated, and each leaf cut back
    out in its own shape and dtype."""
    leaves = tree_leaves(params_stack)
    C = leaves[0].shape[0]
    flats = [x.reshape(C, -1).to(torch.float32) for x in leaves]
    out = aggregate_plane(torch.cat(flats, dim=1), weights)
    parts, pos = [], 0
    for leaf, f in zip(leaves, flats):
        sz = f.shape[1]
        parts.append(out[pos:pos + sz].reshape(leaf.shape[1:])
                     .to(leaf.dtype))
        pos += sz
    return tree_unflatten(params_stack, parts)
