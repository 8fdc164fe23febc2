"""Wrapper of the grouped GEMM kernels (``csrc/grouped_gemm.cu``) and
their autograd and vmap rules.

``grouped_rows`` and ``grouped_wgrad`` are the kernels' wrappers.  A CPU
tensor goes to the plain version (``ref.py``); a CUDA tensor goes to the
kernel, or the call raises.  Each launch is counted as
``moe/grouped_gemm_launches`` in the registry of the observability made
current (``obs.current``: the engine's during ``FedRAC.train``).

``grouped_mm(x, w, offsets)`` is the differentiable product, through
``GroupedMM``, a ``torch.autograd.Function`` written for ``torch.func``:

* the forward is the rows kernel: group g's rows of x times ``w[g]``;
* the backward, inside the span ``moe_bwd``, is the same kernel on the
  transposed weights for dx, and the wgrad kernel, each group's rows
  reduced, for dw;
* the ``vmap`` rule folds the vmapped axis (the cluster's members in
  ``core.client``) into the group axis: member m's group e becomes group
  m·E + e, its offsets shifted by m·M, so a whole cluster's product is one
  launch.  Weights that are not vmapped (one model over a vmapped batch)
  stay as they are, and the kernel takes group g's matrix as
  ``w[g % E]``.

With ``routed=True`` the forward counts its rows as ``moe/routed_rows``:
the MoE layer passes it on the first of its products.  The count sits in
the op because only its vmap rule sees a cluster's rows whole; the layer
sees one member's.  The offsets stay on
the device; the launch bounds its grid by the row count and the groups, so
nothing waits for the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.grouped_gemm import ref

_ROWS_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_WGRAD_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
MAX_GROUPS = 65535            # the wgrad grid's z dimension


def _count(name: str, n: float = 1.0):
    cur = obs.current()
    if cur.on:
        cur.registry.counter(name).inc(n)


def _check(what, tensors, offsets):
    devices = {t.device for t in tensors} | {offsets.device}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"grouped_gemm {what}: inputs on "
                         f"{sorted(map(str, devices))}; all must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"grouped_gemm {what} takes fp32, got "
                        f"{[t.dtype for t in tensors]}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise TypeError(f"grouped_gemm {what}: offsets must be a 1-D int64 "
                        f"tensor, got {offsets.dtype} {tuple(offsets.shape)}")
    if not all(t.is_contiguous() for t in (*tensors, offsets)):
        raise ValueError(f"grouped_gemm {what}: inputs must be contiguous")


def grouped_rows(x, w, offsets, trans: bool = False):
    """x (M, K), w (Gw, K, N) or, with ``trans``, (Gw, N, K), offsets
    (G + 1,) int64 with offsets[0] = 0, offsets[G] = M and G a multiple of
    Gw -> (M, N): rows [offsets[g], offsets[g + 1]) of x times
    ``w[g % Gw]``, transposed with ``trans``."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, K) and (Gw, K, N)")
    Gw = w.shape[0]
    N, Kw = (w.shape[1], w.shape[2]) if trans else (w.shape[2], w.shape[1])
    G = offsets.shape[0] - 1
    if Kw != x.shape[1] or G < 1 or G % Gw:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (trans={trans}) and {G} groups "
                         "do not fit")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ref.grouped_rows(x, w, offsets, trans)
    _check("rows", (x, w), offsets)
    M, K = x.shape
    fn = _build.kernel_fn("grouped_gemm", "grouped_gemm_rows_launch",
                          _ROWS_ARGS)
    with torch.cuda.device(x.device):
        y = torch.empty((M, N), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x.data_ptr(), w.data_ptr(), offsets.data_ptr(),
                        y.data_ptr(), M, K, N, G, Gw, int(trans), stream),
                     "grouped_gemm rows")
    _count("moe/grouped_gemm_launches")
    return y


def grouped_wgrad(x, d, offsets):
    """x (M, K), d (M, N), offsets (G + 1,) int64 -> (G, K, N): each
    group's rows of x, transposed, times its rows of d (zeros for a group
    with no rows)."""
    G = offsets.shape[0] - 1
    if x.dim() != 2 or d.dim() != 2 or x.shape[0] != d.shape[0] or G < 1:
        raise ValueError(f"grouped_gemm wgrad: x {tuple(x.shape)}, d "
                         f"{tuple(d.shape)} and {G} groups do not fit")
    if x.device.type == "cpu" and d.device.type == "cpu":
        return ref.grouped_wgrad(x, d, offsets)
    _check("wgrad", (x, d), offsets)
    if G > MAX_GROUPS:
        raise ValueError(f"grouped_gemm wgrad: {G} groups, at most "
                         f"{MAX_GROUPS}")
    (M, K), N = x.shape, d.shape[1]
    fn = _build.kernel_fn("grouped_gemm", "grouped_gemm_wgrad_launch",
                          _WGRAD_ARGS)
    with torch.cuda.device(x.device):
        out = torch.empty((G, K, N), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x.data_ptr(), d.data_ptr(), offsets.data_ptr(),
                        out.data_ptr(), M, K, N, G, stream),
                     "grouped_gemm wgrad")
    _count("moe/grouped_gemm_launches")
    return out


def _leading(t, dim, n: int):
    """``t`` with its vmapped ``dim`` in front (expanded where it has
    none)."""
    return t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)


def _fold_offsets(offsets, M: int):
    """(n, E + 1) per-member offsets -> (n·E + 1,): member m's groups
    shifted by m·M, one after the other."""
    n = offsets.shape[0]
    shift = torch.arange(n, device=offsets.device, dtype=offsets.dtype) * M
    starts = (offsets[:, :-1] + shift[:, None]).reshape(-1)
    return torch.cat([starts, offsets.new_full((1,), n * M)])


class GroupedWgrad(torch.autograd.Function):
    """``grouped_wgrad`` for ``torch.func``: the vmap rule folds the members
    into the groups and gives each member its (E, K, N) back."""

    @staticmethod
    def forward(x, d, offsets):
        return grouped_wgrad(x.contiguous(), d.contiguous(), offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, d, offsets):
        n = info.batch_size
        x, d = _leading(x, in_dims[0], n), _leading(d, in_dims[1], n)
        off = _leading(offsets, in_dims[2], n)
        M = x.shape[1]
        out = GroupedWgrad.apply(x.reshape(n * M, -1), d.reshape(n * M, -1),
                                 _fold_offsets(off, M))
        return out.reshape(n, -1, *out.shape[1:]), 0


class GroupedMM(torch.autograd.Function):
    """The differentiable grouped product (the module docstring)."""

    @staticmethod
    def forward(x, w, offsets, trans, routed):
        if routed:
            _count("moe/routed_rows", x.shape[0])
        return grouped_rows(x.contiguous(), w.contiguous(), offsets, trans)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, offsets, trans, _ = inputs
        ctx.save_for_backward(x, w, offsets)
        ctx.trans = trans

    @staticmethod
    def backward(ctx, g):
        x, w, offsets = ctx.saved_tensors
        with obs.current().tracer.span("moe_bwd", cat="fl"):
            dx = GroupedMM.apply(g, w, offsets, not ctx.trans, False)
            # y = x·W: dW = xᵀ·g; y = x·Wᵀ: dWᵀ = gᵀ·x
            dw = (GroupedWgrad.apply(g, x, offsets) if ctx.trans
                  else GroupedWgrad.apply(x, g, offsets))
            G, Gw = offsets.shape[0] - 1, w.shape[0]
            if Gw != G:         # groups that shared a matrix: summed
                dw = dw.reshape(G // Gw, Gw, *dw.shape[1:]).sum(0)
        return dx, dw, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, w, offsets, trans, routed):
        n = info.batch_size
        x = _leading(x, in_dims[0], n)
        M = x.shape[1]
        off = _fold_offsets(_leading(offsets, in_dims[2], n), M)
        if in_dims[1] is not None:
            w = w.movedim(in_dims[1], 0)
            w = w.reshape(-1, *w.shape[2:])
        y = GroupedMM.apply(x.reshape(n * M, -1), w, off, trans, routed)
        return y.reshape(n, M, -1), 0


def grouped_mm(x, w, offsets, *, trans: bool = False, routed: bool = False):
    """x (M, K), w (E, K, N) (or (E, N, K) with ``trans``), offsets (E + 1,)
    int64 -> (M, N), differentiable in x and w and vmappable."""
    return GroupedMM.apply(x, w, offsets, bool(trans), bool(routed))
