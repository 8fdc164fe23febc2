"""Wrapper of the flash kernel (``csrc/flash.cu``) and its autograd rule.

``flash_attention_bh`` is the kernel's wrapper on head-flattened tensors,
q: (B·H, S, hd), k, v: (B·KV, S, hd).  A CPU tensor goes to the plain
version (``ref.attention_bh_gqa``); a CUDA tensor goes to the kernel that
``_variant`` names for its head size and dtype, or the call raises (there is
no fallback from one kernel to another).  ``flash_attention_bh.launches``
counts the launches, one per call.

``flash_attention`` takes the model layout, q: (B, S, H, hd), k, v:
(B, S, KV, hd), through ``FlashAttention``, a ``torch.autograd.Function``
written for ``torch.func``:

* the forward is the kernel (or, on CPU tensors, its plain version);
* the backward recomputes attention in fp32 from the saved q, k, v through
  the plain grouped-query reference and returns its VJP
  (``ref.ref_gqa_vjp``), as the JAX ``custom_vjp`` (``repro.kernels.flash
  .ops``) does.  There is no backward kernel, because the JAX package has
  none;
* the ``vmap`` rule folds the vmapped axis (the cluster's members in
  ``core.client``) into the batch axis and calls the kernel once, so a
  whole cluster's attention is one launch per layer and step.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash import ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)
# the C entry point's variant numbers (csrc/flash.cu)
VARIANTS = {"simt": 0, "tf32x3": 1, "wgmma": 2}
BLOCK_Q = 64                  # the fewest query rows a thread block takes


def _variant(hd: int, dtype) -> str:
    """The kernel a CUDA call takes: ``"simt"`` (fp32 FMAs on the CUDA cores)
    for hd 8-32; on the tensor cores for hd 64-256, ``"tf32x3"`` (split-TF32
    ``mma.sync``) for fp32 and ``"wgmma"`` for bf16."""
    if hd not in HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"flash: no kernel for hd {hd} in {dtype}")
    if hd not in TC_HEAD_DIMS:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def flash_attention_bh(q, k, v, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, sm_scale: float | None = None,
                       heads: int | None = None):
    """q: (B·H, S, hd); k, v: (B·KV, S, hd) -> (B·H, S, hd) in q's dtype.

    With ``heads`` (H, the query heads per batch) and B·KV < B·H, query row
    ``b`` reads K/V row ``(b // H) · KV + (b % H) // G`` in place.  The
    kernel takes self-attention (one S for q, k and v) at any S: ragged
    tiles are masked in the kernel, where the JAX wrapper asserts that S
    divides by its block."""
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return ref.attention_bh_gqa(q, k, v, causal=causal, window=window,
                                    softcap=softcap, sm_scale=sm_scale,
                                    heads=heads)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash: inputs on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash takes fp32 or bf16 q, k, v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (BH, S, hd), (BKV, S, hd)"
                         " twice")
    BH, S, hd = q.shape
    BKV = k.shape[0]
    if k.shape[1:] != (S, hd) or hd not in HEAD_DIMS or S == 0:
        raise ValueError(f"flash: needs one S > 0 for q, k, v and hd in "
                         f"{HEAD_DIMS}, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    H, KV = 1, 1                                  # identity row map
    if BKV != BH:
        if heads is None or BH % heads or (BKV * heads) % BH:
            raise ValueError(f"flash: {BKV} K/V rows for {BH} query rows "
                             f"need heads=H with a whole KV per batch, got "
                             f"heads={heads}")
        H, KV = heads, BKV * heads // BH
        if H % KV:
            raise ValueError(f"flash: {H} query heads over {KV} KV heads")
    n_q = -(-S // BLOCK_Q)
    if BH * n_q >= 2 ** 31:
        raise ValueError(f"flash: {BH} rows x {n_q} tiles out of range")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash: q, k, v must be contiguous")
    variant = _variant(hd, q.dtype)
    if variant == "wgmma" and (BH * S >= 2 ** 31 or any(
            t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash: the bf16 kernel's tensor maps take q, k, v "
                         "at 16-byte-aligned addresses and B·H·S < 2^31")
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    fn = _build.kernel_fn("flash", "flash_fwd_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), BH, H, KV, S, hd, sm_scale,
                        int(causal), int(window), softcap, _DTYPES[q.dtype],
                        VARIANTS[variant], stream), "flash")
    flash_attention_bh.launches += 1
    return out


flash_attention_bh.launches = 0


class FlashAttention(torch.autograd.Function):
    """Model-layout flash attention: kernel forward, recompute backward
    through the plain reference, one launch for a whole vmapped axis."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, sm_scale):
        B, S, H, hd = q.shape
        KV = k.shape[2]
        qb = q.transpose(1, 2).reshape(B * H, S, hd).contiguous()
        kb = k.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
        vb = v.transpose(1, 2).reshape(B * KV, S, hd).contiguous()
        ob = flash_attention_bh(qb, kb, vb, causal=causal, window=window,
                                softcap=softcap, sm_scale=sm_scale, heads=H)
        return ob.reshape(B, H, S, hd).transpose(1, 2).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, sm_scale = inputs
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.ref_gqa_vjp(q, k, v, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap, sm_scale):
        n = info.batch_size

        def fold(x, d):
            x = x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
            return x.reshape(n * x.shape[1], *x.shape[2:])

        out = FlashAttention.apply(fold(q, in_dims[0]), fold(k, in_dims[1]),
                                   fold(v, in_dims[2]), causal, window,
                                   softcap, sm_scale)
        return out.reshape(n, out.shape[0] // n, *out.shape[1:]), 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, sm_scale: float | None = None):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd); the scores
    scaled by ``sm_scale`` (hd ** -0.5 where None), in the forward kernel
    and in the recomputing backward alike."""
    return FlashAttention.apply(q, k, v, causal, int(window), float(softcap),
                                None if sm_scale is None else float(sm_scale))
