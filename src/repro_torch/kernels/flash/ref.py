"""Plain PyTorch versions of the flash kernel.

``attention_bh`` is the JAX oracle (``repro.kernels.flash.ref``) on
head-flattened tensors; ``attention_bh_gqa`` adds the kernel's grouped-query
row map, so it computes what the kernel wrapper computes; ``ref_gqa`` is the
model-layout reference (JAX ``ops._ref_gqa``) and ``ref_gqa_vjp`` its
gradient written out, which the backward of ``ops.FlashAttention`` uses.
"""
from __future__ import annotations

import torch

NEG = -2.0 ** 30


def _mask(Sq: int, Sk: int, causal: bool, window: int, device):
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ki <= qi)
    if window > 0:
        mask = mask & ((qi - ki) < window)
    return mask


def attention_bh(q, k, v, *, causal: bool = True, window: int = 0,
                 softcap: float = 0.0, sm_scale: float | None = None):
    """q: (BH, Sq, hd); k, v: (BH, Sk, hd).  fp32 softmax, the kernel's
    masking semantics (masked scores set to ``NEG``)."""
    hd = q.shape[-1]
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * sm_scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask[None], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def kv_rows(BH: int, BKV: int, heads: int | None, device=None):
    """The kernel's grouped-query row map: query row ``b`` of (B·H, …)
    reads K/V row ``(b // H) · KV + (b % H) // G`` of (B·KV, …)."""
    b = torch.arange(BH, device=device)
    if heads is None or BKV == BH:
        return b
    H = heads
    KV = BKV * H // BH
    return (b // H) * KV + (b % H) // (H // KV)


def attention_bh_gqa(q, k, v, *, causal: bool = True, window: int = 0,
                     softcap: float = 0.0, sm_scale: float | None = None,
                     heads: int | None = None):
    """What the kernel wrapper computes: ``attention_bh`` after the GQA row
    map (K/V rows repeated here; the kernel reads them in place)."""
    rows = kv_rows(q.shape[0], k.shape[0], heads, q.device)
    return attention_bh(q, k[rows], v[rows], causal=causal, window=window,
                        softcap=softcap, sm_scale=sm_scale)


def _gqa_probs(q, k, causal, window, softcap, sm_scale=None):
    """Model layout q: (B, S, H, hd), k: (B, T, KV, hd) -> the grouped
    query (B, S, KV, G, hd), the probabilities (B, KV, G, S, T), the capped
    tanh (or None) and the mask, all fp32.  The scores are scaled by
    ``sm_scale`` (hd ** -0.5 where None)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qr = q.reshape(B, S, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qr, k.to(torch.float32))
    s = s * (hd ** -0.5 if sm_scale is None else sm_scale)
    th = None
    if softcap > 0:
        th = torch.tanh(s / softcap)
        s = th * softcap
    mask = _mask(S, T, causal, window, q.device)
    s = torch.where(mask, s, NEG)
    return qr, torch.softmax(s, dim=-1), th, mask


def ref_gqa(q, k, v, *, causal: bool = True, window: int = 0,
            softcap: float = 0.0, sm_scale: float | None = None):
    """Grouped-query attention in model layout (q: (B, S, H, hd), k, v:
    (B, T, KV, hd)), fp32 math, output in q's dtype."""
    B, S, H, hd = q.shape
    _, p, _, _ = _gqa_probs(q, k, causal, window, softcap, sm_scale)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def ref_gqa_vjp(q, k, v, g, *, causal: bool = True, window: int = 0,
                softcap: float = 0.0, sm_scale: float | None = None):
    """(dq, dk, dv) of ``ref_gqa`` for the output cotangent ``g``,
    recomputed in fp32 from q, k, v and written out in plain ops (no
    ``torch.autograd`` inside, so ``torch.func`` transforms it):
    P = softmax(S), dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(dP ⊙ P)),
    times the softcap derivative 1 − tanh² and the scale (``sm_scale``,
    hd ** -0.5 where None), zero where
    masked; dQ = dS·K and dK = dSᵀ·Q with the query group summed."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qr, p, th, mask = _gqa_probs(q, k, causal, window, softcap, sm_scale)
    do = g.reshape(B, S, KV, H // KV, hd).to(torch.float32)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.to(torch.float32))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(mask, ds, 0.0)
    if th is not None:
        ds = ds * (1.0 - th * th)
    ds = ds * (hd ** -0.5 if sm_scale is None else sm_scale)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(torch.float32))
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qr)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def round_tf32(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: integer ops on the bits
    (add half of the dropped 13 bits to the magnitude, clear them)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def _mm_tf32(a, b, terms):
    """``a @ b`` as the fp32 tensor-core kernel takes it: each operand split
    into TF32 hi + lo and the product lo·hi + hi·lo + hi·hi (``terms=3``),
    or plain TF32, hi·hi alone (``terms=1``)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def attention_bh_split_tf32(q, k, v, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0,
                            sm_scale: float | None = None,
                            heads: int | None = None, terms: int = 3):
    """``attention_bh_gqa`` with both products in the arithmetic of the fp32
    tensor-core kernel (``csrc/flash_tc.cuh``): split-TF32 (``terms=3``) or
    plain TF32 (``terms=1``) operands, fp32 sums, the softmax unnormalised
    until the end.  A model of the kernel's arithmetic for the tests;
    nothing on the main path calls it."""
    hd = q.shape[-1]
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    rows = kv_rows(q.shape[0], k.shape[0], heads, q.device)
    q, k, v = (x.to(torch.float32) for x in (q, k[rows], v[rows]))
    s = _mm_tf32(q, k.transpose(1, 2), terms) * sm_scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask[None], s, NEG)
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    return _mm_tf32(p, v, terms) / p.sum(dim=-1, keepdim=True)
