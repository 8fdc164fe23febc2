"""Grouped-query attention with sliding window, softcap, qk-norm, (M-)RoPE.

A torch copy of ``repro.models.attention``.  ``attn_forward`` (train /
prefill) has three routes chosen by ``cfg.attn_impl``, whose values are
the JAX package's so configurations carry across:

* ``"jnp"``: ``_sdpa``, scores materialised (the plain einsum form);
* ``"blocked"``: ``_sdpa_blocked``, online softmax over key blocks in plain
  torch, never materialising the (S, T) scores;
* ``"pallas"``: in the port, the hand-written CUDA flash kernel
  (``kernels/flash``), through ``flash_ops.flash_attention``, whose backward
  recomputes through the plain reference as JAX's ``custom_vjp`` does.  On
  CPU tensors the same route runs the kernel's plain version.  As in JAX,
  the kernel serves causal attention without M-RoPE; anything else takes
  the ``"jnp"`` route.

The serving half: ``cross_kv`` / ``cross_attn_forward`` (the enc-dec
decoder's cross-attention, no positional encoding), ``init_attn_cache`` and
``attn_decode`` (one new token against a KV cache, the sliding-window mask
for ``local=True``).  Decode takes the plain ``_sdpa`` route whatever
``attn_impl`` says, as JAX's does.  Where JAX writes the new key and value
with ``dynamic_update_slice``, ``attn_decode`` returns a new cache tensor
(``index_copy``), so a caller's old cache is never written.

Under a tensor-parallel context (``models.tp``) ``attn_forward`` runs this
rank's slice: column-parallel ``wq`` / ``wk`` / ``wv`` give local heads,
RoPE and qk-norm run per local head, the flash kernel (or the plain route)
runs on the local heads, and the row-parallel ``wo`` ends in one
``reduce_from_tp``.  Where a split does not fall on heads (a demoted leaf,
or a ``wk`` split that cuts through a head), the cut tensor is gathered
over the model axis: K/V whole before the local query heads pick theirs,
or, when the query heads do not split, the attention whole on every rank.
``attn_decode`` has the one body too: this rank's query heads against a
whole or head-dim-split cache, the whole step with no context.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import tp
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       rms_head_norm, softcap)

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def init_attn(generator, cfg: ModelConfig, dtype):
    p = init_cross_attn(generator, cfg, dtype)
    if cfg.qk_norm:
        dev = generator.device
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=dtype, device=dev)
    return p


def _norm_rope(cfg: ModelConfig, q, k, positions, q_norm, k_norm):
    """qk-norm and (M-)RoPE, per head: q (..., S, H, hd), k (..., S, KV,
    hd) with any number of heads."""
    x_dim = q.dim() - 1
    if cfg.qk_norm:
        q = rms_head_norm(q_norm, q)
        k = rms_head_norm(k_norm, k)
    if cfg.mrope_sections:
        if positions.dim() == x_dim - 1:          # (B,S) -> identical streams
            positions = positions[None].expand(3, *positions.shape)
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q:(B,S,H,hd) k,v:(B,T,KV,hd) mask:(B,1,S,T) or (1,1,S,T) bool."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = scores * (hd ** -0.5)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def _sdpa_blocked(cfg: ModelConfig, q, k, v, *, causal: bool, window: int,
                  block: int = 1024):
    """Flash-style blocked attention in plain torch: a loop over key blocks
    with online-softmax running (m, l, acc).  Never materializes the (S,T)
    score matrix.  Same math as _sdpa to fp32 accuracy."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    bk = min(block, T)
    if T % bk:
        raise ValueError(f"blocked attention: T={T} is not a multiple of "
                         f"the block {bk}")
    scale = hd ** -0.5
    qr = q.reshape(B, S, KV, G, hd).to(torch.float32)
    q_idx = torch.arange(S, device=q.device)
    m = torch.full((B, KV, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(T // bk):
        kblk = k[:, j * bk:(j + 1) * bk].to(torch.float32)
        vblk = v[:, j * bk:(j + 1) * bk].to(torch.float32)
        s = torch.einsum("bskgd,btkd->bkgst", qr, kblk) * scale
        s = softcap(s, cfg.attn_softcap)
        k_idx = j * bk + torch.arange(bk, device=q.device)
        mask = torch.ones((S, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_idx[None, :] <= q_idx[:, None])
        if window > 0:
            mask = mask & ((q_idx[:, None] - k_idx[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bkgst,btkd->bkgsd", p, vblk))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.movedim(3, 1)                       # (B,S,KV,G,hd)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _causal_mask(S: int, window: int, device=None):
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & ((i - j) < window)
    return m[None]  # (1,S,T)


def _attend(cfg: ModelConfig, q, k, v, *, window: int, causal: bool):
    """Self-attention of q (B, S, H, hd) over k, v (B, S, KV, hd) by
    ``cfg.attn_impl``'s route."""
    S = q.shape[1]
    if cfg.attn_impl == "pallas" and not cfg.mrope_sections and causal:
        return flash_ops.flash_attention(q, k, v, causal=True, window=window,
                                         softcap=cfg.attn_softcap)
    if cfg.attn_impl == "blocked":
        return _sdpa_blocked(cfg, q, k, v, causal=causal, window=window)
    if causal:
        mask = _causal_mask(S, window, q.device)[:, None]        # (1,1,S,T)
    else:
        mask = torch.ones((1, 1, S, S), dtype=torch.bool, device=q.device)
    return _sdpa(cfg, q, k, v, mask)


def _local_kv_heads(cfg: ModelConfig, Hl: int, r: int):
    """The K/V heads rank ``r``'s query heads [r·Hl, (r+1)·Hl) read: a
    slice when they form whole grouped-query groups in order, else one
    K/V head per query head (an index list)."""
    G = cfg.n_heads // cfg.n_kv_heads
    idx = [(r * Hl + i) // G for i in range(Hl)]
    n = idx[-1] - idx[0] + 1
    if Hl % n == 0 and idx == [idx[0] + i // (Hl // n) for i in range(Hl)]:
        return slice(idx[0], idx[0] + n)
    return idx


def attn_forward(p, cfg: ModelConfig, x, positions, *, local: bool = False,
                 causal: bool = True):
    """Self-attention of x (B, S, d); under a tensor-parallel context this
    rank's slice (the module docstring).  With no context nothing splits,
    every tp operation is an identity, and the last branch is the whole
    attention."""
    window = cfg.sliding_window if local else 0
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, r = tp.tp_size(), tp.tp_rank()
    xd = tp.copy_to_tp(x)
    q_split, kv_split = tp.splits(cfg.q_dim), tp.splits(cfg.kv_dim)
    q = (xd if q_split else x) @ p["wq"]
    k = (xd if kv_split else x) @ p["wk"]
    v = (xd if kv_split else x) @ p["wv"]
    qn, kn = p.get("q_norm"), p.get("k_norm")
    if q_split and H % m == 0:
        # local query heads; the norms' scales enter per-rank computation
        Hl = H // m
        q = q.reshape(B, S, Hl, hd)
        if kv_split and KV % m == 0:
            k = k.reshape(B, S, KV // m, hd)
            v = v.reshape(B, S, KV // m, hd)
        else:
            sel = _local_kv_heads(cfg, Hl, r)
            k, v = (tp.copy_to_tp(tp.gather_from_tp(t) if kv_split else t)
                    .reshape(B, S, KV, hd)[:, :, sel] for t in (k, v))
        if cfg.qk_norm:
            qn, kn = tp.copy_to_tp(qn), tp.copy_to_tp(kn)
        q, k = _norm_rope(cfg, q, k, positions, qn, kn)
        out = _attend(cfg, q, k, v, window=window, causal=causal)
        return tp.reduce_from_tp(out.reshape(B, S, Hl * hd) @ p["wo"])
    # the query heads do not split: the attention runs whole on every rank
    q, k, v = ((tp.gather_from_tp(t) if s else t)
               for t, s in ((q, q_split), (k, kv_split), (v, kv_split)))
    q, k = _norm_rope(cfg, q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
                      positions, qn, kn)
    out = _attend(cfg, q, k, v.reshape(B, S, KV, hd), window=window,
                  causal=causal).reshape(B, S, cfg.q_dim)
    if q_split:                         # wo's rows split, cutting heads
        return tp.reduce_from_tp(tp.scatter_to_tp(out) @ p["wo"])
    return out @ p["wo"]


def init_cross_attn(generator, cfg: ModelConfig, dtype):
    return {
        "wq": dense_init(generator, cfg.d_model, cfg.q_dim, dtype),
        "wk": dense_init(generator, cfg.d_model, cfg.kv_dim, dtype),
        "wv": dense_init(generator, cfg.d_model, cfg.kv_dim, dtype),
        "wo": dense_init(generator, cfg.q_dim, cfg.d_model, dtype),
    }


def cross_kv(p, cfg: ModelConfig, enc_out):
    """The encoder output's K/V heads, this rank's under a split of
    ``wk`` / ``wv`` (the heads then enter per-rank computation)."""
    B, T, _ = enc_out.shape
    if tp.splits(cfg.kv_dim):
        enc_out = tp.copy_to_tp(enc_out)
    k = (enc_out @ p["wk"]).reshape(B, T, -1, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, T, -1, cfg.head_dim)
    return k, v


def cross_attn_forward(p, cfg: ModelConfig, x, k, v):
    """x: (B,S,d); k, v: (B,T,KV,hd) from the encoder.  No positional
    encoding."""
    B, S, _ = x.shape
    split = tp.splits(cfg.q_dim)
    if split:
        x = tp.copy_to_tp(x)
    q = (x @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(cfg, q, k, v, mask)
    y = out.reshape(B, S, q.shape[2] * cfg.head_dim) @ p["wo"]
    return tp.reduce_from_tp(y) if split else y


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, cfg: ModelConfig, cache, x, pos, *, local: bool = False):
    """x: (B,1,d); pos: the current position (an int).  Returns
    (out, cache), the cache a new dict of new tensors.

    Under a tensor-parallel context, one decode step of this rank's query
    heads (``wq`` / ``wo`` split as in ``attn_forward``; the query heads
    must divide the model axis when ``wq`` splits) against a cache that
    holds every K/V head, either whole or split along the head dim
    (``launch.sharding.cache_specs``' "batch" and "hd" layouts; the
    cache's last dim says which).  The new token's K/V are gathered whole
    before they are written.  With the head dim split, every rank scores
    all heads on its slice of it: the partial scores are summed over the
    ranks, and the slices of the output gathered.  With no context
    nothing splits, every tp operation is an identity, and this is the
    whole decode step."""
    B = x.shape[0]
    pos = int(pos)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, r = tp.tp_size(), tp.tp_rank()
    q_split, kv_split = tp.splits(cfg.q_dim), tp.splits(cfg.kv_dim)
    if q_split and H % m:
        raise ValueError(f"decode: {H} query heads do not split {m} ways")
    Hl = H // m if q_split else H
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    xd = tp.copy_to_tp(x)
    q = ((xd if q_split else x) @ p["wq"]).reshape(B, 1, Hl, hd)
    k, v = (tp.gather_from_tp(t) if kv_split else t
            for t in ((xd if kv_split else x) @ p[w] for w in ("wk", "wv")))
    q, k = _norm_rope(cfg, q, k.reshape(B, 1, KV, hd), positions,
                      p.get("q_norm"), p.get("k_norm"))
    v = v.reshape(B, 1, KV, hd)
    dh = cache["k"].shape[-1]
    split_hd = dh != hd
    if split_hd:
        k, v = k[..., r * dh:(r + 1) * dh], v[..., r * dh:(r + 1) * dh]
    at = torch.tensor([pos], device=x.device)
    kc = cache["k"].index_copy(1, at, k.to(cache["k"].dtype))
    vc = cache["v"].index_copy(1, at, v.to(cache["v"].dtype))
    j = torch.arange(kc.shape[1], device=x.device)
    mask = j <= pos
    if local and cfg.sliding_window > 0:
        mask = mask & ((pos - j) < cfg.sliding_window)
    if not split_hd:
        sel = _local_kv_heads(cfg, Hl, r) if q_split else slice(None)
        out = _sdpa(cfg, q, kc[:, :, sel], vc[:, :, sel],
                    mask[None, None, None])
    else:
        qa = tp.gather_from_tp(q, 2) if q_split else q      # (B,1,H,hd)
        qs = qa[..., r * dh:(r + 1) * dh].reshape(B, 1, KV, H // KV, dh)
        scores = tp.reduce_from_tp(torch.einsum(
            "bskgd,btkd->bkgst", qs, kc).to(torch.float32)) * hd ** -0.5
        scores = softcap(scores, cfg.attn_softcap)
        scores = torch.where(mask[None, None, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(vc.dtype)
        out = tp.gather_from_tp(torch.einsum(
            "bkgst,btkd->bskgd", probs, vc).reshape(B, 1, H, dh), -1)
        if q_split:
            out = out[:, :, r * Hl:(r + 1) * Hl]
    y = out.reshape(B, 1, Hl * hd) @ p["wo"]
    return (tp.reduce_from_tp(y) if q_split else y), {"k": kc, "v": vc}
