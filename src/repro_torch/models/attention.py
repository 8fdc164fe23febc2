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

Every route, decode included, multiplies the scores by
``cfg.softmax_scale``: ``attn_scale`` where set (a port-only field), else
head_dim ** -0.5 as in JAX.

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
whole cache, or every head against its block of a cache split along the
head dim or, under ``seq_shard_ctx``, along the sequence (the partial
softmax combined over the ranks); the whole step with no context.
``cross_attn_decode`` reads the enc-dec model's cached encoder K/V alike.
"""
from __future__ import annotations

from contextlib import contextmanager

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
    scores = scores * cfg.softmax_scale
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
    scale = cfg.softmax_scale
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
                                         softcap=cfg.attn_softcap,
                                         sm_scale=cfg.softmax_scale)
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


# ------------------------------------------------ the sequence-split cache
_SEQ: "tuple | None" = None     # (mesh, {cache leaf name: axes}) or None


@contextmanager
def seq_shard_ctx(mesh, axes: dict):
    """Within this block a decode cache's sequence dim is split over mesh
    axes: ``axes`` maps a cache leaf name ("k" for self-attention, "xk"
    for enc-dec cross-attention) to the axes (major first) its dim 2
    splits along (``launch.sharding.cache_specs``' "seq" layout and its
    batch-1 layout)."""
    global _SEQ
    prev = _SEQ
    _SEQ = (mesh, {k: tuple(v) for k, v in axes.items()})
    try:
        yield
    finally:
        _SEQ = prev


def _seq_axes(name: str) -> tuple:
    """The axes of more than one rank the ``name`` cache's sequence splits
    along (none without a context)."""
    if _SEQ is None:
        return ()
    from repro_torch.launch.mesh import axis_size
    mesh, axes = _SEQ
    return tuple(a for a in axes.get(name, ()) if axis_size(mesh, a) > 1)


def _seq_offset(axes: tuple, n_local: int) -> int:
    """The first absolute position of this rank's slice of a sequence
    split along ``axes`` (``launch.sharding.local_block``'s order)."""
    from repro_torch.launch.mesh import axis_size
    mesh = _SEQ[0]
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return idx * n_local


def _seq_reduce(x, axes: tuple, op: str = "sum"):
    """``x``, a temporary, summed (or maxed) over ``axes`` in place."""
    from repro_torch.launch import sharding
    x = x.contiguous()
    for a in axes:
        x = sharding.all_reduce(_SEQ[0], x, a, op)
    return x


def _attend_cache(cfg: ModelConfig, q, kc, vc, mask, seq: tuple):
    """One query position of every head, q (B, 1, H, dh), against a
    cache block kc, vc (B, T, KV, dh): the rank's slice of the head dim
    when dh < hd (the partial scores summed over the model axis), of the
    positions when ``seq`` names the axes they split along (the partial
    softmax's max, sum and weighted values reduced over them).  mask (T,)
    bool by absolute position.  Returns (B, 1, H, dh)."""
    B, _, H, dh = q.shape
    KV = kc.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, 1, KV, H // KV, dh),
                     kc).to(torch.float32)
    if dh != cfg.head_dim:
        s = tp.reduce_from_tp(s)
    s = softcap(s * cfg.softmax_scale, cfg.attn_softcap)
    s = torch.where(mask[None, None, None, None], s, NEG_INF)
    if not seq:
        probs = torch.softmax(s, dim=-1).to(vc.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, vc)
    else:
        mx = _seq_reduce(s.amax(dim=-1), seq, "max")
        e = torch.exp(s - mx[..., None])
        den = _seq_reduce(e.sum(dim=-1), seq)
        num = _seq_reduce(torch.einsum("bkgst,btkd->bskgd", e.to(vc.dtype),
                                       vc).to(torch.float32), seq)
        out = (num / den.permute(0, 3, 1, 2)[..., None]).to(vc.dtype)
    return out.reshape(B, 1, H, dh)


def _heads_out(p, cfg: ModelConfig, out):
    """``wo`` of every head's output (B, S, H, hd) whole on this rank: its
    slice into a row-split ``wo`` (whole heads or not), summed over the
    model axis."""
    B, S = out.shape[:2]
    flat = out.reshape(B, S, cfg.q_dim)
    if tp.splits(cfg.q_dim):
        return tp.reduce_from_tp(tp.scatter_to_tp(flat) @ p["wo"])
    return flat @ p["wo"]


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, cfg: ModelConfig, cache, x, pos, *, local: bool = False):
    """x: (B,1,d); pos: the current position (an int).  Returns
    (out, cache), the cache a new dict (its tensors new where written).

    Under a tensor-parallel context the cache is this rank's block of
    ``launch.sharding.cache_specs``' layouts: every K/V head whole
    ("batch"), split along the head dim ("hd"; the cache's last dim says
    which), or split along the sequence (``seq_shard_ctx``: "seq", and a
    batch of 1 on the data axes).  The new token's K/V are gathered whole
    and written by the rank that holds ``pos``.  Where the query heads
    split evenly over a whole-head, whole-sequence cache the rank runs its
    own heads (``wq`` / ``wo`` split as in ``attn_forward``); otherwise it
    gathers q whole, attends with every head over its block
    (``_attend_cache``) and takes its slice of the output into ``wo``'s
    rows.  With no context nothing splits, every tp operation is an
    identity, and this is the whole decode step."""
    B = x.shape[0]
    pos = int(pos)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, r = tp.tp_size(), tp.tp_rank()
    q_split, kv_split = tp.splits(cfg.q_dim), tp.splits(cfg.kv_dim)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    xd = tp.copy_to_tp(x)
    q = (xd if q_split else x) @ p["wq"]
    k, v = (tp.gather_from_tp(t) if kv_split else t
            for t in ((xd if kv_split else x) @ p[w] for w in ("wk", "wv")))
    dh = cache["k"].shape[-1]
    seq = _seq_axes("k")
    heads = q_split and H % m == 0 and dh == hd and not seq
    Hq = H // m if heads else H
    if not heads and q_split:
        q = tp.gather_from_tp(q)
    q, k = _norm_rope(cfg, q.reshape(B, 1, Hq, hd), k.reshape(B, 1, KV, hd),
                      positions, p.get("q_norm"), p.get("k_norm"))
    v = v.reshape(B, 1, KV, hd)
    if dh != hd:
        q, k, v = (t[..., r * dh:(r + 1) * dh] for t in (q, k, v))
    T = cache["k"].shape[1]
    off = _seq_offset(seq, T) if seq else 0
    kc, vc = cache["k"], cache["v"]
    if off <= pos < off + T:              # this rank's slice holds pos
        at = torch.tensor([pos - off], device=x.device)
        kc = kc.index_copy(1, at, k.to(kc.dtype))
        vc = vc.index_copy(1, at, v.to(vc.dtype))
    j = off + torch.arange(T, device=x.device)
    mask = j <= pos
    if local and cfg.sliding_window > 0:
        mask = mask & ((pos - j) < cfg.sliding_window)
    if heads:
        sel = _local_kv_heads(cfg, Hq, r)
        out = _sdpa(cfg, q, kc[:, :, sel], vc[:, :, sel],
                    mask[None, None, None])
        y = tp.reduce_from_tp(out.reshape(B, 1, Hq * hd) @ p["wo"])
        return y, {"k": kc, "v": vc}
    out = _attend_cache(cfg, q, kc, vc, mask, seq)
    if dh != hd:
        out = tp.gather_from_tp(out, -1)
    return _heads_out(p, cfg, out), {"k": kc, "v": vc}


def cross_attn_decode(p, cfg: ModelConfig, x, xk, xv):
    """One decoder position's cross-attention, x (B,1,d), over the cached
    encoder K/V xk, xv (B,T,KV,·) in the cache's layout (whole, split
    along the head dim, or along the source positions:
    ``seq_shard_ctx``'s "xk"), as ``attn_decode`` attends.  With no
    context nothing splits: ``cross_attn_forward`` at one position."""
    B = x.shape[0]
    hd, dh, r = cfg.head_dim, xk.shape[-1], tp.tp_rank()
    q_split = tp.splits(cfg.q_dim)
    q = (tp.copy_to_tp(x) if q_split else x) @ p["wq"]
    if q_split:
        q = tp.gather_from_tp(q)
    q = q.reshape(B, 1, cfg.n_heads, hd)
    if dh != hd:
        q = q[..., r * dh:(r + 1) * dh]
    mask = torch.ones((xk.shape[1],), dtype=torch.bool, device=x.device)
    out = _attend_cache(cfg, q, xk, xv, mask, _seq_axes("xk"))
    if dh != hd:
        out = tp.gather_from_tp(out, -1)
    return _heads_out(p, cfg, out)
