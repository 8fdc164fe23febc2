"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
[arXiv:2405.04517], a torch copy of ``repro.models.xlstm_blocks``.

Both cells are exponential-gated with the max-stabiliser ``m_t``, whose
carry starts at -1e30 so that the first step's forget term vanishes and
``exp(-m)`` stays finite.  The mLSTM matrix memory
``C_t = f_t C_{t-1} + i_t v_t k_t^T`` and the sLSTM recurrence run as
Python loops over time where JAX runs ``lax.scan``; ``mlstm_impl="chunk"``
selects the chunkwise-parallel mLSTM (same math, the recurrence crossing
only chunk boundaries).  The sLSTM's GeGLU uses the tanh GELU, the default
of ``jax.nn.gelu``.

Under a tensor-parallel context (``models.tp``) each cell runs on this
rank's heads where the split falls on heads.  The mLSTM's ``up`` output is
gathered (its x / z halves are split contiguously, so a rank's columns are
not a matching slice of each half), its conv runs whole on the gathered
conv leaves, ``wq`` / ``wk`` / ``wv`` and the gate columns of ``w_if`` /
``b_if`` take the rank's heads, ``skip`` its channels, and ``down`` ends
in one ``reduce_from_tp``.  The mLSTM runs rank-partial (``models.tp``).  The
sLSTM's ``wx`` columns are head-major (all four gates of a head
together), so a rank's columns are whole heads: its cell runs on them with
its heads' slices of ``r`` and ``b``, its output is gathered, and the
GeGLU is a Megatron MLP.  Where the heads do not split evenly the cut
tensors are gathered and the cell runs whole on every rank.  The decode
steps split over the cache's layout instead (``mlstm_decode``,
``slstm_decode``): the state along its head dim, the inputs gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tp
from repro_torch.models.layers import dense_init, normal

_F32 = torch.float32


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _conv4(xm, w, b):
    """Causal depthwise conv over time, then SiLU: xm (B,S,di)."""
    K, S = w.shape[0], xm.shape[1]
    pad = F.pad(xm, (0, 0, K - 1, 0))
    return F.silu(sum(pad[:, i:i + S] * w[i] for i in range(K)) + b)


# ------------------------------------------------------------------ mLSTM
def init_mlstm(generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    di = cfg.mlstm_expand * d
    H = cfg.n_heads
    dev = generator.device
    return {
        "up": dense_init(generator, d, 2 * di, dtype),
        "conv_w": normal(generator, (4, di), 0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": dense_init(generator, di, di, dtype),
        "wk": dense_init(generator, di, di, dtype),
        "wv": dense_init(generator, di, di, dtype),
        "w_if": dense_init(generator, di, 2 * H, dtype, scale=0.02),
        "b_if": torch.cat([torch.zeros((H,), device=dev),
                           torch.full((H,), 3.0, device=dev)]).to(dtype),
        "skip": torch.ones((di,), dtype=dtype, device=dev),
        "down": dense_init(generator, di, d, dtype),
    }


def _mlstm_cell(carry, qkvif):
    """One timestep.  carry: (C, n, m); q, k, v: (B,H,hd); i, f: (B,H)."""
    C, n, m = carry
    q, k, v, it, ft = qkvif
    logf = F.logsigmoid(ft)                                   # (B,H)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    C = (f_p[..., None, None] * C
         + i_p[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n = f_p[..., None] * n + i_p[..., None] * k
    denom = torch.maximum(torch.abs(torch.sum(n * q, dim=-1)),
                          torch.exp(-m_new)) + 1e-6
    h = torch.einsum("bhvk,bhk->bhv", C, q) / denom[..., None]
    return (C, n, m_new), h


def _mlstm_qkvif(p, cfg: ModelConfig, xm, part: bool = False):
    """xm: (B,S,di) pre-conv input half.  Returns per-step tensors over
    the heads this rank runs, and the post-conv xc (B,S,di).  ``part``:
    rank-partial computation over a split ``d_inner``, where the rank runs
    its own heads if they split evenly, else all of them."""
    B, S, di = xm.shape
    H = cfg.n_heads
    hd = di // H
    xc = _conv4(xm, tp.whole(p["conv_w"], di, partial=part),
                tp.whole(p["conv_b"], di, partial=part))
    if part and H % tp.tp_size() == 0:
        # this rank's heads: its columns of wq / wk / wv, and of the gates
        H //= tp.tp_size()
        q, k, v = xc @ p["wq"], xc @ p["wk"], xm @ p["wv"]
        w_if, b_if = (tp.scatter_to_tp(t.unflatten(-1, (2, -1))).flatten(-2)
                      for t in (p["w_if"], p["b_if"]))
    else:
        q, k, v = (tp.linear_whole(t, p[n], di, part)
                   for t, n in ((xc, "wq"), (xc, "wk"), (xm, "wv")))
        w_if, b_if = (tp.whole(p[n], 2 * H, partial=part)
                      for n in ("w_if", "b_if"))
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, H, hd) * (hd ** -0.5)
    v = v.reshape(B, S, H, hd)
    gate = (xm @ w_if).to(_F32) + b_if.to(_F32)
    it, ft = gate[..., :H], gate[..., H:]
    return q, k, v, it, ft, xc


def _zero_carry(B, H, hd, device):
    return (torch.zeros((B, H, hd, hd), dtype=_F32, device=device),
            torch.zeros((B, H, hd), dtype=_F32, device=device),
            torch.full((B, H), -1e30, dtype=_F32, device=device))


def _mlstm_seq(cfg: ModelConfig, q, k, v, it, ft, B, S, H, hd):
    carry = _zero_carry(B, H, hd, q.device)
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    hs = []
    # the steps by ``unbind``, whose backward stacks the steps' gradients
    # once (a slice's would write a whole-sequence gradient a step)
    for step in zip(*(t.unbind(1) for t in (q, k, v, it, ft))):
        carry, h = _mlstm_cell(carry, step)
        hs.append(h)
    return torch.stack(hs, dim=1)                             # (B,S,H,hd)


def _mlstm_chunked(cfg: ModelConfig, q, k, v, it, ft, B, S, H, hd,
                   chunk: int = 64):
    """Chunkwise-parallel mLSTM: the sequential cell's math, with the
    recurrence crossing only chunk boundaries and each chunk's
    contributions an (L, L) masked product (the JAX docstring gives the
    equations)."""
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"chunked mLSTM: S={S} is not a multiple of {L}")
    C, n, m = _zero_carry(B, H, hd, q.device)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=q.device))[None, :, :, None]
    hs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc = q[:, sl].to(_F32), k[:, sl].to(_F32), v[:, sl].to(_F32)
        ic, fc = it[:, sl].to(_F32), ft[:, sl].to(_F32)
        lf = F.logsigmoid(fc)                                 # (B,L,H)
        Fc = torch.cumsum(lf, dim=1)                          # F_j
        D = Fc[:, :, None] - Fc[:, None, :] + ic[:, None, :, :]  # (B,L,L,H)
        D = torch.where(mask, D, -torch.inf)
        g = Fc + m[:, None]                                   # (B,L,H)
        m_j = torch.maximum(D.amax(dim=2), g)                 # (B,L,H)
        w = torch.exp(D - m_j[:, :, None])                    # (B,L,L,H)
        qk = torch.einsum("blhd,bkhd->blkh", qc, kc)          # (B,L,L,H)
        num_intra = torch.einsum("blkh,blkh,bkhd->blhd", w, qk, vc)
        den_intra = torch.einsum("blkh,blkh->blh", w, qk)
        dec = torch.exp(g - m_j)                              # (B,L,H)
        num_inter = torch.einsum("blh,bhvk,blhk->blhv", dec, C, qc)
        den_inter = dec * torch.einsum("bhk,blhk->blh", n, qc)
        num = num_intra + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_j))[..., None])
        # carry update at j = L
        FL = Fc[:, -1]                                        # (B,H)
        m_new = torch.maximum(FL + m, (FL[:, None] - Fc + ic).amax(dim=1))
        wL = torch.exp(FL[:, None] - Fc + ic - m_new[:, None])  # (B,L,H)
        decay = torch.exp(FL + m - m_new)
        C = (decay[..., None, None] * C
             + torch.einsum("blh,blhv,blhk->bhvk", wL, vc, kc))
        n = decay[..., None] * n + torch.einsum("blh,blhk->bhk", wL, kc)
        m = m_new
    return torch.cat(hs, dim=1).reshape(B, S, H, hd)


def mlstm_forward(p, cfg: ModelConfig, x):
    B, S, d = x.shape
    di = cfg.mlstm_expand * d
    # under a tensor-parallel split of d_inner the rank runs its share
    part = p["down"].shape[-2] != di
    if part:
        x = tp.copy_to_tp(x)
    xm, z = torch.chunk(tp.linear_whole(x, p["up"], 2 * di, part), 2,
                        dim=-1)
    q, k, v, it, ft, xc = _mlstm_qkvif(p, cfg, xm, part)
    H, hd = q.shape[-2:]
    if cfg.mlstm_impl == "chunk" and S > 1:
        hs = _mlstm_chunked(cfg, q, k, v, it, ft, B, S, H, hd)
    else:
        hs = _mlstm_seq(cfg, q, k, v, it, ft, B, S, H, hd)
    h = hs.reshape(B, S, H * hd).to(x.dtype)
    if part:
        if H * hd == di:                  # the heads ran whole: its slice
            h = tp.own(h)
        xc, z = tp.own(xc), tp.own(z)
    h = h + p["skip"] * xc
    h = h * F.silu(z)
    out = h @ p["down"]
    return tp.reduce_from_tp(out) if part else out


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    di = cfg.mlstm_expand * cfg.d_model
    H = cfg.n_heads
    C, n, m = _zero_carry(batch, H, di // H, device)
    return {"C": C, "n": n, "m": m,
            "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device)}


def mlstm_decode(p, cfg: ModelConfig, cache, x, pos):
    """One step.  Under a tensor-parallel context the cache is this
    rank's block (``launch.sharding.cache_specs``): ``C`` (B,H,hd_v,hd_k)
    split along hd_v, ``n`` along hd_k, ``conv`` along d_inner, ``m``
    whole.  The rank runs the conv on its channels and gathers ``xc``;
    q, k, v and the gates are whole (gathered where their leaves split);
    its rows of ``C`` give its hd_v slice of h from the whole q, while
    ``n·q`` is a partial sum over hd_k, summed over the model axis.  h is
    gathered, and the rank's channels of it, of the skip and of the gate
    enter the row-parallel ``down``."""
    del pos
    B, _, d = x.shape
    di = cfg.mlstm_expand * d
    H = cfg.n_heads
    hd = di // H
    r = tp.tp_rank()
    xm, z = torch.chunk(tp.linear_whole(x[:, 0], p["up"], 2 * di), 2,
                        dim=-1)
    buf = cache["conv"]
    xm_c = tp.own(xm) if buf.shape[-1] != di else xm
    w = p["conv_w"]
    K = w.shape[0]
    conv = sum(buf[:, i] * w[i] for i in range(K - 1)) + xm_c * w[K - 1]
    xc_c = F.silu(conv + p["conv_b"])
    new_buf = torch.cat([buf[:, 1:], xm_c[:, None].to(buf.dtype)], dim=1)
    xc = tp.whole(xc_c, di)
    q = tp.linear_whole(xc, p["wq"], di).reshape(B, H, hd).to(_F32)
    k = (tp.linear_whole(xc, p["wk"], di) * (hd ** -0.5)).reshape(
        B, H, hd).to(_F32)
    v = tp.linear_whole(xm, p["wv"], di).reshape(B, H, hd).to(_F32)
    gate = (tp.linear_whole(xm, p["w_if"], 2 * H).to(_F32)
            + tp.whole(p["b_if"], 2 * H).to(_F32))
    it, ft = gate[..., :H], gate[..., H:]
    # ``_mlstm_cell`` on the cache's rows of C and slice of n
    C, n, m = cache["C"], cache["n"], cache["m"]
    hv, hk = C.shape[-2], n.shape[-1]
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    v_r = v[..., r * hv:(r + 1) * hv] if hv != hd else v
    k_r, q_r = ((t[..., r * hk:(r + 1) * hk] if hk != hd else t)
                for t in (k, q))
    C = (f_p[..., None, None] * C
         + i_p[..., None, None] * (v_r[..., :, None] * k[..., None, :]))
    n = f_p[..., None] * n + i_p[..., None] * k_r
    nq = torch.sum(n * q_r, dim=-1)
    if hk != hd:
        nq = tp.reduce_from_tp(nq)
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_new)) + 1e-6
    h = torch.einsum("bhvk,bhk->bhv", C, q) / denom[..., None]
    if hv != hd:
        h = tp.gather_from_tp(h, -1)
    h = h.reshape(B, di).to(x.dtype)
    part = p["down"].shape[-2] != di
    if part:
        h, z = tp.own(h), tp.own(z)
        xc = xc_c if xc_c.shape[-1] != di else tp.own(xc)
    h = h + p["skip"] * xc
    h = (h * F.silu(z)) @ p["down"]
    return (tp.reduce_from_tp(h) if part else h)[:, None], {
        "C": C, "n": n, "m": m_new, "conv": new_buf}


# ------------------------------------------------------------------ sLSTM
def _slstm_pf(cfg: ModelConfig) -> int:
    """The sLSTM's GeGLU width, ``slstm_proj`` of d aligned to 128."""
    return -(-int(cfg.slstm_proj * cfg.d_model) // 128) * 128


def init_slstm(generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    pf = _slstm_pf(cfg)
    return {
        "wx": dense_init(generator, d, 4 * d, dtype),
        # recurrent weights, block-diagonal per head: (H, hd, 4*hd)
        "r": normal(generator, (H, hd, 4 * hd), hd ** -0.5, dtype),
        "b": torch.zeros((4 * d,), dtype=dtype, device=generator.device),
        "up_g": dense_init(generator, d, pf, dtype),
        "up_v": dense_init(generator, d, pf, dtype),
        "down": dense_init(generator, pf, d, dtype),
    }


def _slstm_cell(r, carry, xg):
    """r: (H,hd,4hd) recurrent blocks of the heads run; carry: (c, n, h,
    m), each (B,H,hd).  xg: (B, H*4hd) pre-activations, head-major."""
    c, n, h, m = carry
    B = xg.shape[0]
    H, hd = r.shape[:2]
    rec = torch.einsum("bhd,hdk->bhk", h, r.to(_F32))        # (B,H,4hd)
    g = xg.reshape(B, H, 4 * hd).to(_F32) + rec
    return _slstm_update(torch.chunk(g, 4, dim=-1), c, n, m)  # (B,H,hd)


def _slstm_update(gates, c, n, m):
    """The sLSTM state update from the z, i, f, o pre-activations."""
    zt, it, ft, ot = gates
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h_new = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h_new, m_new)


def _slstm_carry(B, H, hd, device):
    z = lambda: torch.zeros((B, H, hd), dtype=_F32, device=device)
    return (z(), z(), z(),
            torch.full((B, H, hd), -1e30, dtype=_F32, device=device))


def slstm_forward(p, cfg: ModelConfig, x):
    B, S, d = x.shape
    r = p["r"]
    heads = (p["wx"].shape[-1] != 4 * d
             and cfg.n_heads % tp.tp_size() == 0)
    if heads:
        # this rank's columns of wx are whole heads: its slices of r and b
        xg = tp.copy_to_tp(x) @ p["wx"] + tp.scatter_to_tp(p["b"])
        r = tp.scatter_to_tp(r, 0)
    else:
        xg = tp.linear_whole(x, p["wx"], 4 * d) + p["b"]
    H, hd = r.shape[:2]
    carry = _slstm_carry(B, H, hd, x.device)
    hs = []
    for xg_t in xg.unbind(1):
        carry = _slstm_cell(r, carry, xg_t)
        hs.append(carry[2])
    h = torch.stack(hs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    if heads:
        h = tp.gather_from_tp(h)
    # post up / down projection (GeGLU, factor slstm_proj), a Megatron MLP
    # under a split of its width
    split = p["down"].shape[-2] != _slstm_pf(cfg)
    if split:
        h = tp.copy_to_tp(h)
    y = (_gelu(h @ p["up_g"]) * (h @ p["up_v"])) @ p["down"]
    return tp.reduce_from_tp(y) if split else y


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    del dtype
    c, n, h, m = _slstm_carry(batch, cfg.n_heads,
                              cfg.d_model // cfg.n_heads, device)
    return {"c": c, "n": n, "h": h, "m": m}


def slstm_decode(p, cfg: ModelConfig, cache, x, pos):
    """One step.  Under a tensor-parallel context the cache is this
    rank's block (``launch.sharding.cache_specs``): c, n and m (B,H,hd)
    hold its slice of the head dim of every head, and h, which the rule
    for Mamba's ``h`` takes, its block of the heads.  ``wx``'s column
    blocks match neither split, so its output is gathered whole and
    regrouped to the rank's slice of each gate of each head; the
    recurrent product takes the whole h against the matching columns of
    the (replicated) ``r``.  The new h is gathered, and kept in the
    cache's layout; the GeGLU projection is a Megatron MLP under a split
    of its width."""
    del pos
    B, _, d = x.shape
    H = cfg.n_heads
    hd = d // H
    xg = tp.linear_whole(x[:, 0], p["wx"], 4 * d) + tp.whole(p["b"], 4 * d)
    c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    hs = c.shape[-1]
    h_heads = h.shape[1] != H
    h = tp.whole(h, H, 1) if h_heads else tp.whole(h, hd)
    sl = slice(tp.tp_rank() * hs, (tp.tp_rank() + 1) * hs)
    r = p["r"].reshape(H, hd, 4, hd)[..., sl].to(_F32)
    g = (xg.reshape(B, H, 4, hd)[..., sl].to(_F32)
         + torch.einsum("bhd,hdgk->bhgk", h, r))
    c, n, h, m = _slstm_update(g.unbind(2), c, n, m)
    hh = tp.whole(h, hd)
    h = tp.own(hh, 1) if h_heads else h
    hh = hh.reshape(B, d).to(x.dtype)
    split = p["down"].shape[-2] != _slstm_pf(cfg)
    if split:
        hh = tp.copy_to_tp(hh)
    y = (_gelu(hh @ p["up_g"]) * (hh @ p["up_v"])) @ p["down"]
    return (tp.reduce_from_tp(y) if split else y)[:, None], {
        "c": c, "n": n, "h": h, "m": m}
