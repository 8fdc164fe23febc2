"""Selective SSM (Mamba-1) block: chunked scan prefill, O(1) decode, a torch
copy of ``repro.models.mamba``.

The recurrence ``h_t = exp(dt_t A) h_{t-1} + (dt_t B_t) x_t`` is a
first-order linear recurrence.  Prefill runs it in chunks of ``CHUNK``
steps with the inter-chunk carry threaded through a Python loop, as JAX's
``lax.scan``; within a chunk a log-step (Hillis-Steele) scan takes the
place of ``jax.lax.associative_scan``, which torch lacks.  The two scans
associate the products differently, so results agree with JAX to fp32
rounding, not bit for bit.  Decode keeps the ``(B, d_inner, state)``
hidden state and a (conv_k - 1)-deep conv buffer in the cache.

Under a tensor-parallel context (``models.tp``) that splits ``d_inner``
each rank runs the scan on its slice of the channels, rank-partial.  The
``in_proj`` output is gathered, because its columns split contiguously
over the x / z halves (on two ranks one holds all of x, the other all of
z) and each rank needs its slice of both; the conv then runs whole on the
gathered conv leaves, so the ``x_proj`` product sees the whole ``xc`` and
its (dt, B, C) output, gathered where ``x_proj`` splits, is whole on every
rank (B and C feed every channel).  ``dt_proj``, ``dt_bias``, ``A_log``,
``D`` and the gate take the rank's channels, and the row-parallel
``out_proj`` ends in one ``reduce_from_tp``.  ``mamba_decode`` splits
alike over a cache that holds the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tp
from repro_torch.models.layers import dense_init, normal

CHUNK = 128


def init_mamba(generator, cfg: ModelConfig, dtype):
    d, di, st, dtr, ck = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.dt_rank, cfg.ssm_conv)
    dev = generator.device
    # S4D-real initialization for A
    a_init = torch.arange(1, st + 1, dtype=torch.float32,
                          device=dev).expand(di, st)
    return {
        "in_proj": dense_init(generator, d, 2 * di, dtype),
        "conv_w": normal(generator, (ck, di), ck ** -0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(generator, di, dtr + 2 * st, dtype),
        "dt_proj": dense_init(generator, dtr, di, dtype),
        "dt_bias": torch.full((di,), -2.0, dtype=dtype, device=dev),
        "A_log": torch.log(a_init).to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, di, d, dtype),
    }


def _ssm_inputs(p, cfg: ModelConfig, xc, part: bool = False):
    """xc: post-conv activations (B,S,di) -> dt (B,S,di), Bm/Cm (B,S,st).
    ``part``: rank-partial computation over a split ``d_inner``, where dt
    holds this rank's channels."""
    st, dtr = cfg.ssm_state, cfg.dt_rank
    proj = tp.linear_whole(xc, p["x_proj"], dtr + 2 * st, part)
    dt, Bm, Cm = torch.split(proj, [dtr, st, st], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    return dt, Bm, Cm


def _causal_conv(x, w, b):
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + S] * w[i] for i in range(K))
    return F.silu(y + b)


def scan_linear(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1 from
    h = 0, in log2(L) steps: returns (prod a_1..t, h_t) for every t."""
    L, off = a.shape[1], 1
    while off < L:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def mamba_forward(p, cfg: ModelConfig, x):
    """x: (B,S,d) -> (B,S,d).  Full sequence (train / prefill)."""
    B, S, _ = x.shape
    di = cfg.d_inner
    # under a tensor-parallel split of d_inner the rank runs its share
    part = p["out_proj"].shape[-2] != di
    if part:
        x = tp.copy_to_tp(x)
    xm, z = torch.chunk(tp.linear_whole(x, p["in_proj"], 2 * di, part), 2,
                        dim=-1)
    xc = _causal_conv(xm, tp.whole(p["conv_w"], di, partial=part),
                      tp.whole(p["conv_b"], di, partial=part))
    dt, Bm, Cm = _ssm_inputs(p, cfg, xc, part)
    if part:
        xc, z = tp.own(xc), tp.own(z)
    A = -torch.exp(p["A_log"].to(torch.float32))                 # (di,st)
    di, st = A.shape
    chunk = min(CHUNK, S)
    if S % chunk:
        raise ValueError(f"mamba prefill: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    h = torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        dtf = dt[:, sl].to(torch.float32)
        a = torch.exp(dtf[..., None] * A)                        # (B,L,di,st)
        b = ((dtf * xc[:, sl].to(torch.float32))[..., None]
             * Bm[:, sl].to(torch.float32)[:, :, None, :])
        aa, bb = scan_linear(a, b)
        h_all = aa * h[:, None] + bb                             # (B,L,di,st)
        ys.append(torch.einsum("blds,bls->bld", h_all,
                               Cm[:, sl].to(torch.float32)))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1)
    y = y.to(x.dtype) + xc * p["D"]
    y = y * F.silu(z)
    y = y @ p["out_proj"]
    return tp.reduce_from_tp(y) if part else y


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device=None):
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


def mamba_decode(p, cfg: ModelConfig, cache, x, pos):
    """x: (B,1,d).  Returns (y, cache).  Under a tensor-parallel split of
    ``d_inner`` the cache holds this rank's channels (``h`` and ``conv``
    split along d_inner, ``launch.sharding.cache_specs``): the gathered
    ``in_proj`` output gives the rank its channels of both halves, the
    conv runs on them from its buffer, ``xc`` is gathered for ``x_proj``
    ((dt, B, C) feed every channel), and the row-parallel ``out_proj``
    ends in one ``reduce_from_tp``."""
    del pos
    di = cfg.d_inner
    part = p["out_proj"].shape[-2] != di
    xm, z = torch.chunk(tp.linear_whole(x[:, 0], p["in_proj"], 2 * di),
                        2, dim=-1)                               # (B,di)
    if part:
        xm, z = tp.own(xm), tp.own(z)
    w = p["conv_w"]
    K = w.shape[0]
    buf = cache["conv"]                                          # (B,K-1,di)
    conv = sum(buf[:, i] * w[i] for i in range(K - 1)) + xm * w[K - 1]
    xc = F.silu(conv + p["conv_b"])
    new_buf = torch.cat([buf[:, 1:], xm[:, None].to(buf.dtype)], dim=1)
    proj = tp.linear_whole(tp.whole(xc, di), p["x_proj"],
                           cfg.dt_rank + 2 * cfg.ssm_state)
    dt, Bm, Cm = torch.split(proj, [cfg.dt_rank, cfg.ssm_state,
                                    cfg.ssm_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    dtf = dt.to(torch.float32)
    a = torch.exp(dtf[..., None] * A)                            # (B,di,st)
    b = ((dtf * xc.to(torch.float32))[..., None]
         * Bm.to(torch.float32)[:, None, :])
    h = a * cache["h"] + b
    y = torch.einsum("bds,bs->bd", h, Cm.to(torch.float32)).to(x.dtype)
    y = y + xc * p["D"]
    y = (y * F.silu(z)) @ p["out_proj"]
    return (tp.reduce_from_tp(y) if part else y)[:, None], {
        "h": h, "conv": new_buf}
