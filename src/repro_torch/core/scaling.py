"""α-compression of model configs → the per-cluster generic-model family
(§IV-A2: M_f = α^{f-1} M).

The paper compresses only the conv layers of its CNN; the transformer
analogue compresses the FFN width (and expert count for MoE) by α per cluster
level, keeping d_model / attention dims intact so master and slave logits are
directly KD-compatible.  Widths round to multiples of 128 — or 16 below
256 — as in the JAX package (``repro.core.scaling``), of which this module
is a copy: ``model_bytes`` feeds Procedure 2 through ``lm_family``, so the
two must agree exactly.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig


def _round_mult(x: int, mult: int) -> int:
    return max(mult, int(round(x / mult)) * mult)


def compress_config(cfg: ModelConfig, alpha: float, level: int) -> ModelConfig:
    """Cluster C_{level} model: widths scaled by α^level (level 0 = master)."""
    if level == 0:
        return cfg
    s = alpha ** level
    kw = {"name": f"{cfg.name}-L{level}"}
    if cfg.d_ff:
        mult = 128 if cfg.d_ff * s >= 256 else 16
        kw["d_ff"] = _round_mult(int(cfg.d_ff * s), mult)
    if cfg.n_experts:
        kw["n_experts"] = max(cfg.experts_per_tok, int(round(cfg.n_experts * s)))
    if cfg.family == "ssm":   # xLSTM: compress the block expansion
        kw["mlstm_expand"] = cfg.mlstm_expand     # expansion ratio kept;
        # depth-preserving family: compress the sLSTM projection factor
        kw["slstm_proj"] = max(1.0, cfg.slstm_proj * s)
    c = cfg.replace(**kw)
    c.validate()
    return c


def model_family(cfg: ModelConfig, alpha: float, m: int) -> list[ModelConfig]:
    """[M_1, ..., M_m] with M_1 = M (the server's model)."""
    return [compress_config(cfg, alpha, lvl) for lvl in range(m)]


# ------------------------------------------------------- analytic size/flops
def param_count(cfg: ModelConfig) -> int:
    d, V = cfg.d_model, cfg.padded_vocab
    n = V * d                                   # embed
    if not cfg.tie_embeddings:
        n += V * d
    per_pos = []
    for j, kind in enumerate(cfg.block_pattern):
        c = 0
        if kind in ("attn", "attn_local"):
            c += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        elif kind == "mamba":
            di, st, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
            c += d * 2 * di + cfg.ssm_conv * di + di * (dtr + 2 * st) \
                + dtr * di + di * st + 2 * di + di * d
        elif kind == "mlstm":
            di = cfg.mlstm_expand * d
            c += d * 2 * di + 4 * di + di * di * 3 + di * 2 * cfg.n_heads + di * d + di
        elif kind == "slstm":
            hd = d // cfg.n_heads
            pf = -(-int(cfg.slstm_proj * d) // 128) * 128
            c += d * 4 * d + cfg.n_heads * hd * 4 * hd + 4 * d + 2 * d * pf + pf * d
        fk = cfg.ffn_kind(j)
        if fk == "dense":
            c += 3 * d * cfg.d_ff
        elif fk == "moe":
            c += d * cfg.n_experts + cfg.n_experts * 3 * d * cfg.d_ff
        per_pos.append(c)
    n += cfg.n_superblocks * sum(per_pos)
    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (d * cfg.q_dim + 2 * d * cfg.kv_dim
                                  + cfg.q_dim * d + 3 * d * cfg.d_ff)
        dec_cross = cfg.n_layers * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d)
        n += enc + dec_cross
    return int(n)


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k of E experts)."""
    if not cfg.n_experts:
        return param_count(cfg)
    full = param_count(cfg)
    moe_positions = sum(1 for j in range(cfg.period) if cfg.ffn_kind(j) == "moe")
    expert_p = cfg.n_superblocks * moe_positions * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    active_e = cfg.n_superblocks * moe_positions * cfg.experts_per_tok * 3 * cfg.d_model * cfg.d_ff
    return int(full - expert_p + active_e)


def model_bytes(cfg: ModelConfig) -> int:
    bpp = 2 if cfg.dtype == "bfloat16" else 4
    return param_count(cfg) * bpp


def flops_per_token_train(cfg: ModelConfig, seq_len: int) -> float:
    """6·N_active·(1) + attention term (quadratic part) per token."""
    base = 6.0 * active_param_count(cfg)
    attn_layers = sum(1 for k in cfg.block_pattern if k.startswith("attn"))
    attn_layers = cfg.n_superblocks * attn_layers
    attn = 12.0 * attn_layers * cfg.head_dim * cfg.n_heads * seq_len / 2
    return base + attn


def analytic_step_flops(cfg: ModelConfig, kind: str, global_batch: int,
                        seq_len: int, remat: bool = False) -> float:
    """Whole-step analytic FLOPs (cross-check for the HLO numbers, which on
    the CPU backend do not multiply while-loop trip counts)."""
    if kind == "train":
        f = flops_per_token_train(cfg, seq_len) * global_batch * seq_len
        return f * (4 / 3) if remat else f          # fwd recompute in bwd
    if kind == "prefill":
        return flops_per_token_train(cfg, seq_len) / 3.0 * global_batch * seq_len
    # decode: one token; attention reads the whole cache
    base = 2.0 * active_param_count(cfg) * global_batch
    attn_layers = cfg.n_superblocks * sum(
        1 for k in cfg.block_pattern if k.startswith("attn"))
    attn = 4.0 * attn_layers * cfg.n_heads * cfg.head_dim * seq_len * global_batch
    return base + attn
