"""The 10 architectures of the JAX package (``repro.configs.archs``, same
numbers, source papers / model cards cited per entry) and their reduced
smoke variants.

The port builds, runs and decodes every one of them (``models/registry``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig

_D = dict  # brevity


def _cfg(**kw) -> ModelConfig:
    c = ModelConfig(**kw)
    c.validate()
    return c


# --------------------------------------------------------------------- full
# [arXiv:2409.12191] Qwen2-VL: M-RoPE (sections 16/24/24 of half-dim), dynamic
# resolution handled by the stubbed ViT frontend (patch embeddings provided).
QWEN2_VL_2B = _cfg(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
    mrope_sections=(16, 24, 24), rope_theta=1e6, tie_embeddings=True,
    frontend="vision", frontend_tokens=1024, dtype="bfloat16")

# [hf:Qwen/Qwen3-30B-A3B family, scaled per brief] 94L, 128 experts top-8.
QWEN3_MOE_235B = _cfg(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    ffn_pattern=("moe",), n_experts=128, experts_per_tok=8,
    moe_impl="capacity", qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    dtype="bfloat16")

# [arXiv:2404.06395] MiniCPM: WSD schedule + μP-style depth/width scaling.
MINICPM_2B = _cfg(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304, n_heads=36,
    n_kv_heads=36, head_dim=64, d_ff=5760, vocab_size=122753,
    rope_theta=1e4, residual_scale=1.4 / math.sqrt(40), embed_scale=12.0,
    logit_scale=256.0 / 2304.0, tie_embeddings=True, dtype="bfloat16")

# [arXiv:2403.19887] Jamba: Mamba+attention 1:7 interleave, MoE every other
# layer (16e top-2); no positional encoding.
JAMBA_52B = _cfg(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe"), n_experts=16, experts_per_tok=2,
    moe_impl="capacity", use_rope=False, tie_embeddings=False,
    ssm_state=16, ssm_conv=4, ssm_expand=2, dtype="bfloat16")

# [arXiv:2402.00838] OLMo: non-parametric LayerNorm, tied embeddings.
OLMO_1B = _cfg(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, head_dim=128, d_ff=8192, vocab_size=50304,
    norm_type="nonparam_ln", rope_theta=1e4, tie_embeddings=True,
    dtype="bfloat16")

# [hf:ibm-granite/granite-3.0-1b-a400m-base] 32 experts top-8, tiny experts.
GRANITE_MOE_1B = _cfg(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
    ffn_pattern=("moe",), n_experts=32, experts_per_tok=8,
    moe_impl="capacity", rope_theta=1e4, tie_embeddings=True, dtype="bfloat16")

# [hf:Qwen/Qwen3-8B] qk_norm, GQA kv=8.
QWEN3_8B = _cfg(
    name="qwen3-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, head_dim=128, d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False, dtype="bfloat16")

# [arXiv:2308.11596] SeamlessM4T medium: enc-dec; audio frontend stubbed
# (frame embeddings).  12 encoder + 12 decoder layers.
SEAMLESS_M4T_MED = _cfg(
    name="seamless-m4t-medium", family="encdec", n_layers=12, n_enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
    vocab_size=256206, norm_type="layernorm", rope_theta=1e4,
    frontend="audio", frontend_tokens=1024, tie_embeddings=True,
    dtype="bfloat16")

# [arXiv:2405.04517] xLSTM: mLSTM blocks with an sLSTM every 6th; no FFN
# (d_ff=0) — projections live inside the blocks.
XLSTM_350M = _cfg(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, head_dim=256, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    ffn_pattern=("none",), tie_embeddings=True, dtype="bfloat16")

# [arXiv:2408.00118] Gemma2: local(4096)/global alternation, softcaps,
# embedding scaled by sqrt(d_model).
GEMMA2_9B = _cfg(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584, n_heads=16,
    n_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
    block_pattern=("attn_local", "attn"), sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, embed_scale=math.sqrt(3584.0),
    rope_theta=1e4, tie_embeddings=True, dtype="bfloat16")


ARCHS = {c.name: c for c in [
    QWEN2_VL_2B, QWEN3_MOE_235B, MINICPM_2B, JAMBA_52B, OLMO_1B,
    GRANITE_MOE_1B, QWEN3_8B, SEAMLESS_M4T_MED, XLSTM_350M, GEMMA2_9B]}


# --------------------------------------------------------------------- smoke
def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: ≤2 layers of the same block pattern,
    d_model ≤ 512, ≤4 experts — real forward/train step on CPU."""
    kw: dict = _D(
        name=cfg.name + "-smoke", d_model=256, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64, d_ff=512 if cfg.d_ff else 0, vocab_size=512,
        dtype="float32", frontend_tokens=8 if cfg.frontend else 0,
        embed_scale=1.0 if cfg.embed_scale == 1.0 else 4.0,
        sliding_window=8 if cfg.sliding_window else 0,
    )
    if cfg.mrope_sections:
        kw["mrope_sections"] = (8, 12, 12)
    if cfg.n_experts:
        kw.update(n_experts=4, experts_per_tok=2, d_ff=128,
                  moe_impl="dense")
    if cfg.family == "hybrid":
        kw.update(block_pattern=("mamba", "attn"), ffn_pattern=("dense", "moe"),
                  n_layers=2)
    elif cfg.family == "ssm":
        kw.update(block_pattern=("mlstm", "slstm"), n_layers=2)
    elif cfg.family == "encdec":
        kw.update(n_layers=2, n_enc_layers=2)
    else:
        kw.update(n_layers=2, block_pattern=cfg.block_pattern[:2] or ("attn",))
        if len(cfg.block_pattern) >= 2:
            kw["block_pattern"] = cfg.block_pattern[:2]
        else:
            kw["block_pattern"] = cfg.block_pattern
        if len(cfg.ffn_pattern) > 1:
            kw["ffn_pattern"] = cfg.ffn_pattern[:2]
    if cfg.residual_scale != 1.0:
        kw["residual_scale"] = 1.4 / math.sqrt(2)
    c = dataclasses.replace(cfg, **kw)
    c.validate()
    return c


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    cfg = ARCHS[name]
    return smoke_variant(cfg) if smoke else cfg


def list_archs():
    return sorted(ARCHS)
