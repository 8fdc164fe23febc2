"""Model / run configuration dataclasses, a copy of ``repro.configs.base``.

Every field is kept, so a configuration carries across the two packages
unchanged; ``PORT_FIELDS`` (``attn_scale``, the last field) are the
port's own, and at their defaults the model is JAX's.  Fields that select
code the port has not ported yet (sharding and cache layouts, ``remat``)
are data here; ``remat=True`` raises in ``models/transformer.py``.
``attn_impl`` keeps the JAX values: ``"pallas"`` selects the port's CUDA
flash kernel (``models/attention.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a mesh-divisible multiple (Megatron-style)."""
    return ((v + multiple - 1) // multiple) * multiple


# ModelConfig's fields that JAX's has not
PORT_FIELDS = ("attn_scale",)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int             # raw vocab (loss masks the padding)
    # --- mixer pattern -----------------------------------------------------
    # kinds per position within a superblock; n_layers % len(pattern) == 0.
    # entries: "attn" | "attn_local" | "mamba" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    # ffn kind per position: "dense" | "moe" | "none"
    ffn_pattern: Tuple[str, ...] = ("dense",)
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    router_aux_coef: float = 0.01
    moe_impl: str = "dense"       # dense | capacity (GShard grouped dispatch) | dropless (port)
    moe_group: int = 512          # tokens per dispatch group (capacity impl)
    moe_capacity: float = 1.25    # capacity factor
    # >0: lax.scan over group-chunks of this many groups so only one chunk's
    # dispatch one-hots are live (§Perf memory lever for the 235B MoE)
    moe_chunk_groups: int = 0
    # --- attention flavour ---------------------------------------------------
    rope_theta: float = 1_000_000.0
    use_rope: bool = True               # jamba: no positional encoding
    qk_norm: bool = False
    mrope_sections: Tuple[int, ...] = ()     # qwen2-vl M-RoPE (sums to head_dim//2)
    sliding_window: int = 0                  # for "attn_local" layers
    attn_softcap: float = 0.0                # gemma2 logit softcap (attn)
    final_softcap: float = 0.0               # gemma2 final-logit softcap
    # --- norms / residual scaling -------------------------------------------
    norm_type: str = "rmsnorm"               # rmsnorm | layernorm | nonparam_ln (olmo)
    residual_scale: float = 1.0              # minicpm depth scaling
    embed_scale: float = 1.0                 # minicpm scale_emb
    logit_scale: float = 1.0                 # minicpm 1/(d_model/dim_base)
    tie_embeddings: bool = True
    # --- ssm (mamba) ----------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                     # 0 -> ceil(d_model/16)
    # --- xlstm ----------------------------------------------------------------
    mlstm_expand: int = 2
    slstm_proj: float = 4 / 3
    # mLSTM prefill/train: "scan" (sequential cell) or "chunk" (chunkwise-
    # parallel, MXU-shaped — the TPU-native form; exact same math)
    mlstm_impl: str = "scan"
    # --- enc-dec --------------------------------------------------------------
    n_enc_layers: int = 0
    # --- modality frontend stub ------------------------------------------------
    frontend: str = ""                       # "" | "vision" | "audio"
    frontend_tokens: int = 0                 # frontend positions per sample (train/prefill)
    # --- numerics ---------------------------------------------------------------
    dtype: str = "float32"
    # MoE sharding mode: "tp" shards expert d_ff, "ep" shards the expert axis.
    moe_shard: str = "tp"
    # Parameter sharding scheme: "tp" (tensor-parallel along `model`) or
    # "fsdp" (params sharded over the combined data axes, batch over ALL
    # axes — the beyond-paper scheme for small-d_model archs, §Perf).
    shard_mode: str = "tp"
    # Decode-cache sharding: "seq" (sequence over model — flash-decode style,
    # the production default: §Perf H2 shows 8-65x lower collectives than
    # "hd" on every decode shape), "hd" (head_dim over model — the original
    # baseline), "batch" (replicate over model).
    cache_shard: str = "seq"
    # attention implementation: "jnp" | "blocked" | "pallas" (pallas = the
    # flash kernel through kernels/flash/ops; in the port, the CUDA kernel)
    attn_impl: str = "jnp"
    remat: bool = False                      # rematerialize each superblock
    scan_unroll: bool = False                # unroll layer scans (dry-run cost measurement)
    # port-only: the multiplier of the attention scores q·k (Granite 3.0's
    # µP ``attention_multiplier``); 0 means head_dim ** -0.5
    attn_scale: float = 0.0

    @property
    def softmax_scale(self) -> float:
        """What the attention scores q·k are multiplied by."""
        return self.attn_scale or self.head_dim ** -0.5

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def ffn_kind(self, pos: int) -> str:
        return self.ffn_pattern[pos % len(self.ffn_pattern)]

    def validate(self) -> None:
        assert self.n_layers % self.period == 0
        assert len(self.ffn_pattern) in (1, self.period) or self.period % len(self.ffn_pattern) == 0
        if "attn" in self.block_pattern or "attn_local" in self.block_pattern:
            assert self.n_heads % self.n_kv_heads == 0
        if "moe" in self.ffn_pattern:
            assert self.n_experts > 0 and self.experts_per_tok > 0
        if self.mrope_sections:
            assert sum(self.mrope_sections) == self.head_dim // 2


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    optimizer: str = "adamw"      # sgd | momentum | adamw
    schedule: str = "constant"    # constant | cosine | wsd
    warmup_steps: int = 0
    total_steps: int = 1000
    grad_clip: float = 1.0
    seed: int = 0
