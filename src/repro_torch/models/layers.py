"""Shared neural-net layers: norms, RoPE / M-RoPE, MLPs, init helpers.

A torch copy of ``repro.models.layers``.  Every layer is a pure function
over an explicit parameter pytree (nested dicts of tensors), so it composes
with the stacked superblock parameters of ``models/transformer.py`` and the
member-axis ``torch.func.vmap`` of ``core/client.py``.  Init draws from a
``torch.Generator`` on the generator's own device (a CUDA generator draws
on the card, so a full-width model never passes through host memory); the
numbers differ from ``jax.random``'s, so the parity tests carry the JAX
draws across (``interop``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tp

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("float32" | "bfloat16") as a torch dtype."""
    return _DTYPES[name]


# --------------------------------------------------------------------------- init
def normal(generator, shape, scale: float, dtype):
    """Standard normal draws times ``scale`` in ``dtype``, drawn in fp32 on
    ``generator.device``."""
    return (torch.randn(shape, generator=generator, device=generator.device)
            * scale).to(dtype)


def dense_init(generator, d_in: int, d_out: int, dtype,
               scale: float | None = None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(generator, (d_in, d_out), scale, dtype)


def embed_init(generator, vocab: int, d_model: int, dtype):
    return normal(generator, (vocab, d_model), 0.02, dtype)


# --------------------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, d: int, dtype, device=None):
    if cfg.norm_type == "nonparam_ln":            # olmo: no learnable affine
        return {}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}  # rmsnorm


def apply_norm(cfg: ModelConfig, p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if cfg.norm_type in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            y = (y * p["scale"].to(torch.float32)
                 + p["bias"].to(torch.float32))
        return y.to(x.dtype)
    ms = torch.square(xf).mean(dim=-1, keepdim=True)          # rmsnorm
    y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head RMSNorm over the last (head_dim) axis — qwen3 qk_norm."""
    xf = x.to(torch.float32)
    ms = torch.square(xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x, ang):
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    ang = positions[..., None].to(torch.float32) * freqs        # (..., S, half)
    return _rotate(x, ang[..., None, :])                        # (..., S, 1, half)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE.

    x: (..., S, H, hd); positions3: (3, ..., S) — temporal/height/width
    position streams.  ``sections`` partitions the half-dim; section ``i``
    rotates with position stream ``i`` (text tokens carry identical
    streams, reducing to 1-D RoPE)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    idx = []
    for i, s in enumerate(sections):
        idx.extend([i] * s)
    sel = torch.tensor(idx, device=positions3.device)           # (half,)
    pos = positions3[sel].movedim(0, -1)                        # (..., S, half)
    ang = pos.to(torch.float32) * freqs
    return _rotate(x, ang[..., None, :])


# --------------------------------------------------------------------------- mlp
def init_mlp(generator, d_model: int, d_ff: int, dtype):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype),
        "w_up": dense_init(generator, d_model, d_ff, dtype),
        "w_down": dense_init(generator, d_ff, d_model, dtype),
    }


def apply_mlp(p, x, d_ff: int | None = None):
    """The gated MLP.  ``d_ff`` (the full hidden width) says whether, under
    a tensor-parallel context (``models.tp``), the leaves are this rank's
    slices: column-parallel ``w_gate`` / ``w_up`` and row-parallel
    ``w_down``, the input entering by ``copy_to_tp`` and the output summed
    by ``reduce_from_tp``."""
    split = d_ff is not None and tp.splits(d_ff)
    if split:
        x = tp.copy_to_tp(x)
    g = F.silu(x @ p["w_gate"])
    y = (g * (x @ p["w_up"])) @ p["w_down"]
    return tp.reduce_from_tp(y) if split else y


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x
