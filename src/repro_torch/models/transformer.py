"""Decoder-only LM over superblocks, a torch copy of
``repro.models.transformer`` (full-sequence forward and loss).

Parameters of each position-in-superblock are stacked across superblocks
(``blocks/p{j}/...`` leaves of shape ``(n_superblocks, ...)``), as in the
JAX package, so the pytree and its flat plane are the same in both
packages.  JAX runs the depth under ``lax.scan``; here a Python loop
indexes the stacked leaves.

Ported: mixers ``attn`` and ``attn_local``, FFN kinds ``dense`` and
``none``.  ``moe``, ``mamba``, ``mlstm``, ``slstm`` and ``remat=True``
raise ``NotImplementedError`` naming their ROADMAP item; the decode
functions wait for the serving slice (item 10e).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       init_mlp, init_norm, softcap,
                                       torch_dtype)

_NOT_PORTED = {
    "moe": "MoE FFN (models/moe.py) is ROADMAP item 10a",
    "mamba": "the Mamba mixer (models/mamba.py) is ROADMAP item 10b",
    "mlstm": "the mLSTM mixer (models/xlstm_blocks.py) is ROADMAP item 10c",
    "slstm": "the sLSTM mixer (models/xlstm_blocks.py) is ROADMAP item 10c",
}


def _not_ported(kind: str):
    return NotImplementedError(f"not ported yet: {_NOT_PORTED[kind]}")


def _check_ported(cfg: ModelConfig):
    for j, kind in enumerate(cfg.block_pattern):
        if kind not in ("attn", "attn_local"):
            if kind in _NOT_PORTED:
                raise _not_ported(kind)
            raise ValueError(kind)
        if cfg.ffn_kind(j) == "moe":
            raise _not_ported("moe")
    if cfg.remat:
        raise NotImplementedError(
            "not ported yet: remat=True (recompute per superblock, "
            "torch.utils.checkpoint) is ROADMAP item 10f")


def _init_block(generator, cfg: ModelConfig, pos: int, dtype):
    p = {"norm1": init_norm(cfg, cfg.d_model, dtype),
         "mixer": attn.init_attn(generator, cfg, dtype)}
    if cfg.ffn_kind(pos) == "dense":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype)
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_params(cfg: ModelConfig, generator):
    """Draws on the CPU from ``generator`` (a ``torch.Generator``)."""
    cfg.validate()
    _check_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    params = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                  dtype)}
    blocks = {}
    for j in range(cfg.period):
        per_sb = [_init_block(generator, cfg, j, dtype)
                  for _ in range(cfg.n_superblocks)]
        blocks[f"p{j}"] = tree_map(lambda *xs: torch.stack(xs), *per_sb)
    params["blocks"] = blocks
    params["final_norm"] = init_norm(cfg, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(generator, cfg.padded_vocab,
                                       cfg.d_model, dtype)
    return params


def _apply_block(cfg: ModelConfig, pos: int, p, h, positions):
    """One attention block (``_check_ported`` has ruled out the rest)."""
    x = apply_norm(cfg, p["norm1"], h)
    r = attn.attn_forward(p["mixer"], cfg, x, positions,
                          local=cfg.block_pattern[pos] == "attn_local")
    h = h + r * cfg.residual_scale
    if "ffn" in p:
        x = apply_norm(cfg, p["norm2"], h)
        h = h + apply_mlp(p["ffn"], x) * cfg.residual_scale
    return h


def embed_tokens(cfg: ModelConfig, params, tokens):
    return F.embedding(tokens, params["embed"]) * cfg.embed_scale


def forward(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            positions=None, return_hidden: bool = False):
    """Full-sequence forward (train / prefill).

    tokens: (B, S_txt) int or None; embeds: (B, S_front, d) modality-
    frontend embeddings prepended to the token embeddings (VLM/audio stub).
    Returns (logits (B,S,V_pad), moe_aux), aux 0 for the ported families.
    """
    _check_ported(cfg)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(torch_dtype(cfg.dtype)))
    if tokens is not None:
        parts.append(embed_tokens(cfg, params, tokens))
    h = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    B, S, _ = h.shape
    if positions is None:
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
    for sb in range(cfg.n_superblocks):
        for j in range(cfg.period):
            p = tree_map(lambda x: x[sb], params["blocks"][f"p{j}"])
            h = _apply_block(cfg, j, p, h, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, aux
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ head.T.to(h.dtype)) * cfg.logit_scale
    return softcap(logits, cfg.final_softcap), aux


# ------------------------------------------------------------------ loss
def vocab_mask(cfg: ModelConfig, device=None):
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def next_token_loss(cfg: ModelConfig, params, tokens, *, embeds=None):
    """Causal LM loss over the token portion (frontend positions
    excluded).  Returns (total, ce)."""
    logits, aux = forward(cfg, params, tokens, embeds=embeds)
    n_front = 0 if embeds is None else embeds.shape[1]
    logits = logits[:, n_front:, :]
    lg = logits[:, :-1].to(torch.float32)
    lbl = tokens[:, 1:].long()
    lg = torch.where(vocab_mask(cfg, lg.device)[None, None], lg,
                     attn.NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, lbl[..., None])[..., 0]
    ce = torch.mean(lse - picked)
    return ce + cfg.router_aux_coef * aux, ce
