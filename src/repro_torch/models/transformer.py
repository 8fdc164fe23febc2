"""Decoder-only LM over heterogeneous superblocks (dense / MoE / Mamba /
xLSTM / VLM), a torch copy of ``repro.models.transformer``: the
full-sequence forward and loss, and the cached one-token decode.

Parameters of each position-in-superblock are stacked across superblocks
(``blocks/p{j}/...`` leaves of shape ``(n_superblocks, ...)``), as in the
JAX package, so the pytree and its flat plane are the same in both
packages.  JAX runs the depth under ``lax.scan``; here a Python loop
indexes the stacked leaves, and ``decode_step`` restacks each position's
new cache.  ``remat=True`` recomputes each superblock's body in the
backward pass (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint`` of
the scan body) under autograd; under ``torch.func``'s transforms, which
take no saved-tensor hooks, it raises ``NotImplementedError`` naming the
cause (ROADMAP C6) rather than dropping the recompute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import mamba, xlstm_blocks as xb
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       init_mlp, init_norm, softcap,
                                       torch_dtype)
from repro_torch.models.moe import apply_moe, init_moe

_MIXER_INIT = {"attn": attn.init_attn, "attn_local": attn.init_attn,
               "mamba": mamba.init_mamba, "mlstm": xb.init_mlstm,
               "slstm": xb.init_slstm}


def _check_ported(cfg: ModelConfig):
    for kind in cfg.block_pattern:
        if kind not in _MIXER_INIT:
            raise ValueError(kind)


def _init_block(generator, cfg: ModelConfig, pos: int, dtype):
    ffn = cfg.ffn_kind(pos)
    dev = generator.device
    p = {"norm1": init_norm(cfg, cfg.d_model, dtype, dev),
         "mixer": _MIXER_INIT[cfg.block_pattern[pos]](generator, cfg, dtype)}
    if ffn == "dense":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, dev)
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    elif ffn == "moe":
        p["norm2"] = init_norm(cfg, cfg.d_model, dtype, dev)
        p["ffn"] = init_moe(generator, cfg, dtype)
    return p


def stack(trees):
    """Stack same-structured pytrees along a new leading axis (a view for
    one tree, so a single superblock is not copied)."""
    if len(trees) == 1:
        return tree_map(lambda x: x.unsqueeze(0), trees[0])
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_params(cfg: ModelConfig, generator):
    """Draws from ``generator`` (a ``torch.Generator``) on its device."""
    cfg.validate()
    _check_ported(cfg)
    dtype = torch_dtype(cfg.dtype)
    dev = generator.device
    params = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                  dtype)}
    blocks = {}
    for j in range(cfg.period):
        blocks[f"p{j}"] = stack([_init_block(generator, cfg, j, dtype)
                                 for _ in range(cfg.n_superblocks)])
    params["blocks"] = blocks
    params["final_norm"] = init_norm(cfg, cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(generator, cfg.padded_vocab,
                                       cfg.d_model, dtype)
    return params


def _ffn(cfg: ModelConfig, pos: int, p, h):
    """The block's FFN half: (h, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if "ffn" in p:
        x = apply_norm(cfg, p["norm2"], h)
        if cfg.ffn_kind(pos) == "moe":
            r, aux = apply_moe(p["ffn"], cfg, x)
        else:
            r = apply_mlp(p["ffn"], x)
        h = h + r * cfg.residual_scale
    return h, aux


def _apply_block(cfg: ModelConfig, pos: int, p, h, positions):
    kind = cfg.block_pattern[pos]
    x = apply_norm(cfg, p["norm1"], h)
    if kind in ("attn", "attn_local"):
        r = attn.attn_forward(p["mixer"], cfg, x, positions,
                              local=kind == "attn_local")
    elif kind == "mamba":
        r = mamba.mamba_forward(p["mixer"], cfg, x)
    elif kind == "mlstm":
        r = xb.mlstm_forward(p["mixer"], cfg, x)
    else:
        r = xb.slstm_forward(p["mixer"], cfg, x)
    return _ffn(cfg, pos, p, h + r * cfg.residual_scale)


def embed_tokens(cfg: ModelConfig, params, tokens):
    return F.embedding(tokens, params["embed"]) * cfg.embed_scale


def _logits(cfg: ModelConfig, params, h):
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ head.T.to(h.dtype)) * cfg.logit_scale
    return softcap(logits, cfg.final_softcap)


def forward(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            positions=None, return_hidden: bool = False):
    """Full-sequence forward (train / prefill).

    tokens: (B, S_txt) int or None; embeds: (B, S_front, d) modality-
    frontend embeddings prepended to the token embeddings (VLM/audio stub).
    Returns (logits (B,S,V_pad), moe_aux), aux summed over every MoE block.
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

    def sb_body(h, sbp):
        aux_sb = torch.zeros((), dtype=torch.float32, device=h.device)
        for j in range(cfg.period):
            h, a = _apply_block(cfg, j, sbp[f"p{j}"], h, positions)
            aux_sb = aux_sb + a
        return h, aux_sb

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for sb in range(cfg.n_superblocks):
        sbp = {k: tree_map(lambda x: x[sb], v)
               for k, v in params["blocks"].items()}
        if cfg.remat:
            h, aux_sb = _remat(sb_body, h, sbp)
        else:
            h, aux_sb = sb_body(h, sbp)
        aux = aux + aux_sb
    h = apply_norm(cfg, params["final_norm"], h)
    if return_hidden:
        return h, aux
    return _logits(cfg, params, h), aux


def _remat(fn, h, sbp):
    """``fn(h, sbp)`` with its activations recomputed in the backward pass
    instead of kept.  ``torch.func``'s grad transforms refuse the
    saved-tensor hooks this needs; that refusal is raised as
    ``NotImplementedError`` with its cause."""
    try:
        return checkpoint(fn, h, sbp, use_reentrant=False)
    except RuntimeError as e:
        if "saved tensor hooks" not in str(e):
            raise
        raise NotImplementedError(
            "remat=True recomputes each superblock through "
            "torch.utils.checkpoint, and torch.func's grad transforms (the "
            "FL engine's vmapped member step) take no saved-tensor hooks; "
            "train with remat=False there (ROADMAP C6)") from e


# ------------------------------------------------------------------ decode
def _init_block_cache(cfg: ModelConfig, pos: int, batch: int, max_len: int,
                      dtype, device):
    kind = cfg.block_pattern[pos]
    if kind in ("attn", "attn_local"):
        return attn.init_attn_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return mamba.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xb.init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return xb.init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    dtype = torch_dtype(cfg.dtype)
    return {f"p{j}": tree_map(
        lambda x: x[None].repeat(cfg.n_superblocks, *([1] * x.dim())),
        _init_block_cache(cfg, j, batch, max_len, dtype, device))
        for j in range(cfg.period)}


def _decode_block(cfg: ModelConfig, pos_j: int, p, cache_j, h, pos):
    kind = cfg.block_pattern[pos_j]
    x = apply_norm(cfg, p["norm1"], h)
    if kind in ("attn", "attn_local"):
        r, newc = attn.attn_decode(p["mixer"], cfg, cache_j, x, pos,
                                   local=kind == "attn_local")
    elif kind == "mamba":
        r, newc = mamba.mamba_decode(p["mixer"], cfg, cache_j, x, pos)
    elif kind == "mlstm":
        r, newc = xb.mlstm_decode(p["mixer"], cfg, cache_j, x, pos)
    else:
        r, newc = xb.slstm_decode(p["mixer"], cfg, cache_j, x, pos)
    h, _ = _ffn(cfg, pos_j, p, h + r * cfg.residual_scale)
    return h, newc


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token: (B,1) int; pos: the current position.  Returns
    (logits (B,1,V), cache), the cache a new pytree."""
    _check_ported(cfg)
    h = embed_tokens(cfg, params, token)
    new = {f"p{j}": [] for j in range(cfg.period)}
    for sb in range(cfg.n_superblocks):
        for j in range(cfg.period):
            p = tree_map(lambda x: x[sb], params["blocks"][f"p{j}"])
            c = tree_map(lambda x: x[sb], cache[f"p{j}"])
            h, c = _decode_block(cfg, j, p, c, h, pos)
            new[f"p{j}"].append(c)
    h = apply_norm(cfg, params["final_norm"], h)
    return _logits(cfg, params, h), {k: stack(v) for k, v in new.items()}


# ------------------------------------------------------------------ loss
def vocab_mask(cfg: ModelConfig, device=None):
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def next_token_loss(cfg: ModelConfig, params, tokens, *, embeds=None):
    """Causal LM loss over the token portion (frontend positions
    excluded).  Returns (total, ce), total adding the MoE aux term."""
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
