"""Decoder-only LM over heterogeneous superblocks (dense / MoE / Mamba /
xLSTM / VLM), a torch copy of ``repro.models.transformer``: the
full-sequence forward and loss, and the cached one-token decode.

Parameters of each position-in-superblock are stacked across superblocks
(``blocks/p{j}/...`` leaves of shape ``(n_superblocks, ...)``), as in the
JAX package, so the pytree and its flat plane are the same in both
packages.  JAX runs the depth under ``lax.scan``; here a Python loop
indexes the stacked leaves, and ``decode_step`` restacks each position's
new cache.  ``remat=True`` recomputes each superblock's body in the
backward pass, as JAX's ``jax.checkpoint`` of the scan body does, through
``Recompute``: an ``autograd.Function`` that keeps only the superblock's
inputs and recomputes through ``torch.func.vjp``, so one implementation
serves plain autograd (``launch/train.py``) and the FL engine's vmapped
``torch.func`` member step (which takes no saved-tensor hooks, so
``torch.utils.checkpoint`` cannot run there).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import attention as attn
from repro_torch.models import fsdp, mamba, tp, xlstm_blocks as xb
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
            r = apply_mlp(p["ffn"], x, cfg.d_ff)
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


def vocab_split(cfg: ModelConfig) -> bool:
    """Whether, under a tensor-parallel context, ``embed`` / ``lm_head``
    hold this rank's rows of the vocabulary (and the logits its slice)."""
    return tp.splits(cfg.padded_vocab)


def embed_tokens(cfg: ModelConfig, params, tokens):
    embed = fsdp.gather(params["embed"], ("embed",))
    if not vocab_split(cfg):
        return F.embedding(tokens, embed) * cfg.embed_scale
    # vocab-parallel lookup: this rank's rows, zero elsewhere, summed
    v = embed.shape[0]
    t = tokens - tp.tp_rank() * v
    inside = (t >= 0) & (t < v)
    e = F.embedding(t.clamp(0, v - 1), embed) * inside[..., None]
    return tp.reduce_from_tp(e) * cfg.embed_scale


def _logits(cfg: ModelConfig, params, h):
    """Logits (..., V_pad), or this rank's vocabulary slice of them under
    a tensor-parallel context (``vocab_split``)."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = fsdp.gather(params[name], (name,))
    if vocab_split(cfg):
        h = tp.copy_to_tp(h)
    logits = (h @ head.T.to(h.dtype)) * cfg.logit_scale
    return softcap(logits, cfg.final_softcap)


def forward(cfg: ModelConfig, params, tokens=None, *, embeds=None,
            positions=None, return_hidden: bool = False):
    """Full-sequence forward (train / prefill).

    tokens: (B, S_txt) int or None; embeds: (B, S_front, d) modality-
    frontend embeddings prepended to the token embeddings (VLM/audio stub).
    Returns (logits (B,S,V_pad), moe_aux), aux summed over every MoE block.
    Under a tensor-parallel context (``models.tp``) the forward runs this
    rank's slice of every split leaf, and the logits are its vocabulary
    slice when ``vocab_split``.
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

    sharded = fsdp.current()

    def sb_body(sb, h, sbp, positions):
        # the superblock's leaves gathered here, inside a remat's
        # recomputation too (``models.fsdp``)
        sbp = fsdp.gather_slice(sbp, sb, ("blocks",), sharded)
        aux_sb = torch.zeros((), dtype=torch.float32, device=h.device)
        for j in range(cfg.period):
            h, a = _apply_block(cfg, j, sbp[f"p{j}"], h, positions)
            aux_sb = aux_sb + a
        return h, aux_sb

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for sb in range(cfg.n_superblocks):
        sbp = fsdp.stack_slice(params["blocks"], sb, ("blocks",))
        body = functools.partial(sb_body, sb)
        if cfg.remat:
            h, aux_sb = _remat(body, h, sbp, positions)
        else:
            h, aux_sb = body(h, sbp, positions)
        aux = aux + aux_sb
    h = apply_norm(cfg, fsdp.gather(params["final_norm"], ("final_norm",)),
                   h)
    if return_hidden:
        return h, aux
    return _logits(cfg, params, h), aux


class Recompute(torch.autograd.Function):
    """``fn(*args)`` (a tuple of tensors) whose activations are recomputed
    in the backward pass instead of kept: the forward runs ``fn`` without
    recording, keeps only ``args``, and the backward runs ``fn`` again
    under ``torch.func.vjp`` for the gradients of the floating-point
    ``args`` (integer ones, such as positions, get none).  ``torch.func``
    takes it inside ``vmap(grad(...))`` through the generated vmap rule,
    where ``torch.utils.checkpoint``'s saved-tensor hooks are refused."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return tuple(fn(*args))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        args = ctx.saved_tensors
        diff = [i for i, a in enumerate(args) if a.is_floating_point()]

        def f(*xs):
            full = list(args)
            for i, x in zip(diff, xs):
                full[i] = x
            return tuple(ctx.fn(*full))

        _, vjp = torch.func.vjp(f, *(args[i] for i in diff))
        out = [None] * len(args)
        for i, g in zip(diff, vjp(grads)):
            out[i] = g
        return (None, *out)


def _remat(fn, h, sbp, positions):
    """``fn(h, sbp)`` -> (h, aux) through ``Recompute``, the superblock's
    parameter pytree passed as its flat leaves."""
    leaves = tree_leaves(sbp)

    def flat_fn(h, positions, *xs):
        return fn(h, tree_unflatten(sbp, list(xs)), positions)

    return Recompute.apply(flat_fn, h, positions, *leaves)


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
            p = fsdp.layer(params["blocks"][f"p{j}"], sb, ("blocks", f"p{j}"))
            c = tree_map(lambda x: x[sb], cache[f"p{j}"])
            h, c = _decode_block(cfg, j, p, c, h, pos)
            new[f"p{j}"].append(c)
    h = apply_norm(cfg, fsdp.gather(params["final_norm"], ("final_norm",)),
                   h)
    return _logits(cfg, params, h), {k: stack(v) for k, v in new.items()}


# ------------------------------------------------------------------ loss
def vocab_mask(cfg: ModelConfig, device=None):
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def next_token_loss(cfg: ModelConfig, params, tokens, *, embeds=None):
    """Causal LM loss over the token portion (frontend positions
    excluded).  Returns (total, ce), total adding the MoE aux term.  Under
    a tensor-parallel context whose logits are this rank's vocabulary
    slice (``vocab_split``) the loss is vocab-parallel."""
    logits, aux = forward(cfg, params, tokens, embeds=embeds)
    n_front = 0 if embeds is None else embeds.shape[1]
    ce = lm_ce(cfg, logits[:, n_front:, :], tokens)
    return ce + cfg.router_aux_coef * aux, ce


def lm_ce(cfg: ModelConfig, logits, tokens):
    """Mean next-token CE of logits (B, S, V_pad) over the valid
    vocabulary; vocab-parallel when the logits are this rank's vocabulary
    slice (``vocab_split``)."""
    lg = logits[:, :-1].to(torch.float32)
    lbl = tokens[:, 1:].long()
    mask = vocab_mask(cfg, lg.device)
    if vocab_split(cfg):
        v = lg.shape[-1]
        mask = mask[tp.tp_rank() * v:(tp.tp_rank() + 1) * v]
        lg = torch.where(mask[None, None], lg, attn.NEG_INF)
        return torch.mean(tp.vocab_parallel_ce(lg, lbl))
    lg = torch.where(mask[None, None], lg, attn.NEG_INF)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, lbl[..., None])[..., 0]
    return torch.mean(lse - picked)
