"""Encoder-decoder backbone (seamless-m4t-medium's text / unit
transformer), a torch copy of ``repro.models.encdec``.

The audio frontend is a stub: ``embeds`` are precomputed frame embeddings
``(B, S_src, d)``.  The encoder is bidirectional (its self-attention takes
the plain route whatever ``attn_impl`` says, as in JAX, since the flash
kernel serves causal attention); the decoder is causal with
cross-attention.  Encoder and decoder blocks are stacked per layer
(``enc_blocks``, ``dec_blocks``), and the decode cache holds per-layer
self-attention K/V plus the static cross-attention K/V (``xk``, ``xv``),
each with a leading layer axis, all as in JAX.

Under a tensor-parallel context (``models.tp``) the full-sequence forward
runs this rank's slices as the decoder-only model does: attention heads,
the MLP's hidden width and the vocabulary (embedding lookup and logits)
split; cross-attention's query heads read the K/V heads of the same
slice.  It needs the query and K/V head counts to divide the model axis.
The decode step splits as the decoder-only model's does: self-attention
through ``attention.attn_decode``, cross-attention over the cached
encoder K/V in the cache's layout (``attention.cross_attn_decode``), the
FFN Megatron-split and the vocabulary split.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import fsdp, tp
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       init_mlp, init_norm, softcap,
                                       torch_dtype)
from repro_torch.models.transformer import embed_tokens, stack, vocab_split


def _init_enc_block(generator, cfg: ModelConfig, dtype):
    dev = generator.device
    return {"norm1": init_norm(cfg, cfg.d_model, dtype, dev),
            "attn": attn.init_attn(generator, cfg, dtype),
            "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
            "ffn": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)}


def _init_dec_block(generator, cfg: ModelConfig, dtype):
    dev = generator.device
    return {"norm1": init_norm(cfg, cfg.d_model, dtype, dev),
            "self_attn": attn.init_attn(generator, cfg, dtype),
            "norm_x": init_norm(cfg, cfg.d_model, dtype, dev),
            "cross": attn.init_cross_attn(generator, cfg, dtype),
            "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
            "ffn": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)}


def init_params(cfg: ModelConfig, generator):
    """Draws from ``generator`` on its device."""
    dtype = torch_dtype(cfg.dtype)
    dev = generator.device
    enc = stack([_init_enc_block(generator, cfg, dtype)
                 for _ in range(cfg.n_enc_layers)])
    dec = stack([_init_dec_block(generator, cfg, dtype)
                 for _ in range(cfg.n_layers)])
    return {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_blocks": enc,
        "dec_blocks": dec,
        "enc_norm": init_norm(cfg, cfg.d_model, dtype, dev),
        "dec_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }


def _layer(params, name: str, i: int):
    """Layer ``i`` of the stacked ``name`` blocks (gathered whole under
    an FSDP context, ``models.fsdp``)."""
    return fsdp.layer(params[name], i, (name,))


def _positions(B, S, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(cfg: ModelConfig, params, embeds):
    B, S, _ = embeds.shape
    positions = _positions(B, S, embeds.device)
    h = embeds.to(torch_dtype(cfg.dtype))
    for i in range(cfg.n_enc_layers):
        p = _layer(params, "enc_blocks", i)
        x = apply_norm(cfg, p["norm1"], h)
        h = h + attn.attn_forward(p["attn"], cfg, x, positions, causal=False)
        x = apply_norm(cfg, p["norm2"], h)
        h = h + apply_mlp(p["ffn"], x, cfg.d_ff)
    return apply_norm(cfg, fsdp.gather(params["enc_norm"], ("enc_norm",)),
                      h)


def _dec_body(cfg: ModelConfig, h, p, positions, kv):
    k, v = kv
    x = apply_norm(cfg, p["norm1"], h)
    h = h + attn.attn_forward(p["self_attn"], cfg, x, positions)
    x = apply_norm(cfg, p["norm_x"], h)
    h = h + attn.cross_attn_forward(p["cross"], cfg, x, k, v)
    x = apply_norm(cfg, p["norm2"], h)
    return h + apply_mlp(p["ffn"], x, cfg.d_ff)


def _logits(cfg: ModelConfig, params, h):
    h = apply_norm(cfg, fsdp.gather(params["dec_norm"], ("dec_norm",)), h)
    if vocab_split(cfg):
        h = tp.copy_to_tp(h)
    embed = fsdp.gather(params["embed"], ("embed",))
    logits = (h @ embed.T.to(h.dtype)) * cfg.logit_scale
    return softcap(logits, cfg.final_softcap)


def forward(cfg: ModelConfig, params, tokens, *, embeds, positions=None):
    """tokens: (B, S_tgt) decoder input; embeds: (B, S_src, d) frontend
    stub.  Returns (logits, 0)."""
    enc_out = encode(cfg, params, embeds)
    B, S = tokens.shape
    if positions is None:
        positions = _positions(B, S, tokens.device)
    h = embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        p = _layer(params, "dec_blocks", i)
        h = _dec_body(cfg, h, p, positions,
                      attn.cross_kv(p["cross"], cfg, enc_out))
    return (_logits(cfg, params, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
               device=None):
    dtype = torch_dtype(cfg.dtype)
    L = cfg.n_layers
    kv = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    xs = (L, batch, src_len, cfg.n_kv_heads, cfg.head_dim)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return {"k": z(kv), "v": z(kv), "xk": z(xs), "xv": z(xs)}


def build_cross_cache(cfg: ModelConfig, params, cache, embeds):
    """Run the encoder once and fill the static cross K/V (prefill side)."""
    enc_out = encode(cfg, params, embeds)
    kvs = [attn.cross_kv(_layer(params, "dec_blocks", i)["cross"], cfg,
                         enc_out) for i in range(cfg.n_layers)]
    xk = torch.stack([k for k, _ in kvs]).to(cache["xk"].dtype)
    xv = torch.stack([v for _, v in kvs]).to(cache["xv"].dtype)
    return dict(cache, xk=xk, xv=xv)


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token: (B,1) int; pos: the current position.  Returns (logits,
    cache), the cache a new dict (the cross K/V carried as they are)."""
    h = embed_tokens(cfg, params, token)
    nk, nv = [], []
    for i in range(cfg.n_layers):
        p = _layer(params, "dec_blocks", i)
        x = apply_norm(cfg, p["norm1"], h)
        r, newc = attn.attn_decode(p["self_attn"], cfg,
                                   {"k": cache["k"][i], "v": cache["v"][i]},
                                   x, pos)
        h = h + r
        x = apply_norm(cfg, p["norm_x"], h)
        h = h + attn.cross_attn_decode(p["cross"], cfg, x, cache["xk"][i],
                                       cache["xv"][i])
        x = apply_norm(cfg, p["norm2"], h)
        h = h + apply_mlp(p["ffn"], x, cfg.d_ff)
        nk.append(newc["k"])
        nv.append(newc["v"])
    return _logits(cfg, params, h), dict(cache, k=torch.stack(nk),
                                         v=torch.stack(nv))
