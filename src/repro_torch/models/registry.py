"""Uniform model API over the families: init / forward / loss / cache /
decode, a torch copy of ``repro.models.registry``.

``batch`` layout by family:
  * decoder-only (dense / moe / hybrid / ssm): ``{"tokens": (B, S) int}``
  * vlm:    ``{"tokens": (B, S_txt)}``, ``{"embeds": (B, S_front, d)}``
  * encdec: ``{"tokens": (B, S_tgt)}``, ``{"embeds": (B, S_src, d)}``
(the ``embeds`` are a modality-frontend stub).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import encdec, transformer


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family == "encdec"


def _module(cfg: ModelConfig):
    return encdec if is_encdec(cfg) else transformer


def init_params(cfg: ModelConfig, generator):
    """Draws from ``generator`` on its device."""
    return _module(cfg).init_params(cfg, generator)


def forward(cfg: ModelConfig, params, batch):
    if is_encdec(cfg):
        return encdec.forward(cfg, params, batch["tokens"],
                              embeds=batch["embeds"])
    return transformer.forward(cfg, params, batch.get("tokens"),
                               embeds=batch.get("embeds"))


def loss_fn(cfg: ModelConfig, params, batch):
    """Returns (total_loss, ce): next-token CE (+ MoE aux)."""
    if is_encdec(cfg):
        logits, _ = encdec.forward(cfg, params, batch["tokens"],
                                   embeds=batch["embeds"])
        ce = transformer.lm_ce(cfg, logits, batch["tokens"])
        return ce, ce
    return transformer.next_token_loss(cfg, params, batch["tokens"],
                                       embeds=batch.get("embeds"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int = 0,
               device=None):
    """Zeroed decode cache.  For enc-dec the cross K/V are zeros of
    ``src_len`` (default ``max_len // 8``) frames until
    ``encdec.build_cross_cache`` fills them."""
    if is_encdec(cfg):
        return encdec.init_cache(cfg, batch, max_len,
                                 src_len or max_len // 8, device)
    return transformer.init_cache(cfg, batch, max_len, device)


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    return _module(cfg).decode_step(cfg, params, cache, token, pos)


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))
