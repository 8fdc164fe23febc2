"""Uniform model API over the families: init / forward / loss, a torch copy
of the decoder-only half of ``repro.models.registry``.

``batch`` layout (decoder-only: dense, and later moe / hybrid / ssm / vlm):
``{"tokens": (B, S) int}``, plus ``{"embeds": (B, S_front, d)}`` for a
modality frontend stub.  The enc-dec family raises until ROADMAP item 10d;
caches and decoding wait for item 10e.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import transformer


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family == "encdec"


def _decoder_only(cfg: ModelConfig):
    if is_encdec(cfg):
        raise NotImplementedError("not ported yet: the enc-dec family "
                                  "(models/encdec.py) is ROADMAP item 10d")


def init_params(cfg: ModelConfig, generator):
    _decoder_only(cfg)
    return transformer.init_params(cfg, generator)


def forward(cfg: ModelConfig, params, batch):
    _decoder_only(cfg)
    return transformer.forward(cfg, params, batch.get("tokens"),
                               embeds=batch.get("embeds"))


def loss_fn(cfg: ModelConfig, params, batch):
    """Returns (total_loss, ce): next-token CE (+ MoE aux)."""
    _decoder_only(cfg)
    return transformer.next_token_loss(cfg, params, batch["tokens"],
                                       embeds=batch.get("embeds"))


def param_count(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))
