"""Ready-made ``FLModelFamily`` adapters: the paper's CNN, a small MLP and
the federated LM family.

``init(generator, level)`` draws on the CPU from a ``torch.Generator``; the
engine moves parameters to its device.  ``param_specs`` stays None until the
tensor-parallel slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distill import ce_loss
from repro_torch.core.scaling import compress_config, model_bytes, param_count
from repro_torch.core.server import FLModelFamily
from repro_torch.models import cnn, transformer


def cnn_family(*, classes: int = 10, in_channels: int = 1, alpha: float = 0.5,
               base_width: float = 0.25, input_hw: int = 14) -> FLModelFamily:
    def init(generator, level):
        return cnn.init_params(generator, in_channels=in_channels,
                               classes=classes, alpha=alpha, level=level,
                               base_width=base_width)

    def loss_and_logits(level, params, batch):
        logits = cnn.forward(params, batch["x"])
        return ce_loss(logits, batch["y"]).mean(), logits

    def mb(level):
        return cnn.param_count_of(in_channels=in_channels, classes=classes,
                                  alpha=alpha, level=level,
                                  base_width=base_width) * 4.0

    def flops(level):
        fs = cnn.filters(alpha, level, base_width)
        hw = input_hw ** 2
        total, cin, cur = 0.0, in_channels, hw
        for i, f in enumerate(fs):
            total += cur * cin * f * 9 * 2
            cin = f
            if i % 2 == 1:
                cur = max(1, cur // 4)
        return total

    return FLModelFamily(init=init, loss_and_logits=loss_and_logits,
                         model_bytes=mb, flops_per_sample=flops)


def mlp_family(*, classes: int = 10, in_dim: int = 14 * 14,
               hidden: int = 32, alpha: float = 0.5) -> FLModelFamily:
    """Two-layer MLP family: the small-model end of the spectrum."""
    def width(level):
        return max(4, int(hidden * alpha ** level))

    def init(generator, level):
        h = width(level)
        return {"w1": torch.randn((in_dim, h), generator=generator) * 0.05,
                "b1": torch.zeros((h,)),
                "w2": torch.randn((h, classes), generator=generator) * 0.05,
                "b2": torch.zeros((classes,))}

    def loss_and_logits(level, params, batch):
        x = batch["x"].reshape(batch["x"].shape[0], -1)
        z = F.relu(x @ params["w1"] + params["b1"])
        logits = z @ params["w2"] + params["b2"]
        return ce_loss(logits, batch["y"]).mean(), logits

    def mb(level):
        h = width(level)
        return 4.0 * (in_dim * h + h + h * classes + classes)

    return FLModelFamily(
        init=init, loss_and_logits=loss_and_logits, model_bytes=mb,
        flops_per_sample=lambda l: 2.0 * (in_dim * width(l)
                                          + width(l) * classes))


def lm_family(base_cfg: ModelConfig, alpha: float = 0.5) -> FLModelFamily:
    """Federated LM family: per-cluster α-compressed configs (same vocab,
    so KD-compatible logits).

    Batch contract: ``batch = {"tokens": (B, S)}``.  The LM loss derives its
    next-token labels from ``tokens[:, 1:]`` itself and reads no other key.
    Under KD the engine's batches also carry ``"y": (B,)``, the
    last-position token id, which ``core.client`` pairs as the hard label
    with this family's KD logits.  KD logits convention: ``loss_and_logits``
    returns the LAST-position distribution ``logits[:, -1]``, (B, V_pad), the
    (B, classes) shape the CNN and MLP families emit.  As in the JAX family,
    the padded vocabulary is not masked here."""
    def cfg_at(level):
        return compress_config(base_cfg, alpha, level)

    def init(generator, level):
        return transformer.init_params(cfg_at(level), generator)

    def loss_and_logits(level, params, batch):
        cfg = cfg_at(level)
        logits, aux = transformer.forward(cfg, params, batch["tokens"])
        lg = logits[:, :-1].to(torch.float32)
        lbl = batch["tokens"][:, 1:].long()
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1, lbl[..., None])[..., 0]
        ce = torch.mean(lse - picked) + cfg.router_aux_coef * aux
        return ce, logits[:, -1]

    return FLModelFamily(
        init=init, loss_and_logits=loss_and_logits,
        model_bytes=lambda l: float(model_bytes(cfg_at(l))),
        flops_per_sample=lambda l: 6.0 * param_count(cfg_at(l)))
