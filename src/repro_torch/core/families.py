"""Ready-made ``FLModelFamily`` adapters: the paper's CNN and a small MLP.

``init(generator, level)`` draws on the CPU from a ``torch.Generator``; the
engine moves parameters to its device.  ``param_specs`` stays None until the
tensor-parallel slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distill import ce_loss
from repro_torch.core.server import FLModelFamily
from repro_torch.models import cnn


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
