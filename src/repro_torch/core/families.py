"""Ready-made ``FLModelFamily`` adapters: the paper's CNN, a small MLP and
the federated LM family.

``init(generator, level)`` draws on the CPU from a ``torch.Generator``; the
engine moves parameters to its device.  ``param_specs(level, template,
msize, axis)`` gives each leaf's tensor-parallel split as a
``launch.sharding`` spec (``{axis: dim}``, or ``{}`` for a whole leaf), as
the JAX families' PartitionSpecs do; under a TP context (``models.tp``)
``loss_and_logits`` runs the rank's slice of the model and returns the
whole (B, classes) logits on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distill import ce_loss
from repro_torch.core.scaling import compress_config, model_bytes, param_count
from repro_torch.core.server import FLModelFamily
from repro_torch.launch.sharding import tp_specs
from repro_torch.models import cnn, tp, transformer


def cnn_family(*, classes: int = 10, in_channels: int = 1, alpha: float = 0.5,
               base_width: float = 0.25, input_hw: int = 14) -> FLModelFamily:
    def init(generator, level):
        return cnn.init_params(generator, in_channels=in_channels,
                               classes=classes, alpha=alpha, level=level,
                               base_width=base_width)

    def loss_and_logits(level, params, batch):
        logits = cnn.forward(params, batch["x"],
                             cnn.filters(alpha, level, base_width))
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

    def param_specs(level, template, msize, axis):
        """Megatron's conv pairing: even convs split their output channels
        (dim 3), odd convs their input channels (dim 2), so a split
        activation feeds straight in; the dense head is row-parallel (its
        input channels arrive split from the last, even, conv).  Widths
        that do not divide ``msize`` are demoted to whole leaves
        downstream."""
        convs = [{"w": {axis: 3}, "b": {axis: 0}} if i % 2 == 0
                 else {"w": {axis: 2}, "b": {}}
                 for i in range(len(template["convs"]))]
        return {"convs": convs, "dense": {"w": {axis: 0}, "b": {}}}

    return FLModelFamily(init=init, loss_and_logits=loss_and_logits,
                         model_bytes=mb, flops_per_sample=flops,
                         param_specs=param_specs)


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
        split = tp.splits(width(level))
        if split:
            x = tp.copy_to_tp(x)
        z = F.relu(x @ params["w1"] + params["b1"])
        logits = z @ params["w2"]
        if split:
            logits = tp.reduce_from_tp(logits)
        logits = logits + params["b2"]
        return ce_loss(logits, batch["y"]).mean(), logits

    def mb(level):
        h = width(level)
        return 4.0 * (in_dim * h + h + h * classes + classes)

    def param_specs(level, template, msize, axis):
        # column-parallel layer 1, row-parallel layer 2: one all_reduce per
        # forward (the canonical Megatron MLP split)
        return {"w1": {axis: 1}, "b1": {axis: 0}, "w2": {axis: 0}, "b2": {}}

    return FLModelFamily(
        init=init, loss_and_logits=loss_and_logits, model_bytes=mb,
        flops_per_sample=lambda l: 2.0 * (in_dim * width(l)
                                          + width(l) * classes),
        param_specs=param_specs)


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
        if transformer.vocab_split(cfg):
            # vocab-parallel loss; KD sees the whole (B, V_pad) logits
            ce = torch.mean(tp.vocab_parallel_ce(lg, lbl))
            kd_logits = tp.gather_from_tp(logits[:, -1], -1)
        else:
            lse = torch.logsumexp(lg, dim=-1)
            picked = torch.gather(lg, -1, lbl[..., None])[..., 0]
            ce = torch.mean(lse - picked)
            kd_logits = logits[:, -1]
        # the router's aux loss is replicated on every rank: added once
        return ce + cfg.router_aux_coef * aux, kd_logits

    def param_specs(level, template, msize, axis):
        """The launch stack's Megatron name rules (``tp_specs``), as JAX's
        family gives them for every arch: vocab-parallel embed and head,
        column-parallel wq / wk / wv / up / in_proj ..., row-parallel wo /
        down / out_proj ..., MoE experts split on d_ff or (``"ep"``) on
        the expert axis, routers and small leaves whole.  The FL build is
        the decoder-only ``transformer`` model for every family (the
        enc-dec arch included), and its TP forward covers every mixer and
        FFN (``models.tp``)."""
        return tp_specs(cfg_at(level), template, msize, axis)

    return FLModelFamily(
        init=init, loss_and_logits=loss_and_logits,
        model_bytes=lambda l: float(model_bytes(cfg_at(l))),
        flops_per_sample=lambda l: 6.0 * param_count(cfg_at(l)),
        param_specs=param_specs)
