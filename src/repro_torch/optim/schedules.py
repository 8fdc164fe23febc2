"""Learning-rate schedules: constant, cosine, and MiniCPM's WSD
(Warmup-Stable-Decay) [arXiv:2404.06395 §4], a torch copy of
``repro.optim.schedules``.

Each schedule is a function of the step (an int or a tensor) that returns
an fp32 scalar tensor, computed in the JAX package's order of fp32
operations, so both packages give the same learning rate at every step.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(lr: float, total_steps: int, warmup: int = 0,
           min_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        w = torch.clip(step / max(warmup, 1), 0, 1)
        prog = torch.clip((step - warmup) / max(total_steps - warmup, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * torch.where(step < warmup, w, cos)
    return f


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.1,
        decay_frac: float = 0.1, min_frac: float = 0.1):
    """Warmup, then a flat lr, then an exponential decay to ``min_frac``
    over the last ``decay_frac`` of training."""
    warmup = max(1, int(total_steps * warmup_frac))
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        step = _f32(step)
        w = torch.clip(step / warmup, 0, 1)
        d_prog = torch.clip((step - decay_start)
                            / max(total_steps - decay_start, 1), 0, 1)
        decay = torch.pow(_f32(min_frac), d_prog)
        val = torch.where(step < warmup, w,
                          torch.where(step < decay_start, _f32(1.0), decay))
        return lr * val
    return f


def get(name: str, lr: float, total_steps: int, warmup: int = 0):
    if name == "constant":
        return constant(lr)
    if name == "cosine":
        return cosine(lr, total_steps, warmup)
    if name == "wsd":
        return wsd(lr, total_steps,
                   warmup_frac=warmup / max(total_steps, 1) or 0.1)
    raise ValueError(name)
