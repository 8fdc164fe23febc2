"""The paper's experimental model: C(128)-C(64)-C(128)-C(256)-C(512)-D(classes).

§V-A of Fed-RAC.  ``filters(level)`` scales every conv width by
alpha**level (the paper compresses only the conv layers) and leaves the
dense head at ``classes``.

The public interface keeps the JAX package's layouts: NHWC inputs, HWIO
conv weights, ``(in, out)`` dense weights, so that parameters and planes
carry across packages unchanged.  Inside, the forward permutes to NCHW and
OIHW for ``F.conv2d``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_leaves

BASE_FILTERS = (128, 64, 128, 256, 512)


def filters(alpha: float = 1.0, level: int = 0, base_width: float = 1.0):
    """base_width scales the whole family; alpha**level is the paper's
    per-cluster compression."""
    s = base_width * alpha ** level
    return tuple(max(4, int(round(f * s))) for f in BASE_FILTERS)


def init_params(generator: torch.Generator, *, in_channels: int = 1,
                classes: int = 10, alpha: float = 1.0, level: int = 0,
                base_width: float = 1.0, dtype=torch.float32):
    """He-normal convs (scale sqrt(2 / (9 cin))), head scaled cin**-0.5,
    zero biases; drawn on the CPU from ``generator``."""
    fs = filters(alpha, level, base_width)
    params = {"convs": []}
    cin = in_channels
    for f in fs:
        w = torch.randn((3, 3, cin, f), generator=generator) * math.sqrt(
            2.0 / (9 * cin))
        params["convs"].append({"w": w.to(dtype),
                                "b": torch.zeros((f,), dtype=dtype)})
        cin = f
    params["dense"] = {
        "w": (torch.randn((cin, classes), generator=generator)
              * cin ** -0.5).to(dtype),
        "b": torch.zeros((classes,), dtype=dtype)}
    return params


def param_count_of(*, in_channels: int = 1, classes: int = 10,
                   alpha: float = 1.0, level: int = 0,
                   base_width: float = 1.0) -> int:
    """Parameter count from the shapes alone (no draw)."""
    total, cin = 0, in_channels
    for f in filters(alpha, level, base_width):
        total += 9 * cin * f + f
        cin = f
    return total + cin * classes + classes


def forward(params, x):
    """x: (B, H, W, C) -> logits (B, classes).  3x3 "SAME" convs, ReLU, a
    2x2/2 max-pool after every odd conv while both sides are >= 2 (it
    floors, like "VALID" windows: 14 -> 7 -> 3), a global mean pool and the
    dense head."""
    x = x.permute(0, 3, 1, 2)
    for i, p in enumerate(params["convs"]):
        x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)
        x = F.relu(x)
        if i % 2 == 1 and min(x.shape[-2], x.shape[-1]) >= 2:
            x = F.max_pool2d(x, 2, 2)
    x = x.mean(dim=(-2, -1))
    return x @ params["dense"]["w"] + params["dense"]["b"]


def param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
