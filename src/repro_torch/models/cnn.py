"""The paper's experimental model: C(128)-C(64)-C(128)-C(256)-C(512)-D(classes).

§V-A of Fed-RAC.  ``filters(level)`` scales every conv width by
alpha**level (the paper compresses only the conv layers) and leaves the
dense head at ``classes``.

The public interface keeps the JAX package's layouts: NHWC inputs, HWIO
conv weights, ``(in, out)`` dense weights, so that parameters and planes
carry across packages unchanged.  Inside, the forward permutes to NCHW and
OIHW for ``F.conv2d``.

Under a tensor-parallel context (``models.tp``) ``forward`` runs this
rank's channel slices, by ``core.families.cnn_family``'s split: even
convs split their output channels, odd convs their input channels (their
partial outputs summed by ``reduce_from_tp`` before the replicated bias
is added once), the dense head its rows; pooling stays local.  A width
that does not divide the model axis keeps its leaf whole, and the
activation is gathered or sliced to what the next layer takes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_leaves
from repro_torch.models import tp

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


def forward(params, x, widths=None):
    """x: (B, H, W, C) -> logits (B, classes).  3x3 "SAME" convs, ReLU, a
    2x2/2 max-pool after every odd conv while both sides are >= 2 (it
    floors, like "VALID" windows: 14 -> 7 -> 3), a global mean pool and the
    dense head.  Under a tensor-parallel context this is the rank's slice
    (the module docstring), and ``widths`` (the full conv widths,
    ``filters``) tells split leaves from whole ones; ``sliced`` says
    whether the activation holds this rank's channels (dim 1 in NCHW, the
    last dim after pooling) or all of them.  With no context nothing
    splits and the tp operations are identities."""
    if tp.tp_size() > 1:
        if widths is None:
            raise ValueError("the tensor-parallel CNN forward needs the "
                             "full conv widths")
        split = [tp.splits(w) for w in widths]
    else:
        split = [False] * len(params["convs"])
    x = x.permute(0, 3, 1, 2)
    sliced = False
    for i, p in enumerate(params["convs"]):
        w = p["w"].permute(3, 2, 0, 1)
        if i % 2 == 0:                  # output channels split
            if sliced:
                x, sliced = tp.gather_from_tp(x, 1), False
            if split[i]:
                x, sliced = tp.copy_to_tp(x), True
            x = F.conv2d(x, w, p["b"], padding=1)
        elif split[i - 1]:              # input channels split
            if not sliced:
                x = tp.scatter_to_tp(x, 1)
            x = tp.reduce_from_tp(F.conv2d(x, w, None, padding=1))
            x, sliced = x + p["b"][:, None, None], False
        else:
            if sliced:
                x, sliced = tp.gather_from_tp(x, 1), False
            x = F.conv2d(x, w, p["b"], padding=1)
        x = _relu_pool(x, i)
    x = x.mean(dim=(-2, -1))
    d = params["dense"]
    if split[-1]:                       # row-parallel head
        if not sliced:
            x = tp.scatter_to_tp(x, -1)
        return tp.reduce_from_tp(x @ d["w"]) + d["b"]
    if sliced:
        x = tp.gather_from_tp(x, -1)
    return x @ d["w"] + d["b"]


def _relu_pool(x, i: int):
    x = F.relu(x)
    if i % 2 == 1 and min(x.shape[-2], x.shape[-1]) >= 2:
        x = F.max_pool2d(x, 2, 2)
    return x


def loss_fn(params, batch):
    """(mean cross-entropy, accuracy) of ``batch = {"x", "y"}``."""
    return logits_loss(forward(params, batch["x"]), batch["y"])


def logits_loss(logits, labels):
    """``loss_fn``'s (mean cross-entropy, accuracy) from the logits, for a
    caller that keeps them."""
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(lse - picked)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc


def param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
