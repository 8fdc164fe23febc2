"""The paper's CNN (Fed-RAC Sec. V-A), plain PyTorch: 3x3 SAME
convolutions with ReLU, a 2x2/2 max-pool after every second convolution
while both sides are >= 2, a global mean pool and a dense head.  Inputs
are NHWC, convolution weights HWIO and the head (in, out); level l runs
the conv widths times alpha**l (the paper compresses only the convs).
Parameters are a flat {path: tensor} dict."""
from __future__ import annotations

import math

import torch

from bench.reference import losses


def widths(cfg, level):
    s = cfg["base_width"] * cfg["alpha"] ** level
    return [max(4, int(round(f * s))) for f in cfg["base_filters"]]


def init(cfg, level, seed):
    """He-normal convs (sqrt(2 / (9 cin))), head cin**-0.5, zero biases,
    drawn in this order from a CPU generator seeded with seed + level."""
    g = torch.Generator().manual_seed(seed + level)
    out, cin = {}, cfg["in_channels"]
    for i, f in enumerate(widths(cfg, level)):
        out[f"convs/{i}/w"] = torch.randn((3, 3, cin, f), generator=g) \
            * math.sqrt(2.0 / (9 * cin))
        out[f"convs/{i}/b"] = torch.zeros(f)
        cin = f
    out["dense/w"] = torch.randn((cin, cfg["classes"]), generator=g) \
        * cin ** -0.5
    out["dense/b"] = torch.zeros(cfg["classes"])
    return out


def sizes(cfg, level):
    """Procedure 2's (model bytes, FLOPs per sample): fp32 parameters, and
    the FL family's conv count 2 * 9 * cin * f per pixel, the pixel count
    divided by 4 after every second conv."""
    total, cin = 0, cfg["in_channels"]
    fl, cur = 0.0, cfg["image_hw"] ** 2
    for i, f in enumerate(widths(cfg, level)):
        total += 9 * cin * f + f
        fl += cur * cin * f * 9 * 2
        cin = f
        if i % 2 == 1:
            cur = max(1, cur // 4)
    total += cin * cfg["classes"] + cfg["classes"]
    return total * 4.0, fl


def logits(cfg, level, p, x, num):
    h = x.permute(0, 3, 1, 2)
    n = len(cfg["base_filters"])
    for i in range(n):
        w = p[f"convs/{i}/w"].permute(3, 2, 0, 1)
        h = torch.relu(num.conv2d(h, w, p[f"convs/{i}/b"]))
        if i % 2 == 1 and min(h.shape[-2:]) >= 2:
            h = torch.nn.functional.max_pool2d(h, 2, 2)
    h = h.mean(dim=(-2, -1))
    return num.mm(h, p["dense/w"]) + p["dense/b"]


def step_loss(cfg, level, p, batch, teacher, fl, num):
    """A member step's objective: CE, or under KD the Hinton loss against
    the teacher's logits of the same batch."""
    z = logits(cfg, level, p, batch["x"], num)
    if teacher is None:
        return losses.ce(z, batch["y"]).mean()
    return losses.kd(z, batch["y"], teacher, fl["kd_T"], fl["kd_alpha"])


def teacher_logits(cfg, p0, batch, num):
    with torch.no_grad():
        return logits(cfg, 0, p0, batch["x"], num)


def evaluate(cfg, level, p, test, num):
    """Test accuracy."""
    with torch.no_grad():
        z = logits(cfg, level, p, test["x"], num)
    return float((torch.argmax(z, -1) == test["y"]).float().mean())
