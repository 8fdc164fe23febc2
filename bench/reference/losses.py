"""Cross-entropy and Hinton's distillation loss in fp32."""
from __future__ import annotations

import torch


def ce(z, y):
    """Per-example -log softmax(z)[y]."""
    z = z.float()
    picked = torch.gather(z, -1, y.long()[..., None])[..., 0]
    return torch.logsumexp(z, -1) - picked


def kd(z, y, t, T, alpha):
    """mean(alpha * CE(z, y) + (1 - alpha) * T^2 * KL(softmax(t/T) ||
    softmax(z/T)))."""
    zs, ts = z.float() / T, t.float() / T
    lt = ts - torch.logsumexp(ts, -1, keepdim=True)
    ls = zs - torch.logsumexp(zs, -1, keepdim=True)
    kl = torch.sum(torch.exp(lt) * (lt - ls), -1)
    return torch.mean(alpha * ce(z, y) + (1.0 - alpha) * T ** 2 * kl)
