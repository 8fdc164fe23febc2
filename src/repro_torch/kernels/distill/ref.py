"""Plain PyTorch version of the distill kernel: the log-sum-exp form."""
from __future__ import annotations

import torch


def kd_loss_rows(student, teacher, labels, *, T: float = 2.0,
                 alpha: float = 0.3):
    """(N, V) student and teacher logits, (N,) labels -> (N,) fp32
    ``alpha * CE + (1 - alpha) * T^2 * KL(softmax(t/T) || softmax(s/T))``."""
    s = student.to(torch.float32)
    t = teacher.to(torch.float32)
    sT, tT = s / T, t / T
    t_lse = torch.logsumexp(tT, dim=-1, keepdim=True)
    s_lse = torch.logsumexp(sT, dim=-1, keepdim=True)
    p_t = torch.exp(tT - t_lse)
    kl = torch.sum(p_t * ((tT - t_lse) - (sT - s_lse)), dim=-1)
    lse1 = torch.logsumexp(s, dim=-1)
    picked = torch.gather(s, 1, labels.long()[:, None])[:, 0]
    return alpha * (lse1 - picked) + (1.0 - alpha) * (T ** 2) * kl
