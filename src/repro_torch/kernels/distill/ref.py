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


def _chunk_stats(s, t, labels, lo, hi, T):
    """The kernel's nine statistics of logits [lo, hi) of every row, fp32:
    maxima first, then the sums with one exp per statistic and logit."""
    sc, tc = s[:, lo:hi], t[:, lo:hi]
    sT, tT = sc / T, tc / T
    mt = tT.max(dim=1).values
    msT = sT.max(dim=1).values
    ms1 = sc.max(dim=1).values
    p = torch.exp(tT - mt[:, None])
    y = labels.long()
    inside = (y >= lo) & (y < hi)
    picked = torch.where(
        inside, torch.gather(sc, 1, (y - lo).clamp(0, hi - lo - 1)[:, None])[:, 0],
        torch.zeros_like(mt))
    return [mt, p.sum(1), (p * tT).sum(1), (p * sT).sum(1), msT,
            torch.exp(sT - msT[:, None]).sum(1), ms1,
            torch.exp(sc - ms1[:, None]).sum(1), picked]


def _merge(a, b):
    """Two partials of the nine statistics, rescaled to the larger maxima
    (the kernel's ``merge``)."""
    mt = torch.maximum(a[0], b[0])
    sa, sb = torch.exp(a[0] - mt), torch.exp(b[0] - mt)
    out = [mt, a[1] * sa + b[1] * sb, a[2] * sa + b[2] * sb,
           a[3] * sa + b[3] * sb]
    for i in (4, 6):
        m = torch.maximum(a[i], b[i])
        out += [m, a[i + 1] * torch.exp(a[i] - m)
                + b[i + 1] * torch.exp(b[i] - m)]
    return out + [a[8] + b[8]]


def kd_loss_rows_split(student, teacher, labels, *, chunk: int,
                       T: float = 2.0, alpha: float = 0.3):
    """The split-vocabulary kernel's arithmetic in plain ops: each row's
    logits cut into chunks of ``chunk`` (the last one shorter), each chunk's
    statistics, merged in chunk order, then the loss.  A model of the
    kernel for the tests; nothing on the main path calls it."""
    s = student.to(torch.float32)
    t = teacher.to(torch.float32)
    V = s.shape[1]
    st = None
    for lo in range(0, V, chunk):
        part = _chunk_stats(s, t, labels, lo, min(V, lo + chunk), T)
        st = part if st is None else _merge(st, part)
    mt, lt, a, b, msT, lsT, ms1, ls1, picked = st
    kl = a / lt - (mt + torch.log(lt)) + (msT + torch.log(lsT)) - b / lt
    ce = ms1 + torch.log(ls1) - picked
    return alpha * ce + (1.0 - alpha) * (T ** 2) * kl
