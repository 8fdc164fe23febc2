"""Master-slave knowledge distillation (§IV-C).

The master cluster's trained model guides every slave cluster's training:
L = alpha * CE(student, labels)
    + (1 - alpha) * T^2 * KL(softmax(teacher / T) || softmax(student / T)).

Two routes compute it, and they differ in what they accept:

* the plain route (``use_kernel=False``, the default) is autograd-
  differentiable and takes a ``valid_mask`` over the vocabulary.  Slave
  training uses it, as in the JAX package.
* the kernel route (``use_kernel=True``) is the fused distill kernel
  (``kernels/distill``) on CUDA tensors and its plain version on CPU
  tensors.  It is forward only, like the JAX kernel: asking it for a
  gradient raises.  It takes no ``valid_mask``: passing one raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.distill import ops as distill_ops

_NEG = -2.0 ** 30


def kl_teacher_student(teacher_logits, student_logits, T: float = 1.0,
                       valid_mask=None):
    """KL(p_T || p_S) per example, temperature-scaled logits in fp32."""
    t = teacher_logits.to(torch.float32) / T
    s = student_logits.to(torch.float32) / T
    if valid_mask is not None:
        t = torch.where(valid_mask, t, torch.full_like(t, _NEG))
        s = torch.where(valid_mask, s, torch.full_like(s, _NEG))
    t_lse = torch.logsumexp(t, dim=-1, keepdim=True)
    s_lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p_t = torch.exp(t - t_lse)
    return torch.sum(p_t * ((t - t_lse) - (s - s_lse)), dim=-1)


def ce_loss(logits, labels, valid_mask=None):
    lg = logits.to(torch.float32)
    if valid_mask is not None:
        lg = torch.where(valid_mask, lg, torch.full_like(lg, _NEG))
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return lse - picked


def kd_loss(student_logits, labels, teacher_logits, *, T: float = 2.0,
            alpha: float = 0.3, valid_mask=None, use_kernel: bool = False):
    """Per-example Hinton-KD loss, mean-reduced."""
    if use_kernel:
        if valid_mask is not None:
            raise ValueError("the distill kernel route takes no valid_mask")
        return distill_ops.kd_loss(student_logits, labels, teacher_logits,
                                   T=T, alpha=alpha)
    ce = ce_loss(student_logits, labels, valid_mask)
    kl = kl_teacher_student(teacher_logits, student_logits, T, valid_mask)
    return torch.mean(alpha * ce + (1.0 - alpha) * (T ** 2) * kl)
