"""Client-side local training, batched over the member axis.

``local_update`` runs tau SGD steps over pre-sampled batches; the per-step
mask realizes heterogeneous tau_i inside one uniform computation, so a whole
cluster trains under one ``torch.func.vmap`` (``make_cluster_update``).

Supports plain CE, FedProx (proximal term) and master-slave KD (teacher
logits given per batch).  Parameters are functional pytrees (``core.tree``):
each step is ``torch.func.grad_and_value`` of the loss, and the steps are a
Python loop.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.distill import kd_loss
from repro_torch.core.tree import tree_leaves, tree_map


def local_update(loss_fn: Callable, params, batches, lr: float, *,
                 step_mask=None, prox_mu: float = 0.0, global_params=None,
                 teacher_logits=None, kd_T: float = 2.0,
                 kd_alpha: float = 0.3):
    """Run the steps along the leading axis of ``batches``.

    loss_fn(params, batch) -> (loss, logits).  If ``teacher_logits`` (same
    leading steps axis) is given, the KD objective replaces plain CE.
    Returns (new_params, mean_loss) with mean_loss =
    sum(loss * mask) / max(sum(mask), 1).
    """
    g0 = global_params if global_params is not None else params

    def step_loss(p, batch, t_logits):
        if t_logits is None:
            loss, _ = loss_fn(p, batch)
        else:
            _, logits = loss_fn(p, batch)
            loss = kd_loss(logits, batch["y"], t_logits, T=kd_T,
                           alpha=kd_alpha)
        if prox_mu > 0.0:
            sq = sum(torch.sum((a - b.to(a.dtype)) ** 2)
                     for a, b in zip(tree_leaves(p), tree_leaves(g0)))
            loss = loss + 0.5 * prox_mu * sq
        return loss

    step = grad_and_value(step_loss)
    steps = tree_leaves(batches)[0].shape[0]
    mask = (torch.ones(steps, device=tree_leaves(params)[0].device)
            if step_mask is None else step_mask)
    p, losses = params, []
    for i in range(steps):
        batch = tree_map(lambda x: x[i], batches)
        t_logits = None if teacher_logits is None else teacher_logits[i]
        grads, loss = step(p, batch, t_logits)
        m = mask[i]
        p = tree_map(lambda w, g: w - (lr * m * g.to(torch.float32)
                                       ).to(w.dtype), p, grads)
        losses.append(loss * m)
    denom = torch.clamp(mask.sum(), min=1.0)
    return p, torch.stack(losses).sum() / denom


def make_cluster_update(loss_fn: Callable, lr: float, **kw):
    """``local_update`` vmapped over the member axis (params, batches,
    masks and teacher logits all stacked along it)."""
    fn = partial(local_update, loss_fn, lr=lr, **kw)

    def cluster_update(params_stack, batches_stack, step_masks,
                       teachers=None):
        if teachers is None:
            return vmap(lambda p, b, m: fn(p, b, step_mask=m))(
                params_stack, batches_stack, step_masks)
        return vmap(lambda p, b, m, t: fn(p, b, step_mask=m,
                                          teacher_logits=t))(
            params_stack, batches_stack, step_masks, teachers)

    return cluster_update
