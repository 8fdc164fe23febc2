"""Optimizers as (init, update) pairs over parameter pytrees, a torch copy
of ``repro.optim.optimizers``.

``update(grads, state, params, lr)`` -> (params, state).  The update works
in place: the parameters and moments passed in are the ones returned,
changed, as the JAX package's training step donates them
(``donate_argnums``), so a step holds no second copy of either.  The
dtypes follow the JAX package: moments are fp32, ``t`` an int32 counter,
the AdamW step is computed in fp32 and cast to the parameter's dtype
before it is subtracted, so bf16 parameters round as JAX's do.  AdamW is
the training step's optimizer; SGD and momentum serve the FL clients.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (norm + 1e-9)), the scale
    cast to each gradient's dtype.  Returns new gradients."""
    if max_norm <= 0:
        return grads
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads)


def _lr(lr, device) -> torch.Tensor:
    return torch.as_tensor(lr, dtype=torch.float32, device=device)


def sgd() -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, lr):
        for w, g in zip(tree_leaves(params), tree_leaves(grads)):
            # a Python lr takes the parameter's dtype, as JAX's weak-typed
            # scalar does; a tensor lr is fp32, and the step is cast back to
            # the parameter's dtype (JAX would promote a bf16 parameter)
            lr_w = (lr.to(w.device) if isinstance(lr, torch.Tensor)
                    else torch.tensor(lr, dtype=w.dtype, device=w.device))
            w.sub_((lr_w * g.to(w.dtype)).to(w.dtype))
        return params, state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32),
                        params)

    @torch.no_grad()
    def update(grads, state, params, lr):
        for w, m, g in zip(tree_leaves(params), tree_leaves(state),
                           tree_leaves(grads)):
            m.mul_(beta).add_(g.to(torch.float32))
            w.sub_((_lr(lr, w.device) * m).to(w.dtype))
        return params, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {
            "m": tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                                device=w.device), params),
            "v": tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                                device=w.device), params),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        state["t"].add_(1)
        t = state["t"].to(torch.float32)
        bc1 = 1 - torch.pow(torch.as_tensor(b1, dtype=torch.float32,
                                            device=t.device), t)
        bc2 = 1 - torch.pow(torch.as_tensor(b2, dtype=torch.float32,
                                            device=t.device), t)
        for w, m, v, g in zip(tree_leaves(params), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(grads)):
            g32 = g.to(torch.float32)
            # b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g^2, as JAX
            # orders them
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            step.add_(weight_decay * w.to(torch.float32))
            w.sub_((_lr(lr, w.device) * step).to(w.dtype))
        return params, state

    return Optimizer(init, update)


def get(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)
