"""Baselines re-implemented for fair comparison (§V-B):

  * FedAvg  [McMahan et al., AISTATS'17] — single global model sized for the
    weakest participant (the paper runs the smallest slave model on all 40).
  * FedProx [Li et al., MLSys'20] — FedAvg + proximal term μ/2·||w - w_g||².
  * Oort    [Lai et al., OSDI'21] — guided participant selection by
    statistical utility × system-speed penalty.
  * HeteroFL[Diao et al., ICLR'21] — width-sliced submodels per client
    capacity; server aggregates overlapping slices.

Each round trains the chosen participants one after another
(``core.client.local_update`` on host-sampled batches, seed + 977 pid +
round as in the JAX package), then averages them by a pytree FedAvg.  Every
tensor lives on the device of the initial parameters (HeteroFL: on
``device``), and ``test`` is moved there.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import aggregation, cost_model
from repro_torch.core.client import local_update
from repro_torch.core.server import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.data.sampler import sample_batches
from repro_torch.models import cnn


@dataclass
class BaselineConfig:
    rounds: int = 20
    lr: float = 0.05
    local_batch: int = 16
    steps_per_round: int = 4
    seed: int = 0
    prox_mu: float = 0.001       # FedProx
    oort_frac: float = 0.5       # fraction of clients per round
    oort_alpha: float = 2.0      # system-utility exponent
    alpha: float = 0.5           # HeteroFL width ratio per level


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _eval(loss_fn, params, test):
    with torch.no_grad():
        _, logits = loss_fn(params, test)
    return float(torch.mean((torch.argmax(logits, -1) == test["y"])
                            .to(torch.float32)))


def _batches(cfg: BaselineConfig, d: dict, pid: int, r: int, device):
    return _on(sample_batches(d["x"], d["y"], cfg.local_batch,
                              cfg.steps_per_round,
                              seed=cfg.seed + 977 * pid + r), device)


def _run_rounds(loss_fn, params, parts, client_data, test, cfg: BaselineConfig,
                *, prox_mu: float = 0.0, select=None):
    device = tree_leaves(params)[0].device
    test = _on(test, device)
    history = []
    losses = {p.pid: 1.0 for p in parts}
    for r in range(cfg.rounds):
        chosen = select(parts, losses, r) if select else parts
        stack, ws = [], []
        for p in chosen:
            d = client_data[p.pid]
            p_new, loss = local_update(loss_fn, params,
                                       _batches(cfg, d, p.pid, r, device),
                                       cfg.lr, prox_mu=prox_mu,
                                       global_params=params)
            losses[p.pid] = float(loss)
            stack.append(p_new)
            ws.append(len(d["x"]))
        stacked = tree_map(lambda *xs: torch.stack(xs), *stack)
        params = aggregation.aggregate(stacked,
                                       aggregation.normalized_weights(ws))
        history.append(_eval(loss_fn, params, test))
    return params, history


def fedavg(loss_fn, init_params, parts, client_data, test,
           cfg: BaselineConfig):
    return _run_rounds(loss_fn, init_params, parts, client_data, test, cfg)


def fedprox(loss_fn, init_params, parts, client_data, test,
            cfg: BaselineConfig):
    return _run_rounds(loss_fn, init_params, parts, client_data, test, cfg,
                       prox_mu=cfg.prox_mu)


def oort(loss_fn, init_params, parts, client_data, test, cfg: BaselineConfig,
         flops_per_sample: float, model_bytes: float, mar: float = 60.0):
    k = max(1, int(len(parts) * cfg.oort_frac))

    def select(ps, losses, r):
        utils = []
        for p in ps:
            stat = len(client_data[p.pid]["x"]) ** 0.5 * (losses[p.pid] + 1e-3)
            t = cost_model.round_time(p, flops_per_sample, model_bytes, 1,
                                      cfg.local_batch * cfg.steps_per_round)
            sys_u = 1.0 if t <= mar else (mar / t) ** cfg.oort_alpha
            utils.append(stat * sys_u)
        order = np.argsort(-np.asarray(utils))
        # ε-greedy exploration as in Oort
        rng = np.random.default_rng(cfg.seed + r)
        n_exploit = max(1, int(0.8 * k))
        chosen = list(order[:n_exploit])
        rest = list(order[n_exploit:])
        if rest and k - n_exploit > 0:
            chosen += list(rng.choice(rest, min(k - n_exploit, len(rest)),
                                      replace=False))
        return [ps[i] for i in chosen]

    return _run_rounds(loss_fn, init_params, parts, client_data, test, cfg,
                       select=select)


# ------------------------------------------------------------------ HeteroFL
def _slice_like(full, small):
    """Take the leading-corner slice of ``full`` matching ``small``'s shape."""
    return full[tuple(slice(0, s) for s in small.shape)]


def _cnn_template(*, in_channels: int, classes: int, alpha: float,
                  level: int, base_width: float) -> dict:
    """``cnn.init_params``'s tree at these widths as storage-free ``meta``
    tensors: the HeteroFL sub-models need only its shapes, no draw."""
    def leaf(*shape):
        return torch.empty(shape, device="meta")

    tmpl = {"convs": []}
    cin = in_channels
    for f in cnn.filters(alpha, level, base_width):
        tmpl["convs"].append({"w": leaf(3, 3, cin, f), "b": leaf(f)})
        cin = f
    tmpl["dense"] = {"w": leaf(cin, classes), "b": leaf(classes)}
    return tmpl


def heterofl(parts, client_data, client_levels, test, cfg: BaselineConfig,
             *, in_channels: int, classes: int, levels: int,
             base_width: float = 0.125, init_params=None, device=None):
    """CNN-family HeteroFL: a client at level ℓ trains the α^ℓ-width slice.

    The global model is ``init_params`` when given (moved to ``device``),
    else a full-width ``cnn.init_params`` drawn from
    ``torch.Generator().manual_seed(cfg.seed)``.  Each round accumulates
    the trained slices in fp32 in participant order and divides by the
    per-element count in float64, as the JAX package does on the host."""
    device = resolve_device(device)
    if init_params is None:
        init_params = cnn.init_params(
            torch.Generator().manual_seed(cfg.seed), in_channels=in_channels,
            classes=classes, alpha=1.0, level=0, base_width=base_width)
    global_params = tree_map(lambda x: x.to(device), init_params)
    sub_templates = [_cnn_template(in_channels=in_channels, classes=classes,
                                   alpha=cfg.alpha, level=l,
                                   base_width=base_width)
                     for l in range(levels)]

    def loss_fn(p, b):
        logits = cnn.forward(p, b["x"])
        return cnn.logits_loss(logits, b["y"])[0], logits

    test = _on(test, device)
    history = []
    for r in range(cfg.rounds):
        acc = [torch.zeros_like(g) for g in tree_leaves(global_params)]
        cnt = [torch.zeros(g.shape, dtype=torch.float64, device=device)
               for g in tree_leaves(global_params)]
        for p in parts:
            lvl = client_levels[p.pid]
            sub = tree_map(_slice_like, global_params, sub_templates[lvl])
            d = client_data[p.pid]
            sub_new, _ = local_update(loss_fn, sub,
                                      _batches(cfg, d, p.pid, r, device),
                                      cfg.lr)
            for i, leaf in enumerate(tree_leaves(sub_new)):
                sl = tuple(slice(0, s) for s in leaf.shape)
                acc[i][sl] += leaf
                cnt[i][sl] += 1
        new_leaves = [
            torch.where(c > 0, a.double() / torch.clamp(c, min=1),
                        g.double()).to(g.dtype)
            for g, a, c in zip(tree_leaves(global_params), acc, cnt)]
        global_params = tree_unflatten(global_params, new_leaves)
        history.append(_eval(loss_fn, global_params, test))
    return global_params, history

