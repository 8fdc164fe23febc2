"""Mixture-of-Experts FFN: top-k router and three dispatch strategies, a
torch copy of ``repro.models.moe`` with one of its own.

* ``dense``: every expert runs on every token, outputs masked by the
  combine matrix.  Exact top-k semantics (no token dropping).
* ``capacity``: GShard / Switch grouped dispatch with per-expert capacity
  C = max(4, ceil(gs*K*capacity_factor / E)).  Token order within a group
  decides dropping, as in GShard; ``moe_chunk_groups`` runs the groups in
  chunks so that only one chunk's dispatch tensors are live.
* ``dropless`` (the port's own): every routing choice reaches its expert
  and only the routed work is done.  The N·K choices are sorted by expert
  (a stable sort, so token order within an expert), the per-expert counts
  give the group offsets on the device, and the experts' three products
  run as grouped GEMMs (``kernels/grouped_gemm``) over the rows each
  expert holds; the combine undoes the sort and weights each choice by
  its gate.  Exact top-k semantics whatever the imbalance.  One chip:
  under a tensor-parallel split it raises.

``apply_moe`` opens the span ``moe`` of the current observability
(``obs.current``) around the layer, and raises on an unknown
``moe_impl``.

The router's top-k breaks ties as ``jax.lax.top_k`` does, lower expert
index first (a stable descending sort: ``torch.topk`` promises no order,
and bf16 router probabilities tie often).  One-hots compare against
``arange`` so the code runs under ``torch.func.vmap``.  The capacity
dispatch tensor is built as (G, gs, E, cap) directly, by contracting the
expert and slot one-hots over the K routing choices, never as JAX's
(G, gs*K, E, cap) intermediate: a token takes an expert once at most, so
each entry is one 0/1 product and the values are JAX's exactly.

Under a tensor-parallel context (``models.tp``) the expert leaves are this
rank's slices as ``launch.sharding.tp_specs`` splits them (``expert_split``):
each expert's slice of ``d_ff`` (``moe_shard="tp"``: column-parallel
``w_gate`` / ``w_up``, row-parallel ``w_down``), or E/m whole experts
(``"ep"``, where E divides; else the ``d_ff`` split).  The router is a whole
leaf and routes on the replicated input, so every rank makes the same
choices, queue positions and capacity drops as one device, and the aux
loss stays replicated.  The experts run rank-partial: the input and the
routing weights enter by ``copy_to_tp``, an expert-parallel rank takes
its experts' columns of the combine (dense) or dispatch / combine
(capacity) tensors, and one ``reduce_from_tp`` after the combine sums the
ranks' shares: one all-reduce per MoE layer, the combine being linear.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.models import tp
from repro_torch.models.layers import dense_init, normal


def init_moe(generator, cfg: ModelConfig, dtype):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(generator, d, E, dtype, scale=0.02),
        "w_gate": normal(generator, (E, d, f), d ** -0.5, dtype),
        "w_up": normal(generator, (E, d, f), d ** -0.5, dtype),
        "w_down": normal(generator, (E, f, d), f ** -0.5, dtype),
    }


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    return idx[..., None] == torch.arange(n, device=idx.device)


def _route(p, cfg: ModelConfig, x):
    logits = (x @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, cfg.experts_per_tok)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return probs, top_w, top_i


def _aux_loss(cfg: ModelConfig, probs, top_i):
    E = cfg.n_experts
    routed = _one_hot(top_i, E).to(torch.float32).sum(dim=-2)
    frac = routed.reshape(-1, E).mean(dim=0)                       # (E,)
    prob_mean = probs.reshape(-1, E).mean(dim=0)
    return E * torch.sum(frac / cfg.experts_per_tok * prob_mean)


def _expert_weights(top_w, top_i, E: int):
    """(..., E): each token's normalised weight on every expert, 0 where
    it did not route."""
    return (top_w[..., None] * _one_hot(top_i, E).to(torch.float32)
            ).sum(dim=-2)


def expert_split(p, cfg: ModelConfig):
    """How this rank holds the expert leaves: "ep" (its E/m whole
    experts), "f" (every expert's slice of ``d_ff``) or None (whole)."""
    E, _, f = p["w_gate"].shape[-3:]
    if E != cfg.n_experts:
        return "ep"
    return "f" if f != cfg.d_ff else None


def _rank_experts(split, t, dim: int):
    """This rank's experts' entries of ``t``'s expert ``dim`` under
    expert parallelism; ``t`` otherwise."""
    return tp.own(t, dim) if split == "ep" else t


def _apply_dense(p, cfg: ModelConfig, x, split):
    probs, top_w, top_i = _route(p, cfg, x)
    if split:
        x, top_w = tp.copy_to_tp(x), tp.copy_to_tp(top_w)
    combine = _rank_experts(split, _expert_weights(
        top_w, top_i, cfg.n_experts).to(x.dtype), -1)
    g = torch.einsum("bsd,edf->besf", x, p["w_gate"])
    u = torch.einsum("bsd,edf->besf", x, p["w_up"])
    h = F.silu(g) * u
    y = torch.einsum("besf,efd->besd", h, p["w_down"])
    y = torch.einsum("besd,bse->bsd", y, combine)
    return y, _aux_loss(cfg, probs, top_i)


def capacity(cfg: ModelConfig, gs: int) -> int:
    """Slots per expert in a group of ``gs`` tokens (JAX's expression)."""
    return max(4, int(-(-gs * cfg.experts_per_tok * cfg.moe_capacity
                        // cfg.n_experts)))


def _apply_capacity(p, cfg: ModelConfig, x, split):
    B, S, d = x.shape
    N = B * S
    gs = min(cfg.moe_group, N)
    if N % gs:
        raise ValueError(f"MoE capacity dispatch: {N} tokens are not a "
                         f"multiple of the group size {gs}")
    G = N // gs
    xt = x.reshape(G, gs, d)
    cap = capacity(cfg, gs)
    cg = cfg.moe_chunk_groups
    if cg and G > cg and G % cg == 0:
        # one chunk of groups at a time: only its dispatch tensors are live
        ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(G // cg):
            y, a = _capacity_groups(p, cfg, xt[c * cg:(c + 1) * cg], cap,
                                    split)
            ys.append(y)
            aux = aux + a
        return torch.cat(ys).reshape(B, S, d), aux / (G // cg)
    y, aux = _capacity_groups(p, cfg, xt, cap, split)
    return y.reshape(B, S, d), aux


def queue_positions(top_i, n_experts: int):
    """top_i: (G, gs, K) routing choices -> (G, gs*K): each choice's
    token-major queue position in its expert; the ones at ``cap`` or
    beyond are dropped."""
    G = top_i.shape[0]
    flat = _one_hot(top_i, n_experts).reshape(G, -1, n_experts).to(
        torch.int64)
    return ((torch.cumsum(flat, dim=1) - flat) * flat).sum(dim=-1)


def kept_choices(p, cfg: ModelConfig, x):
    """(kept, made): the routing choices the capacity dispatch of x
    (B, S, d) keeps, and all it makes."""
    B, S, d = x.shape
    gs = min(cfg.moe_group, B * S)
    _, _, top_i = _route(p, cfg, x.reshape(-1, gs, d))
    pos = queue_positions(top_i, cfg.n_experts)
    return int((pos < capacity(cfg, gs)).sum()), pos.numel()


def _capacity_groups(p, cfg: ModelConfig, xt, cap: int, split):
    """xt: (G, gs, d) -> (y (G, gs, d), aux); y is this rank's share
    under a ``split``."""
    G, gs, d = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_tok
    probs, top_w, top_i = _route(p, cfg, xt)                  # (G,gs,E/K)
    if split:
        xt, top_w = tp.copy_to_tp(xt), tp.copy_to_tp(top_w)
    oh = _one_hot(top_i, E)                                   # (G,gs,K,E)
    pos = queue_positions(top_i, E)                           # (G,gs*K)
    slot = _one_hot(pos, cap) & (pos < cap)[..., None]        # (G,gsK,cap)
    disp = torch.einsum("gske,gskc->gsec", oh.to(torch.float32),
                        slot.reshape(G, gs, K, cap).to(torch.float32))
    comb = disp * _expert_weights(top_w, top_i, E)[..., None]
    disp_t, comb_t = (_rank_experts(split, t.to(xt.dtype), 2)
                      for t in (disp, comb))                  # (G,gs,E,cap)
    ein = torch.einsum("gsec,gsd->gecd", disp_t, xt)          # (G,E,cap,d)
    g = torch.einsum("gecd,edf->gecf", ein, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", ein, p["w_up"])
    h = F.silu(g) * u
    y_slots = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", comb_t, y_slots)
    return y, _aux_loss(cfg, probs, top_i)


def _apply_dropless(p, cfg: ModelConfig, x, split):
    """Every choice on its expert's rows (the module docstring)."""
    if split:
        raise NotImplementedError(
            "MoE dropless dispatch under a tensor-parallel split")
    B, S, d = x.shape
    N, E, K = B * S, cfg.n_experts, cfg.experts_per_tok
    probs, top_w, top_i = _route(p, cfg, x)
    choice = top_i.reshape(N * K)                     # token-major
    order = torch.sort(choice, stable=True).indices   # grouped by expert
    counts = _one_hot(choice, E).sum(dim=0)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    # each token's row once per choice, then in expert order: the expand's
    # backward sums a token's K gradients in order, where a repeated index
    # would add them atomically
    xs = x.reshape(N, 1, d).expand(N, K, d).reshape(N * K, d)[order]
    g = gg_ops.grouped_mm(xs, p["w_gate"], offsets, routed=True)
    u = gg_ops.grouped_mm(xs, p["w_up"], offsets)
    ys = gg_ops.grouped_mm(F.silu(g) * u, p["w_down"], offsets)
    y = ys[torch.argsort(order)].reshape(N, K, d)     # token-major again
    y = (y * top_w.reshape(N, K, 1).to(y.dtype)).sum(dim=1)
    return y.reshape(B, S, d), _aux_loss(cfg, probs, top_i)


_DISPATCH = {"dense": _apply_dense, "capacity": _apply_capacity,
             "dropless": _apply_dropless}


def apply_moe(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (y, load-balance aux loss)."""
    run = _DISPATCH.get(cfg.moe_impl)
    if run is None:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}: one of "
                         f"{sorted(_DISPATCH)}")
    split = expert_split(p, cfg)
    with obs.current().tracer.span("moe", cat="fl"):
        y, aux = run(p, cfg, x, split)
        return (tp.reduce_from_tp(y) if split else y), aux
