"""A sparse-expert decoder-only LM as Granite 3.0 MoE builds it
(hf:ibm-granite/granite-3.0-1b-a400m-base), plain PyTorch, fp32: token
embedding times the embedding multiplier; per layer an RMSNorm, causal
grouped-query attention with rotary positions and the scores times the
attention multiplier, added to the residual times the residual
multiplier; an RMSNorm, the router's softmax over the experts, the top
experts_per_tok (ties to the lower expert), their probabilities
renormalised to sum to one, and each expert's SwiGLU MLP computed on
exactly the tokens routed to it (``index_select``, then ``index_add`` of
its output times the token's weight), added to the residual times the
residual multiplier; a final RMSNorm and the tied embedding as head, the
logits divided by the logits scaling (times ``logit_scale``).  Each
layer's matrices are stacked over the layers (``blocks/p0/...``), as the
FL engine lays them out.  Level l halves d_ff and the expert count per
level (``bench.counts.lm_d_ff``, ``bench.kinds.moe.n_experts``).

Departures from the published model: fp32 (published bf16); 4 of its 24
layers (the configuration's ``n_layers``); the loss of a member trained
without a teacher adds the FL family's load-balancing term,
router_aux_coef * E * sum over experts of (the share of routing choices
it took / experts_per_tok) * (its mean router probability), summed over
the layers, as does the evaluation; a KD member's loss has none.

Supported: the keys of ``configs/granite-moe-1b-a400m.l4.json``;
``check`` refuses a configuration that asks for anything else."""
from __future__ import annotations

import torch

from bench.counts import lm_d_ff
from bench.kinds.moe import n_experts
from bench.reference import losses
from bench.reference.lm import _rope, padded_vocab

RMS_EPS = 1e-6
# the values this reference implements; the other keys it reads
FIXED = {"norm_type": "rmsnorm", "tie_embeddings": True, "dtype": "float32",
         "moe_impl": "dropless"}
READ = {"n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab_size", "n_experts", "experts_per_tok", "rope_theta",
        "router_aux_coef", "embed_scale", "residual_scale", "logit_scale",
        "attn_scale", "alpha"}
# what the program alone reads (its kernels), and the file's notes
OTHER = {"kind", "reference", "source", "about", "arch", "attn_impl",
         "published", "reduced", "assumed"}


def check(cfg):
    """Refuses a configuration with a key this reference does not cover,
    or a covered key at a value it does not implement."""
    unknown = set(cfg) - set(FIXED) - READ - OTHER
    bad = {k: cfg.get(k) for k, v in FIXED.items() if cfg.get(k) != v}
    if unknown or bad or cfg["n_heads"] % cfg["n_kv_heads"] \
            or cfg["attn_scale"] <= 0:
        raise ValueError(f"the plain MoE reference covers Granite's block "
                         f"in fp32 with dropless routing and a set "
                         f"attention multiplier only; not the keys "
                         f"{sorted(unknown)}, nor {bad}")


def init(cfg, level, seed):
    """Draw order of the FL family from a CPU generator seeded with
    seed + level: the embedding (normal * 0.02), then per layer wq, wk,
    wv, wo (normal * d_in**-0.5), the router (normal * 0.02), w_gate,
    w_up (normal * d**-0.5) and w_down (normal * f**-0.5), each expert's
    matrix stacked; the RMSNorm scales are ones and draw nothing."""
    check(cfg)
    g = torch.Generator().manual_seed(seed + level)
    d = cfg["d_model"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    E, f = n_experts(cfg, level), lm_d_ff(cfg, level)

    def normal(shape, scale):
        return torch.randn(shape, generator=g) * scale

    out = {"embed": normal((padded_vocab(cfg), d), 0.02)}
    layers = []
    for _ in range(cfg["n_layers"]):
        layers.append({
            "norm1/scale": torch.ones(d),
            "mixer/wq": normal((d, q), d ** -0.5),
            "mixer/wk": normal((d, kv), d ** -0.5),
            "mixer/wv": normal((d, kv), d ** -0.5),
            "mixer/wo": normal((q, d), q ** -0.5),
            "norm2/scale": torch.ones(d),
            "ffn/router": normal((d, E), 0.02),
            "ffn/w_gate": normal((E, d, f), d ** -0.5),
            "ffn/w_up": normal((E, d, f), d ** -0.5),
            "ffn/w_down": normal((E, f, d), f ** -0.5)})
    for k in layers[0]:
        out[f"blocks/p0/{k}"] = torch.stack([l[k] for l in layers])
    out["final_norm/scale"] = torch.ones(d)
    return out


def sizes(cfg, level):
    """Procedure 2's (model bytes, FLOPs per sample): fp32 parameters
    without the norms' scales, as the FL family counts them, and 6 per
    parameter."""
    d = cfg["d_model"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    E, f = n_experts(cfg, level), lm_d_ff(cfg, level)
    n = padded_vocab(cfg) * d + cfg["n_layers"] * (
        2 * d * q + 2 * d * kv + d * E + 3 * E * d * f)
    return n * 4.0, 6.0 * n


def _rms(x, scale):
    return x * torch.rsqrt(torch.square(x).mean(-1, keepdim=True)
                           + RMS_EPS) * scale


def route(cfg, x, router, num):
    """x (N, d) -> (probabilities (N, E), top weights (N, K), top experts
    (N, K)): softmax over every expert, the K largest, ties to the lower
    expert, renormalised."""
    probs = torch.softmax(num.mm(x, router), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg["experts_per_tok"]
    top_w, top_i = vals[:, :K], idx[:, :K]
    return probs, top_w / top_w.sum(-1, keepdim=True), top_i


def experts(cfg, x, w, num):
    """The routed experts' output (N, d) of x (N, d) and the layer's
    load-balancing term: each expert's SwiGLU on its own tokens only."""
    probs, top_w, top_i = route(cfg, x, w("ffn/router"), num)
    E = probs.shape[-1]
    y = torch.zeros_like(x)
    wg, wu, wd = w("ffn/w_gate"), w("ffn/w_up"), w("ffn/w_down")
    for e in range(E):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if len(tok) == 0:
            continue
        xe = x.index_select(0, tok)
        h = torch.nn.functional.silu(num.mm(xe, wg[e])) * num.mm(xe, wu[e])
        y = y.index_add(0, tok, num.mm(h, wd[e]) * top_w[tok, slot, None])
    frac = torch.zeros(E, device=x.device).index_add(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=x.device)) \
        / x.shape[0]
    aux = E * torch.sum(frac / cfg["experts_per_tok"] * probs.mean(0))
    return y, aux


def hidden(cfg, p, tokens, num):
    """The final norm's output (B, S, d) and the load-balancing term summed
    over the layers."""
    B, S = tokens.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    r = cfg["residual_scale"]
    h = p["embed"][tokens] * cfg["embed_scale"]
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    aux = torch.zeros((), device=h.device)
    for l in range(cfg["n_layers"]):
        def w(name):
            return p[f"blocks/p0/{name}"][l]
        x = _rms(h, w("norm1/scale"))
        q = _rope(num.mm(x, w("mixer/wq")).view(B, S, H, hd),
                  cfg["rope_theta"])
        k = _rope(num.mm(x, w("mixer/wk")).view(B, S, KV, hd),
                  cfg["rope_theta"])
        v = num.mm(x, w("mixer/wv")).view(B, S, KV, hd)
        k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
        s = num.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
            * cfg["attn_scale"]
        a = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        o = num.mm(a, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * hd)
        h = h + num.mm(o, w("mixer/wo")) * r
        y, a_l = experts(cfg, _rms(h, w("norm2/scale")).reshape(B * S, -1),
                         w, num)
        h = h + y.view(B, S, -1) * r
        aux = aux + a_l
    return _rms(h, p["final_norm/scale"]), aux


def logits_at(cfg, p, tokens, positions, num):
    """Logits (B, len(positions), V_pad) at the given positions (a slice),
    and the load-balancing term."""
    h, aux = hidden(cfg, p, tokens, num)
    return num.mm(h[:, positions], p["embed"].T) * cfg["logit_scale"], aux


def step_loss(cfg, level, p, batch, teacher, fl, num):
    """A member step's objective: next-token CE over every position plus
    the load-balancing term, or under KD the Hinton loss of the last
    position's logits against the teacher's, with the last token as the
    hard label."""
    tokens = batch["tokens"]
    if teacher is None:
        z, aux = logits_at(cfg, p, tokens, slice(0, -1), num)
        return losses.ce(z, tokens[:, 1:]).mean() + cfg["router_aux_coef"] * aux
    z, _ = logits_at(cfg, p, tokens, -1, num)
    return losses.kd(z, tokens[:, -1], teacher, fl["kd_T"], fl["kd_alpha"])


def teacher_logits(cfg, p0, batch, num):
    with torch.no_grad():
        return logits_at(cfg, p0, batch["tokens"], -1, num)[0]


def evaluate(cfg, level, p, test, num):
    """Minus the evaluation loss the program reports: the mean next-token
    CE over all the test windows plus the load-balancing term of their one
    forward (the term is of the whole batch, so it is not split)."""
    tokens = test["tokens"]
    with torch.no_grad():
        z, aux = logits_at(cfg, p, tokens, slice(0, -1), num)
        ce = losses.ce(z, tokens[:, 1:]).double().mean()
    return -float(ce + cfg["router_aux_coef"] * aux.double())
