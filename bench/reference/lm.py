"""A dense decoder-only LM as OLMo-1B builds it, plain PyTorch, fp32:
token embedding, per layer a non-parametric LayerNorm, causal multi-head
attention with rotary positions, a non-parametric LayerNorm and a SwiGLU
MLP, each added to the residual; a final non-parametric LayerNorm and the
tied embedding as head.  Each layer's matrices are stacked over the
layers (``blocks/p0/...``), as the FL engine lays them out.  Level l
halves d_ff per level (``bench.counts.lm_d_ff``).

Supported: the keys of ``configs/olmo-1b.l2.json``; ``check`` refuses a
configuration that asks for anything else."""
from __future__ import annotations

import torch

from bench.counts import lm_d_ff
from bench.reference import losses

PAD_MULTIPLE = 256          # the vocabulary is padded to this multiple
LN_EPS = 1e-6


def check(cfg):
    if not (cfg["norm_type"] == "nonparam_ln" and cfg["tie_embeddings"]
            and cfg["n_heads"] == cfg["n_kv_heads"]
            and cfg["dtype"] == "float32"):
        raise ValueError("the plain LM reference covers OLMo's dense block "
                         "in fp32 only")


def padded_vocab(cfg):
    return -(-cfg["vocab_size"] // PAD_MULTIPLE) * PAD_MULTIPLE


def init(cfg, level, seed):
    """Draw order of the FL family: the embedding (normal * 0.02), then per
    layer wq, wk, wv, wo, w_gate, w_up, w_down, each normal * d_in**-0.5,
    from a CPU generator seeded with seed + level."""
    g = torch.Generator().manual_seed(seed + level)
    d, q = cfg["d_model"], cfg["n_heads"] * cfg["head_dim"]
    ff = lm_d_ff(cfg, level)

    def normal(shape, scale):
        return torch.randn(shape, generator=g) * scale

    out = {"embed": normal((padded_vocab(cfg), d), 0.02)}
    layers = []
    for _ in range(cfg["n_layers"]):
        layers.append({
            "mixer/wq": normal((d, q), d ** -0.5),
            "mixer/wk": normal((d, q), d ** -0.5),
            "mixer/wv": normal((d, q), d ** -0.5),
            "mixer/wo": normal((q, d), q ** -0.5),
            "ffn/w_gate": normal((d, ff), d ** -0.5),
            "ffn/w_up": normal((d, ff), d ** -0.5),
            "ffn/w_down": normal((ff, d), ff ** -0.5)})
    for k in layers[0]:
        out[f"blocks/p0/{k}"] = torch.stack([l[k] for l in layers])
    return out


def sizes(cfg, level):
    """Procedure 2's (model bytes, FLOPs per sample): fp32 parameters, and
    6 per parameter."""
    d, q = cfg["d_model"], cfg["n_heads"] * cfg["head_dim"]
    n = padded_vocab(cfg) * d + cfg["n_layers"] * (
        4 * d * q + 3 * d * lm_d_ff(cfg, level))
    return n * 4.0, 6.0 * n


def _ln(x):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS)


def _rope(x, theta):
    """x: (B, S, H, hd): the two halves rotated by position times
    theta**(-2i / hd)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def hidden(cfg, p, tokens, num):
    B, S = tokens.shape
    H, hd = cfg["n_heads"], cfg["head_dim"]
    h = p["embed"][tokens]
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    for l in range(cfg["n_layers"]):
        def w(name):
            return p[f"blocks/p0/{name}"][l]
        x = _ln(h)
        q = _rope(num.mm(x, w("mixer/wq")).view(B, S, H, hd),
                  cfg["rope_theta"])
        k = _rope(num.mm(x, w("mixer/wk")).view(B, S, H, hd),
                  cfg["rope_theta"])
        v = num.mm(x, w("mixer/wv")).view(B, S, H, hd)
        s = num.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd ** -0.5
        a = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        o = num.mm(a, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * hd)
        h = h + num.mm(o, w("mixer/wo"))
        x = _ln(h)
        g = torch.nn.functional.silu(num.mm(x, w("ffn/w_gate")))
        h = h + num.mm(g * num.mm(x, w("ffn/w_up")), w("ffn/w_down"))
    return _ln(h)


def logits_at(cfg, p, tokens, positions, num):
    """Logits (B, len(positions), V_pad) at the given positions (a slice)."""
    return num.mm(hidden(cfg, p, tokens, num)[:, positions], p["embed"].T)


def step_loss(cfg, level, p, batch, teacher, fl, num):
    """A member step's objective: next-token CE over every position, or
    under KD the Hinton loss of the last position's logits against the
    teacher's, with the last token as the hard label."""
    tokens = batch["tokens"]
    if teacher is None:
        z = logits_at(cfg, p, tokens, slice(0, -1), num)
        return losses.ce(z, tokens[:, 1:]).mean()
    z = logits_at(cfg, p, tokens, -1, num)
    return losses.kd(z, tokens[:, -1], teacher, fl["kd_T"], fl["kd_alpha"])


def teacher_logits(cfg, p0, batch, num):
    with torch.no_grad():
        return logits_at(cfg, p0, batch["tokens"], -1, num)


def evaluate(cfg, level, p, test, num, rows=8):
    """Minus the mean next-token CE over the test windows (in blocks of
    ``rows`` windows, to keep the logits small)."""
    tokens = test["tokens"]
    total, count = 0.0, 0
    with torch.no_grad():
        for i in range(0, len(tokens), rows):
            t = tokens[i:i + rows]
            z = logits_at(cfg, p, t, slice(0, -1), num)
            total += float(losses.ce(z, t[:, 1:]).double().sum())
            count += z.shape[0] * z.shape[1]
    return -total / count
