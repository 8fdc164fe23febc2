"""The port's own MoE dispatch and attention multiplier, on the CPU.

* ``moe_impl="dropless"`` against ``"dense"`` (both exact top-k) in values
  and in ``torch.func.vmap(grad)`` gradients, at the smoke widths and at
  granite's own 32 experts top-8; under forced imbalance (one expert
  takes every token, several take none) every routing choice reaches its
  expert.  Tolerance rtol 1e-5 / atol 1e-6 of the largest entry: the same
  fp32 products summed in another order (the dense dispatch sums each
  token's experts in one einsum, the dropless one in a gather and a
  weighted sum of its K rows), a few ulps apart.
* The grouped GEMM's CPU path and its vmap rule against a loop over
  members and experts, with gradients; the loop and the op compute each
  row with the same ``@`` of the same operands, so values are equal up to
  the matrix library's blocking: rtol 1e-6.
* ``attn_scale`` against a hand computation of softmax(q·k · scale)·v on
  the ``jnp``, ``blocked`` and flash (CPU) routes and in decode, and 0
  giving head_dim ** -0.5 bit for bit.  Tolerance rtol 1e-5 / atol 1e-6:
  the routes sum the scores in their own orders (the blocked one online).
"""
import math

import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.grouped_gemm import ref as gg_ref
from repro_torch.models import attention, moe

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(a, b, rtol, atol):
    """Elementwise within rtol, and atol of the larger tensor's largest
    entry."""
    scale = max(float(b.abs().max()), float(a.abs().max()), 1e-30)
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol * scale)


def _cfg(E=4, K=2, d=64, f=32):
    return get_config("granite-moe-1b-a400m", smoke=True).replace(
        n_experts=E, experts_per_tok=K, d_model=d, d_ff=f)


def _stack(cfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    ps = [moe.init_moe(g, cfg, torch.float32) for _ in range(n)]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


def _member_grads(cfg, P, x, impl):
    c = cfg.replace(moe_impl=impl)

    def loss(p, x):
        y, aux = moe.apply_moe(p, c, x)
        return (y ** 2).sum() + aux
    return vmap(grad_and_value(loss, argnums=(0, 1)))(P, x)


# --------------------------------------------------------------- dropless
@pytest.mark.parametrize("E,K,d,f", [(4, 2, 64, 32), (4, 2, 256, 128),
                                     (32, 8, 64, 32), (32, 8, 128, 16)],
                         ids=["smoke-narrow", "smoke", "granite-32x8",
                              "granite-32x8-wide"])
def test_dropless_equals_dense(E, K, d, f):
    cfg = _cfg(E, K, d, f)
    P = _stack(cfg, 3, seed=E + d)
    x = torch.randn(3, 2, 16, d, generator=torch.Generator().manual_seed(5))
    for m in range(3):
        p = {k: v[m] for k, v in P.items()}
        yd, ad = moe.apply_moe(p, cfg.replace(moe_impl="dense"), x[m])
        yl, al = moe.apply_moe(p, cfg.replace(moe_impl="dropless"), x[m])
        _close(yl, yd, **TOL)
        _close(al, ad, **TOL)
    (gd, ld), (gl, ll) = (_member_grads(cfg, P, x, i)
                          for i in ("dense", "dropless"))
    _close(ll, ld, **TOL)
    for k in gd[0]:
        _close(gl[0][k], gd[0][k], **TOL)
    _close(gl[1], gd[1], **TOL)


def _rows_seen(monkeypatch):
    """Each grouped product's per-group row counts, from its offsets."""
    seen = []
    orig = gg_ref.grouped_rows

    def spy(x, w, offsets, trans=False):
        seen.append(torch.diff(offsets).tolist())
        return orig(x, w, offsets, trans)
    monkeypatch.setattr(gg_ref, "grouped_rows", spy)
    return seen


def test_forced_imbalance_drops_nothing(monkeypatch):
    """A router that sends every token to expert 0 and none to experts
    20-31: each product still gets every one of the N·K choices, expert 0
    N rows, the shunned experts none, and the output is the dense
    dispatch's."""
    E, K, d = 32, 8, 64
    cfg = _cfg(E, K, d, 32)
    p = {k: v[0] for k, v in _stack(cfg, 1, seed=3).items()}
    x = torch.randn(2, 24, d, generator=torch.Generator().manual_seed(4))
    x[..., 0] = 1.0              # a constant feature the router reads
    r = p["router"].clone()
    r[0, 0] = 100.0              # every token's favourite
    r[0, 20:] = -100.0           # nobody's
    p["router"] = r
    _, _, top_i = moe._route(p, cfg, x)
    assert (top_i[..., 0] == 0).all() and (top_i < 20).all()
    seen = _rows_seen(monkeypatch)
    reg = obs.make_observability(trace=True)
    with obs.observing(reg):
        yl, al = moe.apply_moe(p, cfg.replace(moe_impl="dropless"), x)
    yd, ad = moe.apply_moe(p, cfg.replace(moe_impl="dense"), x)
    _close(yl, yd, **TOL)
    _close(al, ad, **TOL)
    N = x.shape[0] * x.shape[1]
    assert len(seen) == 3
    for counts in seen:
        assert sum(counts) == N * K and counts[0] == N
        assert counts[20:] == [0] * 12
    assert reg.registry.counter("moe/routed_rows").value == N * K


def test_all_choices_on_eight_experts_under_vmap(monkeypatch):
    """Every member's tokens all routed to the same 8 of 32 experts (24
    groups empty per member) under vmap(grad): the gradients are the dense
    dispatch's."""
    E, K, d = 32, 8, 64
    cfg = _cfg(E, K, d, 16)
    P = _stack(cfg, 2, seed=9)
    x = torch.randn(2, 1, 20, d, generator=torch.Generator().manual_seed(8))
    x[..., 0] = 1.0
    P["router"][:, 0, 8:16] += 6.0     # far above every other logit
    seen = _rows_seen(monkeypatch)
    (gd, ld), (gl, ll) = (_member_grads(cfg, P, x, i)
                          for i in ("dense", "dropless"))
    _close(ll, ld, **TOL)
    for k in gd[0]:
        _close(gl[0][k], gd[0][k], **TOL)
    _close(gl[1], gd[1], **TOL)
    fwd = seen[0]                        # the first product, both members
    assert len(fwd) == 2 * E and sum(fwd) == 2 * 20 * K
    assert all(c == 20 for m in range(2) for c in fwd[m * E + 8:m * E + 16])


def test_apply_moe_raises_on_unknown_impl():
    cfg = _cfg()
    p = {k: v[0] for k, v in _stack(cfg, 1, seed=1).items()}
    with pytest.raises(ValueError, match="'gshard'"):
        moe.apply_moe(p, cfg.replace(moe_impl="gshard"), torch.zeros(1, 4, 64))


def test_dropless_raises_under_a_tp_split():
    """Experts split on d_ff (this rank's half): no dropless dispatch."""
    cfg = _cfg()
    p = {k: v[0] for k, v in _stack(cfg, 1, seed=1).items()}
    p = dict(p, w_gate=p["w_gate"][..., :16], w_up=p["w_up"][..., :16],
             w_down=p["w_down"][:, :16])
    with pytest.raises(NotImplementedError, match="dropless"):
        moe.apply_moe(p, cfg.replace(moe_impl="dropless"),
                      torch.zeros(1, 4, 64))


# ------------------------------------------------------- the grouped GEMM
def _offsets(counts):
    c = torch.tensor(counts, dtype=torch.int64)
    return torch.cat([c.new_zeros(1), c.cumsum(0)])


def _loop(x, w, counts, trans=False):
    """Each group's rows times its own matrix, one ``@`` a group."""
    out, a = [], 0
    for g, n in enumerate(counts):
        wg = w[g % w.shape[0]]
        out.append(x[a:a + n] @ (wg.T if trans else wg))
        a += n
    return torch.cat(out)


@pytest.mark.parametrize("trans", [False, True])
def test_grouped_op_against_a_loop(trans):
    g = torch.Generator().manual_seed(0)
    counts = [5, 0, 11, 1, 0, 7]
    M, K, N = sum(counts), 12, 9
    x = torch.randn(M, K, generator=g)
    w = torch.randn(6, N, K, generator=g) if trans else \
        torch.randn(6, K, N, generator=g)
    off = _offsets(counts)
    _close(gg_ops.grouped_rows(x, w, off, trans), _loop(x, w, counts, trans),
           rtol=1e-6, atol=1e-7)
    # groups sharing matrices: group g reads w[g % 3]
    _close(gg_ops.grouped_rows(x, w[:3], off, trans),
           _loop(x, w[:3], counts, trans), rtol=1e-6, atol=1e-7)
    d = torch.randn(M, N, generator=g)
    dw = gg_ops.grouped_wgrad(x, d, off)
    a = 0
    for e, n in enumerate(counts):
        want = x[a:a + n].T @ d[a:a + n] if n else torch.zeros(K, N)
        _close(dw[e], want, rtol=1e-6, atol=1e-7)
        a += n


@pytest.mark.parametrize("shared_w", [False, True])
def test_grouped_op_vmap_rule_and_gradients(shared_w):
    """Three members, each with its own offsets (empty groups included):
    ``vmap(grad)`` of the grouped product equals a loop over members and
    experts with autograd, for x and w.  With ``shared_w`` the weights are
    not vmapped: every member's group e reads w[e], and dw sums the
    members'."""
    g = torch.Generator().manual_seed(1)
    E, K, N = 4, 6, 5
    counts = [[3, 0, 4, 1], [0, 0, 8, 0], [2, 2, 2, 2]]
    M = 8
    x = torch.randn(3, M, K, generator=g)
    w = torch.randn(E, K, N, generator=g) if shared_w else \
        torch.randn(3, E, K, N, generator=g)
    t = torch.randn(3, M, N, generator=g)
    off = torch.stack([_offsets(c) for c in counts])

    def loss(x, w, off, t):
        return (gg_ops.grouped_mm(x, w, off) * t).sum()

    w_dim = None if shared_w else 0
    gx, gw = vmap(grad(loss, argnums=(0, 1)),
                  in_dims=(0, w_dim, 0, 0))(x, w, off, t)
    for m in range(3):
        xm = x[m].clone().requires_grad_(True)
        wm = (w if shared_w else w[m]).clone().requires_grad_(True)
        (_loop(xm, wm, counts[m]) * t[m]).sum().backward()
        _close(gx[m], xm.grad, rtol=1e-6, atol=1e-7)
        _close(gw[m], wm.grad, rtol=1e-6, atol=1e-7)


def test_grouped_op_counts_rows_and_opens_its_backward_span():
    """Under a current observability the routed product counts its rows and
    the backward opens ``moe_bwd``; the CPU path launches nothing, so it
    counts no launch.  ``NULL_OBS`` is current outside ``observing``."""
    x = torch.randn(6, 4)
    w = torch.randn(2, 4, 3, requires_grad=True)
    off = _offsets([2, 4])
    bundle = obs.make_observability(trace=True)
    with obs.observing(bundle):
        assert obs.current() is bundle
        y = gg_ops.grouped_mm(x.requires_grad_(True), w, off, routed=True)
        y.sum().backward()
    assert obs.current() is obs.NULL_OBS
    reg = bundle.registry
    assert reg.counter("moe/routed_rows").value == 6
    assert reg.counter("moe/grouped_gemm_launches").value == 0
    assert [e["name"] for e in bundle.tracer.events()] == ["moe_bwd"]


def test_grouped_op_refuses_inputs_off_one_card():
    off = _offsets([1])
    with pytest.raises(ValueError, match="CUDA"):
        gg_ops.grouped_rows(torch.zeros(1, 2), torch.zeros(1, 2, 2,
                                                          device="meta"), off)


# ------------------------------------------------------------ attn_scale
def _hand(q, k, v, scale):
    """softmax(q·k · scale, causal)·v with K/V heads shared by groups."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhst,bthd->bshd", p, v)


def _qkv(seed=0, B=2, S=16, H=4, KV=2, hd=32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=g) for n in (H, KV, KV)]


@pytest.mark.parametrize("impl", ["jnp", "blocked", "pallas"])
def test_attn_scale_against_a_hand_computation(impl):
    q, k, v = _qkv()
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        n_heads=4, n_kv_heads=2, head_dim=32, attn_impl=impl,
        attn_scale=0.015625)
    got = attention._attend(cfg, q, k, v, window=0, causal=True)
    _close(got, _hand(q, k, v, 0.015625), **TOL)
    assert not torch.allclose(got, _hand(q, k, v, 32 ** -0.5), atol=1e-3)
    # the gradients too (the flash op's plain backward takes the scale)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention._attend(cfg, *leaves, window=0, causal=True).square().sum() \
        .backward()
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _hand(*want, 0.015625).square().sum().backward()
    for a, b in zip(leaves, want):
        _close(a.grad, b.grad, **TOL)


@pytest.mark.parametrize("impl", ["jnp", "blocked", "pallas"])
def test_attn_scale_zero_is_head_dim_bit_for_bit(impl):
    q, k, v = _qkv(seed=3)
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        n_heads=4, n_kv_heads=2, head_dim=32, attn_impl=impl)
    assert cfg.attn_scale == 0.0 and cfg.softmax_scale == 32 ** -0.5
    zero = attention._attend(cfg, q, k, v, window=0, causal=True)
    given = attention._attend(cfg.replace(attn_scale=32 ** -0.5), q, k, v,
                              window=0, causal=True)
    assert torch.equal(zero, given)
    _close(zero, _hand(q, k, v, 1 / math.sqrt(32)), **TOL)


def test_attn_scale_in_decode():
    """Token-by-token decode against the cache equals the sequence forward
    at a set ``attn_scale`` (and both differ from head_dim ** -0.5)."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        attn_scale=0.015625)
    g = torch.Generator().manual_seed(2)
    p = attention.init_attn(g, cfg, torch.float32)
    B, S = 2, 8
    x = torch.randn(B, S, cfg.d_model, generator=g)
    pos = torch.arange(S)[None].expand(B, S)
    full = attention.attn_forward(p, cfg, x, pos)
    cache = attention.init_attn_cache(cfg, B, S, torch.float32)
    steps = []
    for i in range(S):
        out, cache = attention.attn_decode(p, cfg, cache, x[:, i:i + 1], i)
        steps.append(out)
    _close(torch.cat(steps, 1), full, **TOL)
    plain = attention.attn_forward(p, cfg.replace(attn_scale=0.0), x, pos)
    assert not torch.allclose(plain, full, atol=1e-4)
