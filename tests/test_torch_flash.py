"""Port parity for the flash kernel module (``repro_torch.kernels.flash``).

On the CPU the wrapper runs the kernel's plain version, so these tests hold
the port's ``FlashAttention`` (layout transforms, GQA row map, autograd and
``vmap`` rules) to the JAX package's ``flash_attention``, which runs its
Pallas kernel in interpret mode here, as ``tests/test_kernels_flash.py``
runs it.  Inputs come from a numpy seed and feed both packages.

Tolerances are ``tests/test_kernels_flash.py``'s: atol 2e-5 / rtol 1e-4 in
fp32 forward, 3e-2 / 3e-2 in bf16, 1e-4 / 1e-4 on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.kernels.flash import ops as j_ops
from repro.kernels.flash import ref as j_ref
from repro_torch.kernels.flash import ops, ref

jax.config.update("jax_platform_name", "cpu")
FWD = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    out_j = j_ops.flash_attention(*(jnp.asarray(x).astype(jd)
                                    for x in (q, k, v)), block_q=64,
                                  block_k=64, **kw)
    out_t = ops.flash_attention(*(torch.tensor(x).to(td) for x in (q, k, v)),
                                **kw)
    assert out_t.dtype == td
    return (np.asarray(out_j.astype(jnp.float32)),
            out_t.to(torch.float32).numpy())


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 64, 2, 2, 64), (2, 128, 4, 2, 64), (1, 256, 4, 1, 128),
    (1, 128, 2, 2, 256), (2, 64, 4, 2, 8), (1, 64, 2, 2, 16),
    (1, 64, 2, 1, 32)])
def test_causal_sweep_matches_jax(B, S, H, KV, hd):
    out_j, out_t = _both(*_qkv(B * S + hd, B, S, H, KV, hd), "fp32",
                         causal=True)
    np.testing.assert_allclose(out_t, out_j, **FWD)


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=32), dict(causal=True, softcap=30.0),
    dict(causal=False), dict(causal=True, window=4096),
    dict(causal=True, window=16, softcap=50.0)],
    ids=["window", "softcap", "non_causal", "window_past_seq",
         "window_softcap"])
def test_masks_and_softcap_match_jax(kw):
    out_j, out_t = _both(*_qkv(7, 1, 128, 2, 2, 64), "fp32", **kw)
    np.testing.assert_allclose(out_t, out_j, **FWD)


def test_bf16_matches_jax():
    out_j, out_t = _both(*_qkv(11, 1, 128, 2, 2, 64), "bf16", causal=True)
    np.testing.assert_allclose(out_t, out_j, **BF16)


@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1), (8, 2)])
def test_gqa_row_map_matches_jax_kernel(H, KV):
    """The head-flattened wrapper with ``heads`` against JAX's kernel on
    compact K/V (its in-kernel row map), and against repeating K/V."""
    from repro.kernels.flash.kernel import flash_attention_bh as j_bh
    B, S, hd = 2, 128, 64
    q, k, v = _qkv(H * 10 + KV, B, S, H, KV, hd)
    qb = q.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    kb = k.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    vb = v.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    want = np.asarray(j_bh(jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb),
                           causal=True, block_q=64, block_k=64, heads=H))
    got = ops.flash_attention_bh(torch.tensor(qb), torch.tensor(kb),
                                 torch.tensor(vb), causal=True, heads=H)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    rep = np.repeat(k, H // KV, 2).transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    repv = np.repeat(v, H // KV, 2).transpose(0, 2, 1, 3).reshape(B * H, S,
                                                                   hd)
    np.testing.assert_allclose(
        got.numpy(), ref.attention_bh(torch.tensor(qb), torch.tensor(rep),
                                      torch.tensor(repv)).numpy(),
        rtol=0, atol=0)


def test_plain_versions_match_jax_refs():
    q, k, v = _qkv(3, 2, 64, 4, 2, 32)
    for kw in (dict(causal=True), dict(causal=True, window=8, softcap=5.0),
               dict(causal=False)):
        want = np.asarray(j_ops._ref_gqa(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v),
                                         kw["causal"], kw.get("window", 0),
                                         kw.get("softcap", 0.0)))
        got = ref.ref_gqa(*(torch.tensor(x) for x in (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), want, **FWD)
    qb = q[:, :, :2].transpose(0, 2, 1, 3).reshape(4, 64, 32)
    kb = k.transpose(0, 2, 1, 3).reshape(4, 64, 32)
    vb = v.transpose(0, 2, 1, 3).reshape(4, 64, 32)
    want = np.asarray(j_ref.attention_bh(jnp.asarray(qb), jnp.asarray(kb),
                                         jnp.asarray(vb), causal=True,
                                         window=16, softcap=20.0))
    got = ref.attention_bh(torch.tensor(qb), torch.tensor(kb),
                           torch.tensor(vb), causal=True, window=16,
                           softcap=20.0)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("kw", [dict(), dict(window=16, softcap=5.0)],
                         ids=["causal", "window_softcap"])
def test_gradients_match_jax_and_autograd(kw):
    """The Function's recompute backward against ``jax.grad`` of JAX's
    ``flash_attention`` (its ``custom_vjp``) and against torch autograd
    through the plain reference."""
    q, k, v = _qkv(5, 1, 64, 4, 2, 32)

    def f_jax(q, k, v):
        return jnp.sum(j_ops.flash_attention(q, k, v, causal=True,
                                             block_q=64, block_k=64,
                                             **kw) ** 2)

    gj = jax.grad(f_jax, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (ops.flash_attention(tq, tk, tv, causal=True, **kw) ** 2).sum().backward()
    pq, pk, pv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (ref.ref_gqa(pq, pk, pv, causal=True, **kw) ** 2).sum().backward()
    for a, b, c in zip(gj, (tq, tk, tv), (pq, pk, pv)):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), **GRAD)
        np.testing.assert_allclose(b.grad.numpy(), c.grad.numpy(), **GRAD)


def test_vmap_grad_is_one_call_and_equals_member_loop(monkeypatch):
    """``vmap(grad_and_value(...))`` through the Function, as the cluster
    update runs it: the member axis folds into the batch, so the wrapper
    is called once for all members, and the values and gradients equal a
    Python loop over the members."""
    C, B, S, H, KV, hd = 3, 2, 40, 4, 2, 16
    rng = np.random.default_rng(9)
    q = torch.tensor(rng.standard_normal((C, B, S, H, hd)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((C, B, S, KV, hd)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((C, B, S, KV, hd)), dtype=torch.float32)

    def loss(q, k, v):
        return (ops.flash_attention(q, k, v, causal=True, window=9,
                                    softcap=4.0) ** 2).sum()

    calls = []
    plain = ref.attention_bh_gqa

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "attention_bh_gqa", counted)
    grads, vals = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(q, k, v)
    assert calls == [(C * B * H, S, hd)]
    for c in range(C):
        g1, v1 = grad_and_value(loss, argnums=(0, 1, 2))(q[c], k[c], v[c])
        torch.testing.assert_close(vals[c], v1, rtol=1e-5, atol=1e-5)
        for a, b in zip(grads, g1):
            torch.testing.assert_close(a[c], b, rtol=1e-5, atol=1e-6)


def test_unbatched_operand_is_expanded_under_vmap():
    """A K/V shared by every vmapped member is expanded by the vmap rule."""
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((2, 1, 16, 2, 8)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((1, 16, 2, 8)), dtype=torch.float32)
    out = vmap(lambda q: ops.flash_attention(q, k, k))(q)
    for c in range(2):
        torch.testing.assert_close(out[c], ref.ref_gqa(q[c], k, k),
                                   rtol=1e-5, atol=1e-6)


def test_cpu_never_launches_and_non_cpu_never_takes_plain():
    before = ops.flash_attention_bh.launches
    q, k, v = (torch.tensor(x) for x in _qkv(1, 1, 32, 2, 2, 8))
    ops.flash_attention(q, k, v)
    assert ops.flash_attention_bh.launches == before
    meta = torch.empty((2, 32, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention_bh(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention_bh(meta, torch.zeros(2, 32, 8),
                               torch.zeros(2, 32, 8))
