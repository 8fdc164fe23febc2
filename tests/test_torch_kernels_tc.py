"""The arithmetic of the redesigned kernels, on the CPU.

The fp32 flash kernel on the tensor cores takes its products in split TF32
(``ref.attention_bh_split_tf32``); the distill kernel cuts each row's
vocabulary into chunks and merges their statistics in order
(``ref.kd_loss_rows_split``).  Neither runs here, so these tests hold plain
models of their arithmetic to the JAX package: the flash oracle
``repro.kernels.flash.ref`` at the fp32 tolerance of
``tests/test_kernels_flash.py`` (atol 2e-5 / rtol 1e-4), and the JAX distill
kernel in interpret mode at the tolerance of ``tests/test_distill.py``.
They also pin the choices the wrappers make from shapes alone: the flash
kernel for each head size and dtype, and distill's split count.  Inputs come
from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.kernels.distill import ops as j_distill
from repro.kernels.flash import ref as j_ref
from repro_torch.configs.archs import ARCHS, smoke_variant
from repro_torch.kernels.distill import ops as d_ops
from repro_torch.kernels.distill import ref as d_ref
from repro_torch.kernels.flash import ops as f_ops
from repro_torch.kernels.flash import ref as f_ref

jax.config.update("jax_platform_name", "cpu")
FWD = dict(atol=2e-5, rtol=1e-4)


def _bh(seed, BH, BKV, S, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((BH, S, hd), (BKV, S, hd), (BKV, S, hd)))


def _jax_oracle(q, k, v, heads, **kw):
    """``repro.kernels.flash.ref.attention_bh`` with K/V rows repeated by
    the kernel's grouped-query row map."""
    rows = f_ref.kv_rows(q.shape[0], k.shape[0], heads).numpy()
    return np.asarray(j_ref.attention_bh(jnp.asarray(q), jnp.asarray(k[rows]),
                                         jnp.asarray(v[rows]), **kw))


# ---------------------------------------------------------------- TF32
def test_round_tf32_is_nearest_with_ties_away_from_zero():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 0.0, -2.0, 3.0e-39])
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10, 0.0, -2.0]
    got = f_ref.round_tf32(x)
    assert got[:6].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.default_rng(0)
    y = torch.tensor(rng.standard_normal(10_000).astype(np.float32)) * 100
    r = f_ref.round_tf32(y)
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11).all()
    hi, lo = f_ref._split(y)
    # the split keeps 22 of fp32's 24 significant bits
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kw,H,KV", [
    (dict(causal=True), 2, 2), (dict(causal=True, window=48), 2, 2),
    (dict(causal=True, softcap=30.0), 2, 2), (dict(causal=False), 2, 2),
    (dict(causal=True), 4, 2), (dict(causal=True, window=40, softcap=20.0),
                                 4, 1)],
    ids=["causal", "window", "softcap", "non_causal", "gqa",
         "gqa_window_softcap"])
def test_split_tf32_attention_matches_jax_oracle(hd, kw, H, KV):
    B, S = 2, 160
    q, k, v = _bh(hd + H * 10 + KV, B * H, B * KV, S, hd)
    want = _jax_oracle(q, k, v, H, **kw)
    got = f_ref.attention_bh_split_tf32(*(torch.tensor(x) for x in (q, k, v)),
                                        heads=H, **kw)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_one_product_tf32_misses_the_fp32_tolerance():
    """Why the fp32 kernel splits: plain TF32 products at hd 128, S 256 miss
    the tolerance the split holds on the same inputs."""
    q, k, v = _bh(1, 4, 4, 256, 128)
    want = _jax_oracle(q, k, v, None, causal=True)
    args = [torch.tensor(x) for x in (q, k, v)]
    plain = f_ref.attention_bh_split_tf32(*args, causal=True, terms=1).numpy()
    split = f_ref.attention_bh_split_tf32(*args, causal=True, terms=3).numpy()
    allowed = FWD["atol"] + FWD["rtol"] * np.abs(want)
    assert (np.abs(plain - want) / allowed).max() > 2.0
    assert (np.abs(split - want) / allowed).max() < 0.5


# ---------------------------------------------------------------- distill
def _logits(seed, N, V):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    t = (rng.normal(size=(N, V)) * 3).astype(np.float32)
    y = rng.integers(0, V, N).astype(np.int32)
    return s, t, y


@pytest.mark.parametrize("splits", [1, 3, 7, 32])
@pytest.mark.parametrize("V,T,alpha", [(1000, 2.0, 0.3), (1500, 3.0, 0.7)])
def test_split_merge_matches_jax_kernel(splits, V, T, alpha):
    """Per-chunk statistics merged in chunk order, against the JAX kernel
    in interpret mode; 1000 and 1500 do not divide by 3, 7 or 32."""
    s, t, y = _logits(V + splits, 6, V)
    chunk = d_ops.chunk_for(V, splits)
    assert -(-V // chunk) == splits
    want = float(j_distill.kd_loss(jnp.asarray(s), jnp.asarray(y),
                                   jnp.asarray(t), T=T, alpha=alpha,
                                   interpret=True))
    rows = d_ref.kd_loss_rows_split(torch.tensor(s), torch.tensor(t),
                                    torch.tensor(y), chunk=chunk, T=T,
                                    alpha=alpha)
    assert abs(float(rows.mean()) - want) < 1e-3 * max(1.0, abs(want))
    np.testing.assert_allclose(
        rows.numpy(), d_ref.kd_loss_rows(torch.tensor(s), torch.tensor(t),
                                         torch.tensor(y), T=T,
                                         alpha=alpha).numpy(),
        rtol=2e-4, atol=1e-5)


def test_split_merge_with_a_chunk_holding_only_the_label():
    """V = 57 in chunks of 8: the last chunk is logit 56 alone, the label of
    row 0; bf16 logits at the bf16 tolerance of tests/test_distill.py."""
    V = 57
    s, t, y = _logits(11, 4, V)
    y[0] = V - 1
    chunk = d_ops.chunk_for(V, 8)
    assert chunk == 8 and V - (V // chunk) * chunk == 1
    for dtype, jd, tol in ((torch.float32, jnp.float32, 1e-3),
                           (torch.bfloat16, jnp.bfloat16, 5e-2)):
        want = float(j_distill.kd_loss(jnp.asarray(s).astype(jd),
                                       jnp.asarray(y),
                                       jnp.asarray(t).astype(jd),
                                       interpret=True))
        rows = d_ref.kd_loss_rows_split(torch.tensor(s).to(dtype),
                                        torch.tensor(t).to(dtype),
                                        torch.tensor(y), chunk=chunk)
        assert abs(float(rows.mean()) - want) < tol * max(1.0, abs(want))


# ---------------------------------------------------------------- choices
def _head_dims():
    dims = {c.head_dim for c in ARCHS.values()}
    dims |= {smoke_variant(c).head_dim for c in ARCHS.values()}
    assert dims == {c.head_dim for c in J_ARCHS.values()} | {64}
    return sorted(dims)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_variant_for_every_arch_head_size(dtype):
    for hd in _head_dims():
        assert hd in f_ops.TC_HEAD_DIMS
        want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        assert f_ops._variant(hd, dtype) == want
    for hd in (8, 16, 32):
        assert f_ops._variant(hd, dtype) == "simt"
    with pytest.raises(ValueError):
        f_ops._variant(96, dtype)
    with pytest.raises(ValueError):
        f_ops._variant(128, torch.float16)


@pytest.mark.parametrize("N", [1, 3, 32, 512, 4096])
def test_distill_split_plan_for_every_arch_vocabulary(N):
    for cfg in ARCHS.values():
        V = cfg.padded_vocab
        splits, chunk = d_ops.split_plan(N, V)
        assert chunk % d_ops.GROUP == 0
        assert (splits - 1) * chunk < V <= splits * chunk   # none empty
        assert N * splits <= d_ops.TARGET_BLOCKS + N        # no more than needed
        assert N * splits >= min(d_ops.TARGET_BLOCKS // 2, N)
    assert d_ops.split_plan(480, 10) == (1, 10)             # the CNN: one kernel
    assert d_ops.split_plan(32, 50_432) == (17, 2968)
    assert d_ops.split_plan(512, 151_936) == (2, 75_968)
