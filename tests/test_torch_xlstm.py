"""Port parity for the xLSTM blocks (``repro_torch.models.xlstm_blocks``).

The mLSTM in its scan and chunk forms against JAX's and against each
other (over three chunks of 64, so the chunk carry is exercised), the
sLSTM, both decodes, and the sLSTM's GeGLU, which takes the tanh GELU
(``jax.nn.gelu``'s default, not torch's).  The -1e30 stabiliser carries
keep the first step finite.  JAX draws are carried across (``interop``);
tolerance rtol 2e-4 / atol 1e-5 in fp32 unless stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.models import xlstm_blocks as j_xb

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import xlstm_blocks as xb

jax.config.update("jax_platform_name", "cpu")
TOL = dict(rtol=2e-4, atol=1e-5)
ARCH = "xlstm-350m"


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def _block(init, seed=0):
    jcfg = j_get_config(ARCH, smoke=True)
    pj = getattr(j_xb, init)(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return (get_config(ARCH, smoke=True), jcfg, pj,
            interop.params_from_numpy(jax.tree.map(np.asarray, pj)))


def _x(cfg, S, seed=1, d=None):
    return np.random.default_rng(seed).standard_normal(
        (2, S, d or cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["scan", "chunk"])
def test_mlstm_forward_matches_jax(impl):
    cfg, jcfg, pj, pt = _block("init_mlstm")
    cfg, jcfg = cfg.replace(mlstm_impl=impl), jcfg.replace(mlstm_impl=impl)
    x = _x(cfg, 128)
    _close(xb.mlstm_forward(pt, cfg, torch.tensor(x)),
           j_xb.mlstm_forward(pj, jcfg, jnp.asarray(x)))
    init = xb.init_mlstm(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in pj.items()}
    _close(init["b_if"], pj["b_if"], rtol=0, atol=0)


def test_mlstm_chunk_equals_scan_across_chunks():
    """Three chunks of 64: the chunked form against the sequential cell in
    the port, and each against JAX's (JAX's own test bound between forms:
    atol 1e-4)."""
    cfg, jcfg, pj, pt = _block("init_mlstm", seed=2)
    B, S, H = 2, 192, cfg.n_heads
    di = cfg.mlstm_expand * cfg.d_model
    hd = di // H
    xm = _x(cfg, S, seed=3, d=di)
    qt = xb._mlstm_qkvif(pt, cfg, torch.tensor(xm))[:5]
    qj = j_xb._mlstm_qkvif(pj, jcfg, jnp.asarray(xm))[:5]
    seq_t = xb._mlstm_seq(cfg, *qt, B, S, H, hd)
    chk_t = xb._mlstm_chunked(cfg, *qt, B, S, H, hd)
    _close(chk_t, seq_t, rtol=0, atol=1e-4)
    _close(seq_t, j_xb._mlstm_seq(jcfg, *qj, B, S, H, hd))
    _close(chk_t, j_xb._mlstm_chunked(jcfg, *qj, B, S, H, hd))


def test_slstm_forward_matches_jax():
    cfg, jcfg, pj, pt = _block("init_slstm", seed=4)
    x = _x(cfg, 24, seed=5)
    _close(xb.slstm_forward(pt, cfg, torch.tensor(x)),
           j_xb.slstm_forward(pj, jcfg, jnp.asarray(x)))
    init = xb.init_slstm(torch.Generator().manual_seed(0), cfg,
                         torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in pj.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_jax_and_forward(kind):
    cfg, jcfg, pj, pt = _block(f"init_{kind}", seed=6)
    x = _x(cfg, 10, seed=7)
    cj = getattr(j_xb, f"init_{kind}_cache")(jcfg, 2, jnp.float32)
    ct = getattr(xb, f"init_{kind}_cache")(cfg, 2, torch.float32)
    assert [tuple(v.shape) for v in tree_leaves(ct)] == \
        [v.shape for v in jax.tree.leaves(cj)]
    outs = []
    for t in range(10):
        xt = x[:, t:t + 1]
        yj, cj = getattr(j_xb, f"{kind}_decode")(pj, jcfg, cj,
                                                 jnp.asarray(xt), t)
        yt, ct = getattr(xb, f"{kind}_decode")(pt, cfg, ct, torch.tensor(xt),
                                               t)
        assert bool(torch.isfinite(yt).all())
        _close(yt, yj)
        outs.append(yt)
    for a, b in zip(jax.tree.leaves(cj), tree_leaves(ct)):
        _close(b, a)
    full = getattr(xb, f"{kind}_forward")(pt, cfg, torch.tensor(x))
    _close(torch.cat(outs, 1), full, rtol=1e-4, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; torch's default is the
    erf form, which differs by up to about 5e-4 here."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    _close(xb._gelu(torch.tensor(x)), want, rtol=1e-6, atol=1e-6)
    assert float(np.abs(F.gelu(torch.tensor(x)).numpy() - want).max()) > 1e-4
