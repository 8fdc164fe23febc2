"""Port parity for the Mamba mixer (``repro_torch.models.mamba``) and the
hybrid family (jamba).

The forward runs over S = 256, two chunks of 128, so the carry crosses a
chunk boundary; the log-step scan that takes the place of
``jax.lax.associative_scan`` associates the products differently, and the
results still agree with JAX at rtol 2e-4 / atol 1e-5 in fp32.  Decode
steps the same tokens through ``mamba_decode`` against JAX's.  The jamba
smoke (mamba + attention, dense and MoE FFNs) runs forward, loss and
decode against JAX.  JAX draws are carried across (``interop``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.models import mamba as j_mamba
from repro.models import registry as j_registry

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import mamba, registry

jax.config.update("jax_platform_name", "cpu")
TOL = dict(rtol=2e-4, atol=1e-5)
ARCH = "jamba-v0.1-52b"


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def _mixer(seed=0):
    jcfg = j_get_config(ARCH, smoke=True)
    pj = j_mamba.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return (get_config(ARCH, smoke=True), jcfg, pj,
            interop.params_from_numpy(jax.tree.map(np.asarray, pj)))


def test_scan_linear_equals_the_sequential_recurrence():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(0.5, 1.0, (2, 37, 3)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((2, 37, 3)).astype(np.float32))
    aa, bb = mamba.scan_linear(a, b)
    h, p = torch.zeros(2, 3), torch.ones(2, 3)
    for t in range(37):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        _close(bb[:, t], h, rtol=1e-5, atol=1e-6)
        _close(aa[:, t], p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S", [8, 256])
def test_forward_matches_jax(S):
    """S = 256 runs two chunks, the carry threaded between them."""
    cfg, jcfg, pj, pt = _mixer()
    x = np.random.default_rng(1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    _close(mamba.mamba_forward(pt, cfg, torch.tensor(x)),
           j_mamba.mamba_forward(pj, jcfg, jnp.asarray(x)))
    init = mamba.init_mamba(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in pj.items()}
    # log of 1..16: one ulp apart at most between the two libraries
    _close(init["A_log"], pj["A_log"], rtol=1e-6, atol=0)


def test_decode_matches_jax_and_prefill():
    cfg, jcfg, pj, pt = _mixer(seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    cj = j_mamba.init_mamba_cache(jcfg, 2, jnp.float32)
    ct = mamba.init_mamba_cache(cfg, 2, torch.float32)
    outs = []
    for t in range(12):
        xt = x[:, t:t + 1]
        yj, cj = j_mamba.mamba_decode(pj, jcfg, cj, jnp.asarray(xt), t)
        yt, ct = mamba.mamba_decode(pt, cfg, ct, torch.tensor(xt), t)
        _close(yt, yj)
        outs.append(yt)
    _close(ct["h"], cj["h"])
    _close(ct["conv"], cj["conv"])
    _close(torch.cat(outs, 1),
           mamba.mamba_forward(pt, cfg, torch.tensor(x)), rtol=1e-4,
           atol=1e-5)


def test_jamba_smoke_matches_jax():
    """Forward, loss and eight decode steps of the hybrid smoke model."""
    cfg, jcfg = get_config(ARCH, smoke=True), j_get_config(ARCH, smoke=True)
    assert cfg.block_pattern == ("mamba", "attn")
    assert cfg.ffn_pattern == ("dense", "moe")
    pj = j_registry.init_params(jcfg, jax.random.PRNGKey(4))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    lj, aj = j_registry.forward(jcfg, pj, {"tokens": jnp.asarray(toks)})
    lt, at = registry.forward(cfg, pt, {"tokens": torch.tensor(toks)})
    _close(lt, lj)
    _close(at, aj)
    losses_j = j_registry.loss_fn(jcfg, pj, {"tokens": jnp.asarray(toks)})
    losses_t = registry.loss_fn(cfg, pt, {"tokens": torch.tensor(toks)})
    for a, b in zip(losses_j, losses_t):
        _close(b, a)
    cj = j_registry.init_cache(jcfg, 2, 8)
    ct = registry.init_cache(cfg, 2, 8)
    for t in range(8):
        gj, cj = j_registry.decode_step(jcfg, pj, cj,
                                        jnp.asarray(toks[:, t:t + 1]), t)
        gt, ct = registry.decode_step(cfg, pt, ct,
                                      torch.tensor(toks[:, t:t + 1]), t)
        _close(gt, gj)
    for a, b in zip(jax.tree.leaves(cj), tree_leaves(ct)):
        _close(b, a)
