"""Port parity for the enc-dec family (``repro_torch.models.encdec``,
seamless-m4t-medium's smoke variant): the bidirectional encoder, the
decoder forward with cross-attention, the cross-attention pieces of
``models/attention.py``, ``build_cross_cache`` and ``decode_step``, and
the registry's enc-dec branch (``init_cache`` defaulting ``src_len`` to
``max_len // 8``).  JAX draws are carried across (``interop``); tolerance
rtol 2e-4 / atol 1e-5 in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import encdec as j_encdec
from repro.models import registry as j_registry

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import attention, encdec, registry

jax.config.update("jax_platform_name", "cpu")
TOL = dict(rtol=2e-4, atol=1e-5)
ARCH = "seamless-m4t-medium"


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


@pytest.fixture(scope="module")
def model():
    jcfg = j_get_config(ARCH, smoke=True)
    pj = j_encdec.init_params(jcfg, jax.random.PRNGKey(3))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    emb = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    return get_config(ARCH, smoke=True), jcfg, pt, pj, toks, emb


def test_encode_and_forward_match_jax(model):
    cfg, jcfg, pt, pj, toks, emb = model
    assert cfg.family == "encdec" and registry.is_encdec(cfg)
    _close(encdec.encode(cfg, pt, torch.tensor(emb)),
           j_encdec.encode(jcfg, pj, jnp.asarray(emb)))
    lt, at = encdec.forward(cfg, pt, torch.tensor(toks),
                            embeds=torch.tensor(emb))
    lj, aj = j_encdec.forward(jcfg, pj, jnp.asarray(toks),
                              embeds=jnp.asarray(emb))
    _close(lt, lj)
    assert float(at) == float(aj) == 0.0
    bt = {"tokens": torch.tensor(toks), "embeds": torch.tensor(emb)}
    bj = {"tokens": jnp.asarray(toks), "embeds": jnp.asarray(emb)}
    for a, b in zip(j_registry.loss_fn(jcfg, pj, bj),
                    registry.loss_fn(cfg, pt, bt)):
        _close(b, a)


def test_encoder_ignores_the_flash_route(model):
    """The encoder's self-attention is non-causal: ``"pallas"`` sends it
    to the plain path, as in JAX, so the output does not change."""
    cfg, _, pt, _, _, emb = model
    _close(encdec.encode(cfg.replace(attn_impl="pallas"), pt,
                         torch.tensor(emb)),
           encdec.encode(cfg, pt, torch.tensor(emb)), rtol=0, atol=0)


def test_cross_attention_matches_jax(model):
    cfg, jcfg, pt, pj, _, emb = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pc = jax.tree.map(lambda a: a[0], pj["dec_blocks"]["cross"])
    pct = interop.params_from_numpy(jax.tree.map(np.asarray, pc))
    kj, vj = j_attn.cross_kv(pc, jcfg, jnp.asarray(emb))
    kt, vt = attention.cross_kv(pct, cfg, torch.tensor(emb))
    _close(kt, kj)
    _close(vt, vj)
    _close(attention.cross_attn_forward(pct, cfg, torch.tensor(x), kt, vt),
           j_attn.cross_attn_forward(pc, jcfg, jnp.asarray(x), kj, vj))
    init = attention.init_cross_attn(torch.Generator().manual_seed(0), cfg,
                                     torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in pc.items()}


def test_build_cross_cache_and_decode_match_jax(model):
    cfg, jcfg, pt, pj, toks, emb = model
    T = toks.shape[1]
    cj = j_registry.init_cache(jcfg, 2, T, src_len=12)
    ct = registry.init_cache(cfg, 2, T, src_len=12)
    cj = j_encdec.build_cross_cache(jcfg, pj, cj, jnp.asarray(emb))
    ct = encdec.build_cross_cache(cfg, pt, ct, torch.tensor(emb))
    for key in ("xk", "xv"):
        _close(ct[key], cj[key])
    full, _ = encdec.forward(cfg, pt, torch.tensor(toks),
                             embeds=torch.tensor(emb))
    outs = []
    for t in range(T):
        gj, cj = j_registry.decode_step(jcfg, pj, cj,
                                        jnp.asarray(toks[:, t:t + 1]), t)
        gt, ct = registry.decode_step(cfg, pt, ct,
                                      torch.tensor(toks[:, t:t + 1]), t)
        _close(gt, gj)
        outs.append(gt)
    for a, b in zip(jax.tree.leaves(cj), tree_leaves(ct)):
        _close(b, a)
    _close(torch.cat(outs, 1), full, rtol=1e-3, atol=2e-3)


def test_default_cache_serves_zero_cross_kv(model):
    """``init_cache`` without ``src_len`` holds max_len // 8 zero frames,
    the cache JAX's ``generate`` decodes with; one step equals JAX's."""
    cfg, jcfg, pt, pj, toks, _ = model
    ct = registry.init_cache(cfg, 2, 16)
    cj = j_registry.init_cache(jcfg, 2, 16)
    assert tuple(ct["xk"].shape) == cj["xk"].shape == (2, 2, 2, 4, 64)
    assert not bool(ct["xk"].any())
    gj, _ = j_registry.decode_step(jcfg, pj, cj, jnp.asarray(toks[:, :1]), 0)
    gt, _ = registry.decode_step(cfg, pt, ct, torch.tensor(toks[:, :1]), 0)
    _close(gt, gj)
