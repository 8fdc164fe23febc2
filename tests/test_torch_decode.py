"""The port's model API for all ten ``ARCHS`` (smoke variants), against
the JAX package: init trees, forward and loss, and cached decode.

``registry.init_params`` gives JAX's tree (paths, shapes, dtypes, plane
length) for every family, the MoE, hybrid, xLSTM and enc-dec ones
included.  On JAX's draws carried across (``interop``) the port's forward,
loss and every ``decode_step`` logit equal JAX's at rtol 2e-4 / atol 1e-5
in fp32, and the port's decode equals its own prefill at the tolerance of
JAX's ``tests/test_arch_smoke.py::test_decode_matches_prefill`` (atol
2e-3, rtol 1e-3).  Enc-dec decodes against the cross cache that
``build_cross_cache`` fills from the frontend stub.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import encdec as j_encdec
from repro.models import registry as j_registry

from repro_torch import interop
from repro_torch.configs import get_config, list_archs
from repro_torch.core.plane import make_plane_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.models import encdec, registry

jax.config.update("jax_platform_name", "cpu")
TOL = dict(rtol=2e-4, atol=1e-5)
PREFILL_TOL = dict(rtol=1e-3, atol=2e-3)     # tests/test_arch_smoke.py
ARCHS = list_archs()
B, S = 2, 8


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


@functools.lru_cache(maxsize=None)
def _jax(arch):
    jcfg = j_get_config(arch, smoke=True)
    return jcfg, j_registry.init_params(jcfg, jax.random.PRNGKey(0))


def _carried(arch):
    jcfg, pj = _jax(arch)
    return (get_config(arch, smoke=True), jcfg, pj,
            interop.params_from_numpy(jax.tree.map(np.asarray, pj)))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, S)).astype(np.int32)}
    if cfg.frontend:
        batch["embeds"] = rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    return batch


def test_every_arch_is_covered():
    assert ARCHS == j_list_archs() and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax(arch):
    """Same leaf paths, shapes, dtypes and plane length as JAX's init, and
    the carried tree round-trips through the plane."""
    jcfg, pj = _jax(arch)
    cfg = get_config(arch, smoke=True)
    pt = registry.init_params(cfg, torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_flatten_with_path(pj)[0]
    tl = tree_leaves(pt)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
    assert registry.param_count(pt) == j_registry.param_count(pj)
    carried = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    spec = make_plane_spec(carried)
    plane = spec.to_plane(carried)
    np.testing.assert_array_equal(plane.numpy()[:spec.d],
                                  np.asarray(ravel_pytree(pj)[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    cfg, jcfg, pj, pt = _carried(arch)
    nb = _batch(cfg)
    bj = jax.tree.map(jnp.asarray, nb)
    bt = interop.params_from_numpy(nb)
    lj, aj = j_registry.forward(jcfg, pj, bj)
    lt, at = registry.forward(cfg, pt, bt)
    assert tuple(lt.shape) == lj.shape
    _close(lt, lj)
    _close(at, aj)
    for a, b in zip(j_registry.loss_fn(jcfg, pj, bj),
                    registry.loss_fn(cfg, pt, bt)):
        _close(b, a)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_prefill(arch):
    cfg, jcfg, pj, pt = _carried(arch)
    nb = _batch(cfg, seed=2)
    toks = nb["tokens"]
    if cfg.family == "encdec":
        emb = nb["embeds"]
        full, _ = encdec.forward(cfg, pt, torch.tensor(toks),
                                 embeds=torch.tensor(emb))
        cj = j_encdec.build_cross_cache(jcfg, pj, j_registry.init_cache(
            jcfg, B, S, 8), jnp.asarray(emb))
        ct = encdec.build_cross_cache(cfg, pt, registry.init_cache(
            cfg, B, S, 8), torch.tensor(emb))
    else:
        # text-only decode (a VLM's frontend positions run in forward)
        full, _ = registry.forward(cfg, pt, {"tokens": torch.tensor(toks)})
        cj = j_registry.init_cache(jcfg, B, S)
        ct = registry.init_cache(cfg, B, S)
    assert [tuple(x.shape) for x in tree_leaves(ct)] == \
        [x.shape for x in jax.tree.leaves(cj)]
    step = jax.jit(lambda c, t, i: j_registry.decode_step(jcfg, pj, c, t, i))
    outs = []
    for t in range(S):
        gj, cj = step(cj, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t))
        gt, ct = registry.decode_step(cfg, pt, ct,
                                      torch.tensor(toks[:, t:t + 1]), t)
        _close(gt, gj)
        outs.append(gt)
    for a, b in zip(jax.tree.leaves(cj), tree_leaves(ct)):
        _close(b, a)
    _close(torch.cat(outs, 1), full, **PREFILL_TOL)
