"""Port parity for the MoE FFN (``repro_torch.models.moe``).

Dense and capacity dispatch, with drops forced (small groups, capacity
factor 0.5), the ``moe_chunk_groups`` branch, the load-balance aux loss, a
router whose probabilities tie (the top-k order of ``jax.lax.top_k``:
lower expert first), and gradients under ``torch.func.vmap(grad)`` against
``jax.vmap(jax.grad)``.  Inputs are numpy draws from a seed; parameters are
JAX draws carried across (``interop``).  Tolerance rtol 2e-4 / atol 1e-5
in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.models import moe as j_moe

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.models import moe

jax.config.update("jax_platform_name", "cpu")
TOL = dict(rtol=2e-4, atol=1e-5)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def _cfgs(**kw):
    return (get_config("granite-moe-1b-a400m", smoke=True).replace(**kw),
            j_get_config("granite-moe-1b-a400m", smoke=True).replace(**kw))


def _params(jcfg, seed=0):
    pj = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return pj, interop.params_from_numpy(jax.tree.map(np.asarray, pj))


def _x(cfg, B=2, S=32, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _both(cfg, jcfg, pt, pj, x):
    yt, at = moe.apply_moe(pt, cfg, torch.tensor(x))
    yj, aj = j_moe.apply_moe(pj, jcfg, jnp.asarray(x))
    return (yt, at), (yj, aj)


def _kept(jcfg, x, pj):
    """How many routing choices JAX's capacity dispatch keeps, of all."""
    B, S, d = x.shape
    gs = min(jcfg.moe_group, B * S)
    xt = jnp.asarray(x).reshape(-1, gs, d)
    _, _, top_i = j_moe._route(pj, jcfg, xt)
    E = jcfg.n_experts
    flat = jax.nn.one_hot(top_i, E, dtype=jnp.int32).reshape(
        xt.shape[0], -1, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    cap = moe.capacity(jcfg, gs)
    return int(jnp.sum(pos < cap)), int(pos.size)


def test_dense_matches_jax():
    cfg, jcfg = _cfgs()
    assert cfg.moe_impl == "dense"
    pj, pt = _params(jcfg)
    x = _x(cfg)
    (yt, at), (yj, aj) = _both(cfg, jcfg, pt, pj, x)
    _close(yt, yj)
    _close(at, aj)
    assert sorted(pt) == sorted(pj)
    init = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in pj.items()}


@pytest.mark.parametrize("group,cap_factor", [(64, 8.0), (16, 0.5),
                                              (32, 1.0)])
def test_capacity_matches_jax_and_drops_the_same_tokens(group, cap_factor):
    """At a binding capacity the dispatch drops tokens (checked: fewer
    routing choices kept than made), and the port drops the same ones:
    outputs and aux equal JAX's.  At capacity 8 nothing drops and the
    capacity path equals the dense one."""
    cfg, jcfg = _cfgs(moe_impl="capacity", moe_group=group,
                      moe_capacity=cap_factor)
    pj, pt = _params(jcfg, seed=2)
    x = _x(cfg, seed=3)
    (yt, at), (yj, aj) = _both(cfg, jcfg, pt, pj, x)
    _close(yt, yj)
    _close(at, aj)
    kept, made = _kept(jcfg, x, pj)
    if cap_factor < 1.0:
        assert kept < made, (kept, made)
    if cap_factor >= 8.0:
        assert kept == made
        yd, _ = moe.apply_moe(pt, cfg.replace(moe_impl="dense"),
                              torch.tensor(x))
        _close(yt, yd, rtol=1e-3, atol=1e-4)


def test_chunk_groups_branch_matches_jax():
    cfg, jcfg = _cfgs(moe_impl="capacity", moe_group=8, moe_capacity=0.75,
                      moe_chunk_groups=2)
    pj, pt = _params(jcfg, seed=4)
    x = _x(cfg, B=2, S=32, seed=5)                 # 8 groups, 4 chunks of 2
    (yt, at), (yj, aj) = _both(cfg, jcfg, pt, pj, x)
    _close(yt, yj)
    _close(at, aj)
    y_all, _ = moe.apply_moe(pt, cfg.replace(moe_chunk_groups=0),
                             torch.tensor(x))
    _close(yt, y_all)


def test_top_k_breaks_ties_as_jax():
    """Equal probabilities come out lower index first, as from
    ``jax.lax.top_k``, in fp32 and bf16."""
    rng = np.random.default_rng(6)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for dtype in (np.float32, jnp.bfloat16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs, dtype), 5)
        tv, ti = moe.top_k(torch.tensor(probs).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32), 5)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tv.float(), np.asarray(jv, np.float32))


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_tied_router_matches_jax(impl):
    """A router with two equal columns and one of zeros: probabilities tie
    on every token, and both dispatches route (and, at capacity 0.5, drop)
    as JAX does."""
    cfg, jcfg = _cfgs(moe_impl=impl, moe_group=16, moe_capacity=0.5)
    pj, _ = _params(jcfg, seed=7)
    r = np.asarray(pj["router"]).copy()
    r[:, 3] = r[:, 1]
    pn = dict(jax.tree.map(np.asarray, pj), router=r)
    pj = jax.tree.map(jnp.asarray, pn)
    pt = interop.params_from_numpy(pn)
    x = _x(cfg, seed=8)
    (yt, at), (yj, aj) = _both(cfg, jcfg, pt, pj, x)
    _close(yt, yj)
    _close(at, aj)
    pz = dict(pn, router=np.zeros_like(r))
    (yt, at), (yj, aj) = _both(cfg, jcfg, interop.params_from_numpy(pz),
                               jax.tree.map(jnp.asarray, pz), x)
    _close(yt, yj)
    _close(at, aj)


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_vmapped_grad_matches_jax(impl):
    """Three members' parameters stacked, each with its own input:
    ``torch.func.vmap(grad)`` of the loss y² + aux equals
    ``jax.vmap(jax.grad)``."""
    cfg, jcfg = _cfgs(moe_impl=impl, moe_group=16, moe_capacity=0.5)
    members = [_params(jcfg, seed=10 + i)[0] for i in range(3)]
    stack_j = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    stack_t = interop.params_from_numpy(jax.tree.map(np.asarray, stack_j))
    xs = np.stack([_x(cfg, B=1, S=32, seed=20 + i) for i in range(3)])

    def loss_j(p, x):
        y, aux = j_moe.apply_moe(p, jcfg, x)
        return jnp.mean(y ** 2) + 0.1 * aux

    def loss_t(p, x):
        y, aux = moe.apply_moe(p, cfg, x)
        return torch.mean(y ** 2) + 0.1 * aux

    gj = jax.vmap(jax.grad(loss_j))(stack_j, jnp.asarray(xs))
    gt = torch.func.vmap(torch.func.grad(loss_t))(stack_t, torch.tensor(xs))
    for a, b in zip(jax.tree.leaves(gj), tree_leaves(gt)):
        _close(b, a, rtol=2e-4, atol=1e-6)
