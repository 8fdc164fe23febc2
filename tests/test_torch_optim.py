"""Port parity for ``repro_torch.optim``: the learning-rate schedules, the
three optimizers and gradient clipping, against ``repro.optim``.

The same seeded numpy trees (fp32 and bf16 parameters, fp32 and bf16
gradients) go through both packages over many steps, each package feeding
its own parameters and state back.  Tolerances: schedules rtol 1e-6 (one
fp32 ulp: the packages' ``pow`` and ``cos`` may round differently); fp32
trees rtol 2e-4 / atol 1e-5; bf16 parameters within 2 bf16 ulps of their
magnitude (rtol 2⁻⁷, atol 1e-3), since one ulp of rounding in the fp32 step
can move a bf16 parameter to its neighbour.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import optimizers as j_opt
from repro.optim import schedules as j_sched

from repro_torch import interop
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim import schedules as t_sched

from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
STEPS = 40


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    t = {"w": rng.normal(size=(17, 9)), "b": rng.normal(size=(9,)),
         "blocks": [{"k": rng.normal(size=(3, 4, 5))},
                    {"k": rng.normal(size=(3, 4, 5))}]}
    return jax.tree.map(lambda x: x.astype(dtype), t)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return interop.params_from_numpy(tree)


@pytest.mark.parametrize("name,kw", [
    ("constant", {}), ("cosine", {"warmup": 5}), ("cosine", {"warmup": 0}),
    ("wsd", {"warmup": 5}), ("wsd", {"warmup": 0})])
def test_schedules_match(name, kw):
    fj = j_sched.get(name, 3e-3, 50, **kw)
    ft = t_sched.get(name, 3e-3, 50, **kw)
    for step in range(-1, 53):
        vt = ft(step)
        assert vt.dtype == torch.float32 and vt.shape == ()
        np.testing.assert_allclose(float(vt), float(fj(step)), rtol=1e-6,
                                   atol=0)
        # a tensor step gives the same value
        assert float(ft(torch.tensor(step))) == float(vt)


def test_wsd_fractions_match():
    for total in (1, 7, 10, 100, 333):
        fj = j_sched.wsd(1.0, total, warmup_frac=0.2, decay_frac=0.3,
                         min_frac=0.05)
        ft = t_sched.wsd(1.0, total, warmup_frac=0.2, decay_frac=0.3,
                         min_frac=0.05)
        for s in range(total + 2):
            np.testing.assert_allclose(float(ft(s)), float(fj(s)),
                                       rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_global_norm_and_clip_match(dtype):
    g = _tree(1, dtype)
    _close(t_opt.global_norm(_to_torch(g)), j_opt.global_norm(_to_jax(g)))
    for max_norm in (0.0, 0.5, 1e3):
        cj = j_opt.clip_by_global_norm(_to_jax(g), max_norm)
        ct = t_opt.clip_by_global_norm(_to_torch(g), max_norm)
        for a, b in zip(tree_leaves(ct), jax.tree.leaves(cj)):
            assert _np(a).shape == np.asarray(b).shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            if dtype == np.float32:
                _close(a, b)
            else:
                _close(a, b, BF16_RTOL, BF16_ATOL)


def _run(opt_name, p_dtype, g_dtype, lr_kind, kw):
    """STEPS steps of both packages' optimizer on the same gradients;
    returns (port params, JAX params, port state, JAX state)."""
    oj, ot = j_opt.get(opt_name, **kw), t_opt.get(opt_name, **kw)
    pj, pt = _to_jax(_tree(0, p_dtype)), _to_torch(_tree(0, p_dtype))
    sj, st = oj.init(pj), ot.init(pt)
    sched_j = j_sched.wsd(0.05, STEPS)
    sched_t = t_sched.wsd(0.05, STEPS)
    upd_j = jax.jit(oj.update)
    for step in range(STEPS):
        g = _tree(100 + step, g_dtype)
        gj = j_opt.clip_by_global_norm(_to_jax(g), 1.0)
        gt = t_opt.clip_by_global_norm(_to_torch(g), 1.0)
        if lr_kind == "schedule":
            lrj, lrt = sched_j(step), sched_t(step)
        else:
            lrj = lrt = 0.05
        pj, sj = upd_j(gj, sj, pj, lrj)
        out, st = ot.update(gt, st, pt, lrt)
        assert out is pt                        # updated in place
    return pt, pj, st, sj


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {}), ("momentum", {"beta": 0.8}), ("adamw", {}),
    ("adamw", {"b1": 0.8, "b2": 0.99, "weight_decay": 0.1})])
@pytest.mark.parametrize("lr_kind", ["schedule", "float"])
def test_optimizer_fp32_matches(opt_name, kw, lr_kind):
    pt, pj, st, sj = _run(opt_name, np.float32, np.float32, lr_kind, kw)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        assert a.dtype == torch.float32
        _close(a, b)
    if opt_name == "adamw":
        assert st["t"].dtype == torch.int32 and int(st["t"]) == STEPS
        assert int(sj["t"]) == STEPS
        for k in ("m", "v"):
            for a, b in zip(tree_leaves(st[k]), jax.tree.leaves(sj[k])):
                assert a.dtype == torch.float32
                _close(a, b)


@pytest.mark.parametrize("opt_name,lr_kind", [
    ("sgd", "float"), ("momentum", "schedule"), ("momentum", "float"),
    ("adamw", "schedule"), ("adamw", "float")])
@pytest.mark.parametrize("g_dtype", [np.float32, ml_dtypes.bfloat16])
def test_optimizer_bf16_params_match(opt_name, lr_kind, g_dtype):
    """bf16 parameters stay bf16 in both packages and round alike: the
    fp32 step is cast to bf16 before it is subtracted."""
    pt, pj, st, _ = _run(opt_name, ml_dtypes.bfloat16, g_dtype, lr_kind, {})
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        _close(a, b, BF16_RTOL, BF16_ATOL)
    if opt_name != "sgd":
        moments = st["m"] if opt_name == "adamw" else st
        assert all(m.dtype == torch.float32 for m in tree_leaves(moments))


def test_adamw_reduces_quadratic_loss():
    """The JAX package's own check, on the port: AdamW drives a quadratic
    towards its minimum."""
    opt = t_opt.adamw(weight_decay=0.0)
    p = {"x": torch.tensor([3.0, -2.0])}
    st = opt.init(p)
    for _ in range(300):
        g = {"x": 2 * p["x"]}
        p, st = opt.update(g, st, p, 0.05)
    assert float(torch.sum(p["x"] ** 2)) < 1e-2
