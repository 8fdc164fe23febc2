"""Port parity: the CNN, the MLP and member training.

Parameters are made by the JAX families and carried into the port with
``repro_torch.interop``; batches and teacher logits are numpy arrays from
a seed.  Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import client as j_client
from repro.core import families as j_fam
from repro.models import cnn as j_cnn

from repro_torch import interop
from repro_torch.core import client as t_client
from repro_torch.core import families as t_fam
from repro_torch.core.plane import make_plane_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.models import cnn as t_cnn

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5


def _carry(params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, params))


def _flat(params):
    return np.asarray(ravel_pytree(params)[0])


def _tplane(params):
    spec = make_plane_spec(params)
    return spec.to_plane(params).detach().numpy()[:spec.d]


@pytest.mark.parametrize("hw,cin,level", [(14, 1, 0), (14, 1, 1),
                                          (16, 3, 0), (9, 1, 0)])
def test_cnn_forward_matches_jax(hw, cin, level):
    pj = j_cnn.init_params(jax.random.PRNGKey(level), in_channels=cin,
                           alpha=0.5, level=level, base_width=0.125)
    pt = _carry(pj)
    x = np.random.default_rng(hw).normal(size=(6, hw, hw, cin)
                                         ).astype(np.float32)
    want = np.asarray(j_cnn.forward(pj, jnp.asarray(x)))
    got = t_cnn.forward(pt, torch.tensor(x)).numpy()
    np.testing.assert_allclose(want, got, rtol=RTOL, atol=ATOL)


def test_cnn_plane_order_is_ravel_pytree():
    pj = j_cnn.init_params(jax.random.PRNGKey(3), base_width=0.125)
    pt = _carry(pj)
    np.testing.assert_array_equal(_flat(pj), _tplane(pt))
    # b sorts before w inside each conv, convs before dense
    first = tree_leaves(pt)[:2]
    assert first[0].shape == (16,) and first[1].shape == (3, 3, 1, 16)


def test_port_init_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    pt = t_cnn.init_params(g, base_width=0.5, level=0)
    pj = jax.eval_shape(lambda: j_cnn.init_params(jax.random.PRNGKey(0),
                                                  base_width=0.5))
    for a, b in zip(jax.tree.leaves(pj), tree_leaves(pt)):
        assert tuple(a.shape) == tuple(b.shape)
    w0 = pt["convs"][3]["w"]
    assert abs(float(w0.std()) - (2.0 / (9 * w0.shape[2])) ** 0.5) < 0.1 * (
        2.0 / (9 * w0.shape[2])) ** 0.5
    assert float(pt["convs"][0]["b"].abs().max()) == 0.0
    assert t_cnn.param_count(pt) == t_cnn.param_count_of(base_width=0.5)


def test_mlp_family_matches_jax():
    fj, ft = j_fam.mlp_family(), t_fam.mlp_family()
    pj = fj.init(jax.random.PRNGKey(1), 1)
    pt = _carry(pj)
    np.testing.assert_array_equal(_flat(pj), _tplane(pt))
    rng = np.random.default_rng(2)
    b = {"x": rng.normal(size=(8, 14, 14, 1)).astype(np.float32),
         "y": rng.integers(0, 10, 8).astype(np.int32)}
    lj, gj = fj.loss_and_logits(1, pj, jax.tree.map(jnp.asarray, b))
    lt, gt = ft.loss_and_logits(1, pt, interop.params_from_numpy(b))
    np.testing.assert_allclose(float(lj), float(lt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(gj), gt.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert fj.model_bytes(1) == ft.model_bytes(1)
    assert fj.flops_per_sample(1) == ft.flops_per_sample(1)


def _batches(seed, lead, hw=14):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=lead + (8, hw, hw, 1)).astype(np.float32),
            "y": rng.integers(0, 10, lead + (8,)).astype(np.int32)}


@pytest.mark.parametrize("case", ["plain", "masked", "prox", "kd"])
def test_local_update_matches_jax(case):
    fj = j_fam.cnn_family(base_width=0.125)
    ft = t_fam.cnn_family(base_width=0.125)
    pj = fj.init(jax.random.PRNGKey(4), 0)
    pt = _carry(pj)
    b = _batches(5, (3,))
    kw, mask = {}, None
    if case == "masked":
        mask = np.array([1.0, 0.0, 1.0], np.float32)
    if case == "prox":
        kw = dict(prox_mu=0.3)
    if case == "kd":
        kw = dict(kd_T=3.0, kd_alpha=0.4)
        tl = np.random.default_rng(6).normal(size=(3, 8, 10)
                                             ).astype(np.float32)
    nj, lj = j_client.local_update(
        partial(fj.loss_and_logits, 0), pj, jax.tree.map(jnp.asarray, b),
        0.05, step_mask=None if mask is None else jnp.asarray(mask),
        teacher_logits=jnp.asarray(tl) if case == "kd" else None, **kw)
    nt, lt = t_client.local_update(
        partial(ft.loss_and_logits, 0), pt, interop.params_from_numpy(b),
        0.05, step_mask=None if mask is None else torch.tensor(mask),
        teacher_logits=torch.tensor(tl) if case == "kd" else None, **kw)
    np.testing.assert_allclose(float(lj), float(lt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_flat(nj), _tplane(nt), rtol=RTOL, atol=ATOL)


def test_cluster_update_three_members_one_fully_masked():
    fj = j_fam.cnn_family(base_width=0.125)
    ft = t_fam.cnn_family(base_width=0.125)
    pj = fj.init(jax.random.PRNGKey(7), 1)
    C = 3
    stack_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape), pj)
    stack_t = interop.params_from_numpy(jax.tree.map(np.asarray, stack_j))
    b = _batches(8, (C, 2))
    masks = np.array([[1, 1], [0, 0], [1, 0]], np.float32)
    tl = np.random.default_rng(9).normal(size=(C, 2, 8, 10)
                                         ).astype(np.float32)
    upd_j = j_client.make_cluster_update(partial(fj.loss_and_logits, 1),
                                         0.05, kd_T=2.0, kd_alpha=0.3)
    upd_t = t_client.make_cluster_update(partial(ft.loss_and_logits, 1),
                                         0.05, kd_T=2.0, kd_alpha=0.3)
    nj, lj = upd_j(stack_j, jax.tree.map(jnp.asarray, b), jnp.asarray(masks),
                   jnp.asarray(tl))
    nt, lt = upd_t(stack_t, interop.params_from_numpy(b),
                   torch.tensor(masks), torch.tensor(tl))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), rtol=RTOL,
                               atol=ATOL)
    for a, c in zip(jax.tree.leaves(nj), tree_leaves(nt)):
        np.testing.assert_allclose(np.asarray(a), c.numpy(), rtol=RTOL,
                                   atol=ATOL)
    # the fully masked member stays at the incoming params, loss 0
    assert float(lt[1]) == 0.0
    for a, c in zip(tree_leaves(stack_t), tree_leaves(nt)):
        torch.testing.assert_close(a[1], c[1], rtol=0, atol=0)
