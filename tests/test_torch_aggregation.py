"""Port parity: plane layout, FedAvg ops and the fedagg plain version.

The same numpy inputs go through ``repro.core.aggregation`` (and the JAX
fedagg kernel in interpret mode) and ``repro_torch.core.aggregation``.
Tolerance rtol 2e-4 / atol 1e-5 in fp32 unless a test states another.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import aggregation as j_agg
from repro.core import plane as j_plane
from repro.kernels.fedagg import ops as j_ops
from repro.kernels.fedagg import ref as j_ref

from repro_torch.core import aggregation as t_agg
from repro_torch.core import plane as t_plane
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.fedagg import ops as t_ops
from repro_torch.kernels.fedagg import ref as t_ref

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


def _stack(seed, C=6):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(C, 13, 7)).astype(np.float32),
            "b": rng.normal(size=(C, 5)).astype(np.float32),
            "l": [rng.normal(size=(C, 3)).astype(np.float32)]}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("raw", [[1, 2, 3, 4, 5, 6], [0, 0, 0, 0, 0, 0],
                                 [0, 3, 0, 1, 0, 0]])
def test_normalized_weights_and_aggregate(raw):
    stack = _stack(0)
    wj = j_agg.normalized_weights(raw)
    wt = t_agg.normalized_weights(raw)
    _close(wj, wt)
    assert np.isfinite(wt.numpy()).all()
    a = j_agg.aggregate(jax.tree.map(jnp.asarray, stack), wj)
    b = t_agg.aggregate(_t(stack), wt)
    for x, y in zip(jax.tree.leaves(a), tree_leaves(b)):
        _close(x, y)


@pytest.mark.parametrize("raw", [[1.0, 2.0, 0.5], [0.0, 0.0, 0.0]])
def test_fedavg_delta_zero_total_guard(raw):
    stack = _stack(1, C=3)
    g = {k: (v[0] if k != "l" else [v[0][0]]) for k, v in _stack(2, C=1)
         .items()}
    a = j_agg.fedavg_delta(jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, stack), raw)
    b = t_agg.fedavg_delta(_t(g), _t(stack), raw)
    for x, y in zip(jax.tree.leaves(a), tree_leaves(b)):
        _close(x, y)
    if sum(raw) == 0:
        assert all(float(y.abs().max()) == 0.0 for y in tree_leaves(b))


@pytest.mark.parametrize("C,D", [(1, 128), (3, 2176), (8, 4096), (64, 256)])
def test_aggregate_plane_matches_jax_and_kernel_interpret(C, D):
    rng = np.random.default_rng(C * 7 + D)
    x = rng.normal(size=(C, D)).astype(np.float32)
    w = rng.dirichlet(np.ones(C)).astype(np.float32)
    want = j_agg.aggregate_plane(jnp.asarray(x), jnp.asarray(w),
                                 use_kernel=False)
    got = t_agg.aggregate_plane(torch.tensor(x), torch.tensor(w))
    _close(want, got)
    _close(j_ref.weighted_aggregate(jnp.asarray(x), jnp.asarray(w)),
           t_ref.weighted_aggregate(torch.tensor(x), torch.tensor(w)))
    interp = j_ops.aggregate_plane(jnp.asarray(x), jnp.asarray(w),
                                   interpret=True)
    _close(interp, t_ops.weighted_aggregate(torch.tensor(x),
                                            torch.tensor(w)))


def test_plane_delta_and_buffered_merge():
    rng = np.random.default_rng(3)
    C, D = 5, 384
    g = rng.normal(size=D).astype(np.float32)
    x = rng.normal(size=(C, D)).astype(np.float32)
    bank = rng.normal(size=(2, D)).astype(np.float32)
    for w in (rng.uniform(size=C).astype(np.float32),
              np.zeros(C, np.float32)):
        _close(j_agg.fedavg_delta_plane(jnp.asarray(g), jnp.asarray(x),
                                        jnp.asarray(w)),
               t_agg.fedavg_delta_plane(torch.tensor(g), torch.tensor(x),
                                        torch.tensor(w)))
    u = np.array([0.2, 0.1], np.float32)
    part = rng.normal(size=D).astype(np.float32)
    _close(j_agg.merge_buffered_plane(jnp.asarray(part), jnp.asarray(bank),
                                      jnp.asarray(u), use_kernel=False),
           t_agg.merge_buffered_plane(torch.tensor(part), torch.tensor(bank),
                                      torch.tensor(u)))


def test_compress_bank_rows_keeps_totals():
    rng = np.random.default_rng(4)
    rows = [rng.normal(size=256).astype(np.float32) for _ in range(4)]
    us = [0.5, 0.25, 1.0, 0.125]
    a_rows, a_us = j_agg.compress_bank_rows([jnp.asarray(r) for r in rows],
                                            us, 2)
    b_rows, b_us = t_agg.compress_bank_rows([torch.tensor(r) for r in rows],
                                            us, 2)
    assert len(b_rows) == 1 and a_us == pytest.approx(b_us)
    _close(a_rows[0], b_rows[0])
    same_rows, same_us = t_agg.compress_bank_rows(rows[:2], us[:2], 2)
    assert same_us == us[:2] and len(same_rows) == 2


def test_staleness_and_anchor_weights():
    n, age = [10, 4, 7], [1, 3, 0]
    assert (j_agg.staleness_weights(n, age, 0.6)
            == t_agg.staleness_weights(n, age, 0.6))
    assert (j_agg.version_staleness_weights(n, [4, 2, 5], 6, 0.5)
            == t_agg.version_staleness_weights(n, [4, 2, 5], 6, 0.5))
    for anchor, us in ((12.0, [1.0, 2.0]), (0.0, [0.0, 0.0])):
        assert (j_agg.anchored_merge_weights(anchor, us)
                == t_agg.anchored_merge_weights(anchor, us))


def test_merge_buffered_pytree():
    part, c1, c2 = (_stack(s, C=1) for s in (5, 6, 7))
    a = j_agg.merge_buffered(jax.tree.map(jnp.asarray, part),
                             [jax.tree.map(jnp.asarray, c) for c in (c1, c2)],
                             [0.25, 0.5])
    b = t_agg.merge_buffered(_t(part), [_t(c1), _t(c2)], [0.25, 0.5])
    for x, y in zip(jax.tree.leaves(a), tree_leaves(b)):
        _close(x, y)


def test_plane_spec_matches_ravel_pytree():
    tree = {k: v[0] for k, v in _stack(8).items() if k != "l"}
    tree["l"] = [_stack(8)["l"][0][0], np.ones((2, 2), np.float32)]
    js = j_plane.make_plane_spec(jax.tree.map(jnp.asarray, tree))
    ts = t_plane.make_plane_spec(_t(tree))
    assert (js.d, js.d_pad) == (ts.d, ts.d_pad)
    assert ts.d_pad % t_plane.PLANE_ALIGN == 0
    jp = np.asarray(js.to_plane(jax.tree.map(jnp.asarray, tree)))
    tp = ts.to_plane(_t(tree)).numpy()
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(
        np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, tree))[0]),
        tp[:ts.d])
    back = ts.to_params(torch.tensor(tp))
    for x, y in zip(jax.tree.leaves(tree), tree_leaves(back)):
        np.testing.assert_array_equal(x, y.numpy())
    # a member axis in front is kept: (C, ...) params -> (C, d_pad) planes
    stacked = {k: torch.stack([v, 2 * v]) if not isinstance(v, list)
               else [torch.stack([u, 2 * u]) for u in v]
               for k, v in _t(tree).items()}
    planes = ts.to_plane(stacked)
    assert planes.shape == (2, ts.d_pad)
    np.testing.assert_array_equal(planes[1].numpy(), 2 * tp)


def test_pad_member_rows_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 128)).astype(np.float32)
    w = rng.uniform(size=3).astype(np.float32)
    jp, jw = j_plane.pad_member_rows(jnp.asarray(x), jnp.asarray(w), 8)
    tp, tw = t_plane.pad_member_rows(torch.tensor(x), torch.tensor(w), 8)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    with pytest.raises(ValueError):
        t_plane.pad_member_rows(torch.tensor(x), torch.tensor(w), 2)


def test_fedagg_wrapper_routes_by_device():
    """CPU tensors take the plain version (no launch is counted); a tensor
    on another device is refused rather than sent to the plain version."""
    before = t_ops.weighted_aggregate.launches
    x, w = torch.randn(4, 128), torch.rand(4)
    torch.testing.assert_close(t_ops.weighted_aggregate(x, w),
                               t_ref.weighted_aggregate(x, w))
    assert t_ops.weighted_aggregate.launches == before
    with pytest.raises(ValueError):
        t_ops.weighted_aggregate(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        t_ops.weighted_aggregate(x, w.to("meta"))
