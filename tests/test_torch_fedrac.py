"""Port parity for the slice as a whole: Algorithm 1 on the paper's CNN,
through the dispatch path (the slice's main path).

Both packages run the small federation of ``_torch_fedrac_common`` at
R = 2 from the same initial parameters, with the JAX package's
device-sampler draws injected into the port through
``FedRAC._draw_indices``; the draws are made from the port pack's host
``n`` / ``tables`` / ``counts``, which must equal the JAX pack's.  The
comparison covers what one JAX path computes, for the master (FedAvg) and a
slave (KD): per-round member losses, per-round planes and accuracy curves.
Within the port, R = 2 and R = 4 must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fedrac_common import (SEED, _close, _curves_close, _engines,
                                  _teacher)
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import interop
from repro_torch.core import server as t_srv
from repro_torch.kernels.distill import ops as distill_ops
from repro_torch.kernels.fedagg import ops as fedagg_ops


@pytest.fixture(scope="module")
def dispatch_pair():
    return _engines(2)


def test_dispatch_pack_host_arrays_match_jax(dispatch_pair):
    j, t, _ = dispatch_pair
    for level in (0, 1):
        members = j.assignment.members[level]
        cap = t._capacity(len(members))
        assert cap == j._capacity(len(members))
        balanced = level == 0
        pj = j._shard_pack(level, members, cap, balanced)
        pt = t._shard_pack(level, members, cap, balanced)
        np.testing.assert_array_equal(np.asarray(pj["n"]), pt["n"])
        for k in ("x", "y"):
            np.testing.assert_array_equal(np.asarray(pj["shards"][k]),
                                          pt["shards"][k].numpy())
        if balanced:
            np.testing.assert_array_equal(np.asarray(pj["tables"]),
                                          pt["tables"])
            np.testing.assert_array_equal(np.asarray(pj["counts"]),
                                          pt["counts"])


@pytest.mark.parametrize("level", [0, 1])
def test_dispatch_block_matches_jax(dispatch_pair, level):
    """One R = 2 block of the master (FedAvg) and of a slave (KD): final
    plane, per-round planes and per-round member losses."""
    j, t, _ = dispatch_pair
    members = j.assignment.members[level]
    tj, tt = _teacher(j, t) if level else (None, None)
    plane_j = j.plane_of(level, j.family.init(
        jax.random.PRNGKey(SEED + level), level))
    plane_t = interop.plane_from_numpy(np.asarray(plane_j))
    np.testing.assert_array_equal(
        interop.plane_to_numpy(t.plane_of(level, t.init_params(level))),
        np.asarray(plane_j))
    oj = j.dispatch_rounds(level, members, plane_j, 0, 2, teacher=tj,
                           want_history=True)
    ot = t.dispatch_rounds(level, members, plane_t, 0, 2, teacher=tt,
                           want_history=True)
    assert tuple(ot.losses.shape) == (2, len(members))
    _close(oj.losses, ot.losses)
    _close(oj.history, ot.history)
    _close(oj.plane, interop.plane_to_numpy(ot.plane))


def test_dispatch_zero_weights_keep_plane(dispatch_pair):
    """A block whose member weights sum to zero leaves the plane as it was
    in every round (the zero-total guard), and still reports losses."""
    _, t, _ = dispatch_pair
    members = t.assignment.members[0]
    plane = t.plane_of(0, t.init_params(0))
    # the block writes its result into the plane it was given (donation),
    # so hold the incoming values apart
    before = plane.clone()
    out = t.dispatch_rounds(0, members, plane, 0, 2,
                            weights=[0.0] * len(members), want_history=True)
    torch.testing.assert_close(out.plane, before, rtol=0, atol=0)
    torch.testing.assert_close(out.history, torch.stack([before, before]),
                               rtol=0, atol=0)
    assert bool(torch.isfinite(out.losses).all())


def test_dispatch_train_matches_jax(dispatch_pair):
    j, t, test = dispatch_pair
    rj = j.train({k: jnp.asarray(v) for k, v in test.items()})
    rt = t.train(test)
    assert rj.k_optimal == rt.k_optimal and rj.m == rt.m
    _curves_close(rj.history, rt.history, len(test["y"]))
    for level in j.cluster_params:
        _close(j.plane_of(level, j.cluster_params[level]),
               t.plane_of(level, t.cluster_params[level]))


def test_port_dispatch_width_invariant_and_builds_once():
    """Within the port R = 2 and R = 4 run the same rounds: the draws are
    keyed on the absolute round, so the planes are identical.  Every
    program is built once, and on the CPU no kernel is launched."""
    fedagg_before = fedagg_ops.weighted_aggregate.launches
    distill_before = distill_ops.kd_loss_rows.launches
    _, t2, test = _engines(2, cls=t_srv.FedRAC, rounds=4)
    _, t4, _ = _engines(4, cls=t_srv.FedRAC, rounds=4)
    r2, r4 = t2.train(test), t4.train(test)
    assert r2.history == r4.history
    for level in t2.cluster_params:
        torch.testing.assert_close(t2.plane_of(level, t2.cluster_params[level]),
                                   t4.plane_of(level, t4.cluster_params[level]),
                                   rtol=0, atol=0)
    for eng, R in ((t2, 2), (t4, 4)):
        stats = eng.compile_stats()
        assert stats and set(stats.values()) == {1}
        assert all(k[0] == "dispatch" and k[4] == R for k in stats)
        assert len(stats) == sum(1 for m in eng.assignment.members.values()
                                 if m)
    assert fedagg_ops.weighted_aggregate.launches == fedagg_before
    assert distill_ops.kd_loss_rows.launches == distill_before
