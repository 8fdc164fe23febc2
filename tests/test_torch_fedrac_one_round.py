"""Port parity for the slice as a whole on the one-round path (R = 1).

Both packages run the small federation of ``_torch_fedrac_common`` from
the same initial parameters; the port reproduces the JAX package's host
numpy batch stream (seed + 977 pid + round) bit for bit.  Per-round member
losses and planes of the master (FedAvg) and a slave (KD), then the
accuracy curves of ``train``, at rtol 2e-4 / atol 1e-5 (curves to within
one test sample).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fedrac_common import (ROUNDS, SEED, _close, _curves_close,
                                  _engines, _teacher)


@pytest.fixture(scope="module")
def pair():
    return _engines(1)


def test_one_round_path_matches_jax(pair):
    j, t, test = pair
    pj_teacher, pt_teacher = _teacher(j, t)
    for level, teach in ((0, (None, None)), (1, (pj_teacher, pt_teacher))):
        members = j.assignment.members[level]
        pj = j.family.init(jax.random.PRNGKey(SEED + level), level)
        pt = t.init_params(level)
        for r in range(ROUNDS):
            pj, lj = j.cluster_round(level, members, pj, r, teacher=teach[0])
            pt, lt = t.cluster_round(level, members, pt, r, teacher=teach[1])
            _close(lj, lt)
        _close(j.plane_of(level, pj), t.plane_of(level, pt))
    rj = j.train({k: jnp.asarray(v) for k, v in test.items()})
    rt = t.train(test)
    _curves_close(rj.history, rt.history, len(test["y"]))
    for level in j.cluster_params:
        _close(j.plane_of(level, j.cluster_params[level]),
               t.plane_of(level, t.cluster_params[level]))


def test_masked_weighted_and_dropped_rounds_match_jax(pair):
    """Step masks (a straggler row, a fully masked row) and raw weights
    with a zero entry renormalize the same way; all-zero weights leave the
    parameters as they were."""
    j, t, _ = pair
    members = j.assignment.members[0]
    C, S = len(members), j.cfg.steps_per_round
    masks = np.ones((C, S), np.float32)
    masks[0, 1:] = 0.0
    masks[-1] = 0.0
    weights = np.arange(C, dtype=np.float32)            # member 0 weighs 0
    pj = j.family.init(jax.random.PRNGKey(SEED), 0)
    pt = t.init_params(0)
    pj, lj = j.cluster_round(0, members, pj, 1, step_masks=masks,
                             weights=weights)
    pt, lt = t.cluster_round(0, members, pt, 1, step_masks=masks,
                             weights=weights)
    _close(lj, lt)
    assert float(lt[-1]) == 0.0
    _close(j.plane_of(0, pj), t.plane_of(0, pt))
    same, lz = t.cluster_round(0, members, pt, 2, weights=np.zeros(C))
    assert same is pt and tuple(lz.shape) == (C,)
    for a, b in zip(jax.tree.leaves(j.cluster_round(
            0, members, pj, 2, weights=np.zeros(C))[0]),
            jax.tree.leaves(pj)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert torch.count_nonzero(lz) == 0
