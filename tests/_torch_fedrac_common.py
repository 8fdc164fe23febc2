"""Shared set-up of the port's slice-level parity tests
(``test_torch_fedrac*.py``): one small federation (base width 0.125, 10
participants, 2 rounds), JAX and port engines on it, and the port engines
that carry the JAX initial parameters and batch-index draws.

Tolerance rtol 2e-4 / atol 1e-5 in fp32; accuracy curves agree to within
one test sample, since a parameter difference inside that tolerance may
flip one borderline argmax.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import server as j_srv
from repro.core.families import cnn_family as j_cnn_family
from repro.core.resources import participants_from_matrix as j_parts
from repro.data import device_sampler as j_ds

from repro_torch import interop
from repro_torch.core import server as t_srv
from repro_torch.core.families import cnn_family as t_cnn_family
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification, train_test_split

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
SEED, N_PART, ROUNDS = 3, 10, 2
CFG = dict(steps_per_round=2, local_batch=8, lr=0.08, seed=SEED,
           compact_to=2, rounds=ROUNDS)


def _federation():
    ds = make_classification("synth-mnist", 500, seed=SEED)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, N_PART, alpha=1.0, seed=SEED)
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_PART)]
    n_data = [len(p) for p in idx]
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return V, n_data, cd, {"x": test.x, "y": test.y}


class CarriedFedRAC(t_srv.FedRAC):
    """Port engine whose initial parameters are the JAX family's draw."""

    def init_params(self, level):
        pj = j_cnn_family(base_width=0.125).init(
            jax.random.PRNGKey(self.cfg.seed + level), level)
        return interop.params_from_numpy(jax.tree.map(np.asarray, pj),
                                         self.device)


class BridgedFedRAC(CarriedFedRAC):
    """...whose dispatch path draws JAX's device-sampler indices."""

    def _draw_indices(self, pack, r, balanced):
        key = j_ds.round_key(self.cfg.seed, r)
        S, B = self.cfg.steps_per_round, self.cfg.local_batch
        if balanced:
            idx = j_ds.balanced_indices(key, S, B, jnp.asarray(pack["tables"]),
                                        jnp.asarray(pack["counts"]))
        else:
            idx = j_ds.uniform_indices(key, S, B,
                                       jnp.asarray(pack["n"], jnp.int32))
        return np.asarray(idx)


def _engines(R, cls=BridgedFedRAC, **extra):
    V, n_data, cd, test = _federation()
    kw = dict(CFG, rounds_per_dispatch=R, **extra)
    j = j_srv.FedRAC(j_parts(V, n_data=n_data), cd,
                     j_cnn_family(base_width=0.125),
                     j_srv.FLConfig(donate_plane=False, **kw),
                     classes=10).setup()
    t = cls(participants_from_matrix(V, n_data=n_data), cd,
            t_cnn_family(base_width=0.125), t_srv.FLConfig(**kw),
            classes=10, device="cpu").setup()
    assert j.assignment.members == t.assignment.members
    assert j.assignment.members[0] and j.assignment.members[1], \
        "the federation must have a master and a slave cluster"
    return j, t, test


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def _teacher(j, t):
    """One master for both packages: the JAX master init, carried."""
    pj = j.family.init(jax.random.PRNGKey(42), 0)
    return pj, t.params_of(0, t.plane_of(0, interop.params_from_numpy(
        jax.tree.map(np.asarray, pj))))


def _curves_close(hj, ht, n_test):
    assert hj.keys() == ht.keys()
    for level in hj:
        np.testing.assert_allclose(hj[level], ht[level], rtol=0,
                                   atol=1.0 / n_test + 1e-9)


