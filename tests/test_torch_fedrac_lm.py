"""Port parity for the LM slice as a whole: Algorithm 1 on the LM family
through the dispatch path, with attention on the flash route.

The federation is the equivalence matrix's token-only ``matrix-lm``
(``tests/test_equivalence_matrix.py``): 8 members, each holding 32 windows
of 17 tokens and nothing else, and a ``_batch_from_gathered`` hook that
adds ``"y" = tokens[..., -1]`` for the KD objective.  Both packages run it
from the same initial parameters, with the JAX device-sampler draws
injected into the port (as ``_torch_fedrac_common.BridgedFedRAC`` does for
the CNN).  The port runs ``attn_impl="pallas"`` (the flash kernel's plain
version on the CPU), and so does the JAX side, in interpret mode.
Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import server as j_srv
from repro.core.families import lm_family as j_lm_family
from repro.core.resources import participants_from_matrix as j_parts
from repro.data import device_sampler as j_ds

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import server as t_srv
from repro_torch.core.families import lm_family
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.data.synthetic import lm_batches, make_lm_corpus
from repro_torch.kernels.fedagg import ops as fedagg_ops
from repro_torch.kernels.flash import ops as flash_ops

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
SEED, N_PART = 0, 8
LM = dict(name="matrix-lm", family="dense", n_layers=2, d_model=32,
          n_heads=4, n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64,
          rope_theta=1e4, attn_impl="pallas")
CFG = dict(steps_per_round=3, lr=0.05, seed=SEED, local_batch=4,
           compact_to=2, class_balanced=False, rounds=2)


def _federation():
    corpus = make_lm_corpus(64, 8_000, seed=0)
    cd = [{"tokens": lm_batches(ch, 32, 17, 1, seed=i)[0]}
          for i, ch in enumerate(np.array_split(corpus, N_PART))]
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_PART)]
    test = {"tokens": lm_batches(corpus, 16, 17, 1, seed=99)[0]}
    return V, cd, test


class TokenFedRAC(t_srv.FedRAC):
    """Token-only data: the JAX tests' hooks (``_batch_from_gathered`` adds
    the KD hard label; evaluation is -loss)."""

    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        test = self._to_device(test)
        with torch.no_grad():
            loss, _ = self.family.loss_and_logits(level, params, test)
        return -float(loss)


class JTokenFedRAC(j_srv.FedRAC):
    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        loss, _ = self.family.loss_and_logits(level, params, test)
        return -float(loss)


class BridgedTokenFedRAC(TokenFedRAC):
    """...carrying the JAX initial parameters and batch-index draws."""

    def init_params(self, level):
        pj = j_lm_family(JModelConfig(**LM), 0.5).init(
            jax.random.PRNGKey(self.cfg.seed + level), level)
        return interop.params_from_numpy(jax.tree.map(np.asarray, pj),
                                         self.device)

    def _draw_indices(self, pack, r, balanced):
        key = j_ds.round_key(self.cfg.seed, r)
        return np.asarray(j_ds.uniform_indices(
            key, self.cfg.steps_per_round, self.cfg.local_batch,
            jnp.asarray(pack["n"], jnp.int32)))


def _port(R, cls=BridgedTokenFedRAC, **extra):
    V, cd, test = _federation()
    eng = cls(participants_from_matrix(V, n_data=[32] * N_PART), cd,
              lm_family(ModelConfig(**LM), 0.5),
              t_srv.FLConfig(**dict(CFG, rounds_per_dispatch=R, **extra)),
              classes=64, device="cpu").setup()
    return eng, test


@pytest.fixture(scope="module")
def lm_pair():
    V, cd, test = _federation()
    j = JTokenFedRAC(j_parts(V, n_data=[32] * N_PART), cd,
                     j_lm_family(JModelConfig(**LM), 0.5),
                     j_srv.FLConfig(donate_plane=False, rounds_per_dispatch=2,
                                    **CFG), classes=64).setup()
    t, _ = _port(2)
    assert j.assignment.members == t.assignment.members
    assert j.assignment.members[0] and j.assignment.members[1], \
        "the federation must have a master and a slave cluster"
    return j, t, test


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def test_token_only_federation_runs_the_dispatch_path():
    """The engine reads member data through ``_member_shard`` and sizes
    shards by their first leaf, so a federation whose data is only
    ``{"tokens"}`` (no ``"y"``) packs and trains.  The plain engine, with
    no hook overridden, trains the master by FedAvg; the token engine also
    trains the slave under KD."""
    base, _ = _port(2, cls=t_srv.FedRAC)
    members = base.assignment.members[0]
    cap = base._capacity(len(members))
    pack = base._shard_pack(0, members, cap, False)
    assert set(pack["shards"]) == {"tokens"}
    assert list(pack["n"][:len(members)]) == [32] * len(members)
    assert tuple(pack["shards"]["tokens"].shape) == (cap, 32, 17)
    out = base.dispatch_rounds(0, members, base.plane_of(0,
                               base.init_params(0)), 0, 2)
    assert bool(torch.isfinite(out.losses).all())
    eng, test = _port(2, cls=TokenFedRAC)
    res = eng.train(test)
    assert eng.m == 2 and all(len(res.history[l]) == 2 for l in (0, 1))
    assert all(np.isfinite(res.history[l]).all() for l in (0, 1))


@pytest.mark.parametrize("level", [0, 1])
def test_lm_dispatch_block_matches_jax(lm_pair, level):
    """One R = 2 block of the master (FedAvg) and of a slave (KD): final
    plane, per-round planes and per-round member losses."""
    j, t, _ = lm_pair
    members = j.assignment.members[level]
    plane_j = j.plane_of(level, j.family.init(
        jax.random.PRNGKey(SEED + level), level))
    np.testing.assert_array_equal(
        interop.plane_to_numpy(t.plane_of(level, t.init_params(level))),
        np.asarray(plane_j))
    tj = tt = None
    if level:
        tj = j.family.init(jax.random.PRNGKey(42), 0)
        tt = t.params_of(0, t.plane_of(0, interop.params_from_numpy(
            jax.tree.map(np.asarray, tj))))
    oj = j.dispatch_rounds(level, members, plane_j, 0, 2, teacher=tj,
                           want_history=True)
    ot = t.dispatch_rounds(level, members,
                           interop.plane_from_numpy(np.asarray(plane_j)), 0,
                           2, teacher=tt, want_history=True)
    assert tuple(ot.losses.shape) == (2, len(members))
    _close(oj.losses, ot.losses)
    _close(oj.history, ot.history)
    _close(oj.plane, interop.plane_to_numpy(ot.plane))


def test_lm_train_matches_jax(lm_pair):
    """Algorithm 1 end to end: -loss curves of the master and the slave
    and their final planes."""
    j, t, test = lm_pair
    rj = j.train({"tokens": jnp.asarray(test["tokens"])})
    rt = t.train(test)
    assert rj.k_optimal == rt.k_optimal and rj.m == rt.m
    for level in rj.history:
        _close(rj.history[level], rt.history[level])
    for level in j.cluster_params:
        _close(j.plane_of(level, j.cluster_params[level]),
               t.plane_of(level, t.cluster_params[level]))


def test_port_lm_dispatch_width_invariant_and_builds_once():
    """Within the port R = 2 and R = 4 run the same rounds and give the
    same planes; every block program is built once; on the CPU no kernel
    is launched."""
    launches = (fedagg_ops.weighted_aggregate.launches,
                flash_ops.flash_attention_bh.launches)
    t2, test = _port(2, cls=TokenFedRAC, rounds=4)
    t4, _ = _port(4, cls=TokenFedRAC, rounds=4)
    r2, r4 = t2.train(test), t4.train(test)
    assert r2.history == r4.history
    for level in t2.cluster_params:
        torch.testing.assert_close(
            t2.plane_of(level, t2.cluster_params[level]),
            t4.plane_of(level, t4.cluster_params[level]), rtol=0, atol=0)
    for eng, R in ((t2, 2), (t4, 4)):
        stats = eng.compile_stats()
        assert stats and set(stats.values()) == {1}
        assert all(k[0] == "dispatch" and k[4] == R for k in stats)
    assert (fedagg_ops.weighted_aggregate.launches,
            flash_ops.flash_attention_bh.launches) == launches
