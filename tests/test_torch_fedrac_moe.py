"""Port parity for Fed-RAC on the MoE family: Algorithm 1 on a granite-like
MoE LM (GQA attention on the flash route, a top-2 MoE FFN with capacity
dispatch in every block) through the dispatch path.

The federation is ``test_torch_fedrac_lm``'s token-only one (8 members,
32 windows of 17 tokens each, the KD hard label ``tokens[..., -1]``).
Both packages run it from the same initial parameters, with the JAX
device-sampler draws injected into the port.  Groups of 17 tokens (one
window) at capacity factor 1.0 make the dispatch drop tokens (checked), so
the members' gradients go through the drops; the master holds 8 experts,
the slave 4.  JAX's flash route runs in interpret mode; the port's on
the CPU is the kernel's plain version.  Tolerance rtol 2e-4 / atol 1e-5 in
fp32.
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
from repro.models import moe as j_moe

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import server as t_srv
from repro_torch.core.families import lm_family
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.data.synthetic import lm_batches, make_lm_corpus
from repro_torch.models import moe

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
SEED, N_PART = 0, 8
LM = dict(name="matrix-moe", family="moe", n_layers=2, d_model=32,
          n_heads=4, n_kv_heads=2, head_dim=8, d_ff=16, vocab_size=64,
          ffn_pattern=("moe",), n_experts=8, experts_per_tok=2,
          moe_impl="capacity", moe_group=17, moe_capacity=1.0,
          rope_theta=1e4, attn_impl="pallas")
CFG = dict(steps_per_round=2, lr=0.05, seed=SEED, local_batch=4,
           compact_to=2, class_balanced=False, rounds=2)


def _federation():
    corpus = make_lm_corpus(64, 8_000, seed=0)
    cd = [{"tokens": lm_batches(ch, 32, 17, 1, seed=i)[0]}
          for i, ch in enumerate(np.array_split(corpus, N_PART))]
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_PART)]
    test = {"tokens": lm_batches(corpus, 16, 17, 1, seed=99)[0]}
    return V, cd, test


class TokenFedRAC(t_srv.FedRAC):
    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        test = self._to_device(test)
        with torch.no_grad():
            loss, _ = self.family.loss_and_logits(level, params, test)
        return -float(loss)

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


class JTokenFedRAC(j_srv.FedRAC):
    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        loss, _ = self.family.loss_and_logits(level, params, test)
        return -float(loss)


@pytest.fixture(scope="module")
def moe_pair():
    V, cd, test = _federation()
    j = JTokenFedRAC(j_parts(V, n_data=[32] * N_PART), cd,
                     j_lm_family(JModelConfig(**LM), 0.5),
                     j_srv.FLConfig(donate_plane=False, rounds_per_dispatch=2,
                                    **CFG), classes=64).setup()
    t = TokenFedRAC(participants_from_matrix(V, n_data=[32] * N_PART), cd,
                    lm_family(ModelConfig(**LM), 0.5),
                    t_srv.FLConfig(rounds_per_dispatch=2, **CFG),
                    classes=64, device="cpu").setup()
    assert j.assignment.members == t.assignment.members
    assert j.assignment.members[0] and j.assignment.members[1]
    return j, t, test


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def test_the_federation_drops_tokens():
    """At the members' batch shape (4 x 17 tokens, groups of 17) the
    capacity binds: the first block's router keeps fewer routing choices
    than it makes."""
    cfg = ModelConfig(**LM)
    assert moe.capacity(cfg, 17) == 5            # ceil(17 * 2 * 1.0 / 8)
    pj = j_lm_family(JModelConfig(**LM), 0.5).init(jax.random.PRNGKey(SEED),
                                                   0)
    p0 = jax.tree.map(lambda a: a[0], pj["blocks"]["p0"]["ffn"])
    _, cd, _ = _federation()
    x = pj["embed"][jnp.asarray(cd[0]["tokens"][:4])]          # (4, 17, 32)
    _, _, top_i = j_moe._route(p0, JModelConfig(**LM), x)
    flat = jax.nn.one_hot(top_i, 8, dtype=jnp.int32).reshape(x.shape[0], -1,
                                                              8)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    assert int(jnp.sum(pos < 5)) < pos.size


@pytest.mark.parametrize("level", [0, 1])
def test_moe_dispatch_block_matches_jax(moe_pair, level):
    """One R = 2 block of the master (FedAvg) and of a slave (KD): final
    plane, per-round planes and per-round member losses."""
    j, t, _ = moe_pair
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
    _close(oj.losses, ot.losses)
    _close(oj.history, ot.history)
    _close(oj.plane, interop.plane_to_numpy(ot.plane))


def test_moe_train_matches_jax(moe_pair):
    """Algorithm 1 end to end: -loss curves (CE plus the router's aux
    term) and the final planes of every cluster."""
    j, t, test = moe_pair
    rj = j.train({"tokens": jnp.asarray(test["tokens"])})
    rt = t.train(test)
    assert rj.k_optimal == rt.k_optimal and rj.m == rt.m
    for level in rj.history:
        _close(rj.history[level], rt.history[level])
    for level in j.cluster_params:
        _close(j.plane_of(level, j.cluster_params[level]),
               t.plane_of(level, t.cluster_params[level]))
