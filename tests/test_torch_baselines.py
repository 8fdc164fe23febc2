"""Port parity of the §V-B baselines (``core/baselines.py``): FedAvg,
FedProx, Oort and HeteroFL at a small width, both packages from the same
initial weights (JAX's draw carried across by ``interop``; for HeteroFL
through the port's ``init_params=`` keyword), on the same host batch
stream.

Final parameters agree at rtol 2e-4 / atol 1e-5 in fp32, accuracy curves
are equal (the same number of test samples right in every round: XLA
divides the count by multiplying with 1/n in fp32, which can put the
float one ulp from torch's division), and Oort chooses the same pids in
every round.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import baselines as j_bl
from repro.core.resources import participants_from_matrix as j_parts
from repro.models import cnn as j_cnn

from repro_torch import interop
from repro_torch.core import baselines as t_bl
from repro_torch.core.distill import ce_loss
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.core.tree import tree_leaves
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification, train_test_split
from repro_torch.models import cnn as t_cnn

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
SEED, N_PART = 3, 8
CFG = dict(rounds=3, steps_per_round=2, local_batch=8, lr=0.08, seed=SEED)
WIDTH = 0.25 * 0.125        # the examples' smallest-slave width


def _federation():
    ds = make_classification("synth-mnist", 600, seed=SEED)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, N_PART, alpha=1.0, seed=SEED)
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_PART)]
    n_data = [len(p) for p in idx]
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return V, n_data, cd, {"x": test.x, "y": test.y}


def _j_loss(params, batch):
    logits = j_cnn.forward(params, batch["x"])
    lse = jax.nn.logsumexp(logits, -1)
    picked = jnp.take_along_axis(logits, batch["y"][:, None], -1)[:, 0]
    return jnp.mean(lse - picked), logits


def _t_loss(params, batch):
    logits = t_cnn.forward(params, batch["x"])
    return ce_loss(logits, batch["y"]).mean(), logits


@contextlib.contextmanager
def _chosen(bl):
    """Each round's chosen pids of a package's Oort run, read through the
    selection hook its ``_run_rounds`` is handed."""
    chosen, real = [], bl._run_rounds

    def spy(*a, select=None, **kw):
        def logged(ps, losses, r):
            out = select(ps, losses, r)
            chosen.append([p.pid for p in out])
            return out
        return real(*a, select=logged, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bl, "_run_rounds", spy)
        yield chosen


def _assert_curves_equal(hj, ht, n_test):
    assert [round(float(a) * n_test) for a in hj] == \
        [round(a * n_test) for a in ht]
    np.testing.assert_allclose(ht, [float(a) for a in hj], rtol=0,
                               atol=1e-7)


def _assert_params_close(pj, pt):
    lj = jax.tree.leaves(pj)
    lt = tree_leaves(pt)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        torch.testing.assert_close(b, torch.tensor(np.asarray(a)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["fedavg", "fedprox", "oort"])
def test_single_model_baselines_match_jax(name):
    V, n_data, cd, test = _federation()
    init_j = j_cnn.init_params(jax.random.PRNGKey(0), in_channels=1,
                               classes=10, base_width=WIDTH)
    init_t = interop.params_from_numpy(jax.tree.map(np.asarray, init_j))
    testj = {"x": jnp.asarray(test["x"]), "y": jnp.asarray(test["y"])}
    jcfg, tcfg = j_bl.BaselineConfig(**CFG), t_bl.BaselineConfig(**CFG)
    pj_parts, pt_parts = j_parts(V, n_data=n_data), participants_from_matrix(
        V, n_data=n_data)
    if name == "oort":
        with _chosen(j_bl) as chosen_j:
            pj, hj = j_bl.oort(_j_loss, init_j, pj_parts, cd, testj, jcfg,
                               flops_per_sample=1e6, model_bytes=2e5)
        with _chosen(t_bl) as chosen_t:
            pt, ht = t_bl.oort(_t_loss, init_t, pt_parts, cd, test, tcfg,
                               flops_per_sample=1e6, model_bytes=2e5)
        assert chosen_t == chosen_j and len(chosen_t) == CFG["rounds"]
        # ε-greedy: each round takes oort_frac of the participants
        assert all(len(c) == N_PART // 2 for c in chosen_t)
    else:
        pj, hj = getattr(j_bl, name)(_j_loss, init_j, pj_parts, cd, testj,
                                     jcfg)
        pt, ht = getattr(t_bl, name)(_t_loss, init_t, pt_parts, cd, test,
                                     tcfg)
    _assert_params_close(pj, pt)
    _assert_curves_equal(hj, ht, len(test["y"]))


def test_heterofl_matches_jax_on_carried_weights():
    V, n_data, cd, test = _federation()
    levels = {p: min(2, 3 * p // N_PART) for p in range(N_PART)}
    testj = {"x": jnp.asarray(test["x"]), "y": jnp.asarray(test["y"])}
    kw = dict(in_channels=1, classes=10, levels=3, base_width=0.125)
    pj, hj = j_bl.heterofl(j_parts(V, n_data=n_data), cd, levels, testj,
                           j_bl.BaselineConfig(**CFG), **kw)
    # the global model JAX draws from PRNGKey(seed), carried across
    init_j = j_cnn.init_params(jax.random.PRNGKey(SEED), in_channels=1,
                               classes=10, alpha=1.0, level=0,
                               base_width=0.125)
    pt, ht = t_bl.heterofl(
        participants_from_matrix(V, n_data=n_data), cd, levels, test,
        t_bl.BaselineConfig(**CFG), device="cpu",
        init_params=interop.params_from_numpy(
            jax.tree.map(np.asarray, init_j)), **kw)
    _assert_params_close(pj, pt)
    _assert_curves_equal(hj, ht, len(test["y"]))
    # every level trained a slice: the slimmest convs changed from the init
    w0 = torch.tensor(np.asarray(init_j["convs"][0]["w"]))
    assert not torch.equal(pt["convs"][0]["w"][..., :4], w0[..., :4])


def test_heterofl_own_init_and_slices():
    """The port's own draw: a seeded full-width model, sub-models whose
    shapes are ``cnn.filters`` at α^ℓ; and without a card it raises."""
    tmpl = t_bl._cnn_template(in_channels=1, classes=10, alpha=0.5, level=2,
                              base_width=0.25)
    assert [c["w"].shape[-1] for c in tmpl["convs"]] == list(
        t_cnn.filters(0.5, 2, 0.25))
    assert all(x.device.type == "meta" for x in tree_leaves(tmpl))
    V, n_data, cd, test = _federation()
    parts = participants_from_matrix(V, n_data=n_data)
    cfg = t_bl.BaselineConfig(**dict(CFG, rounds=1))
    kw = dict(in_channels=1, classes=10, levels=2, base_width=0.125)
    a, ha = t_bl.heterofl(parts, cd, {p: p % 2 for p in range(N_PART)}, test,
                          cfg, device="cpu", **kw)
    b, hb = t_bl.heterofl(parts, cd, {p: p % 2 for p in range(N_PART)}, test,
                          cfg, device="cpu", **kw)
    assert ha == hb and all(torch.equal(x, y) for x, y in
                            zip(tree_leaves(a), tree_leaves(b)))
    assert all(torch.isfinite(x).all() for x in tree_leaves(a))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_bl.heterofl(parts, cd, {}, test, cfg, **kw)
