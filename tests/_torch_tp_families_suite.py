"""The fixture and tests of the tensor-parallel member forward of the
MoE, hybrid Mamba, xLSTM and enc-dec families, shared by
``test_torch_tp_families*.py``: each file takes the cases of its families
(``suite``) and spawns its own world of 4 gloo ranks, so that no one rank
world carries every family.  ``tests/test_torch_tp_families.py``'s
docstring describes the tests.
"""

import functools
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import families as j_families
from repro.core import server as j_srv
from repro.core.resources import participants_from_matrix as j_parts

from _torch_mesh_common import InjectedFedRAC, start_world
from _torch_mesh_jax import (JaxDraws, JTokenFedRAC, RecordingBridgedFedRAC,
                             jax_inputs, jax_scenario)
from _torch_tp_common import CFG, KINDS, scenario
from _torch_tp_families_common import (CONFIGS, FAMILIES, GRAD_MESHES,
                                       RUNS, SEED, config, federation,
                                       grad_inputs, level_routing,
                                       make_engine, member_grads,
                                       tp_families_rank)
from repro_torch.core.plane import make_tp_plane_spec

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
# a top-k choice may differ from the unsharded forward's only where its
# two probabilities lie closer than this: the residual stream under TP is
# the unsharded one summed in another order, a few fp32 ulps apart
NEAR_TIE = 1e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def _jax_family(name):
    arch, kw = CONFIGS[FAMILIES[name]]
    return j_families.lm_family(j_get_config(arch, smoke=True).replace(**kw),
                                0.5)


def _jax_engine(name, kind):
    V, n_data, cd, _ = federation()
    cfg = j_srv.FLConfig(**dict(CFG, aggregation=kind, donate_plane=False,
                                class_balanced=False))
    return JTokenFedRAC(j_parts(V, n_data=n_data), cd, _jax_family(name),
                        cfg, classes=64).setup()


def _jax_results(inputs, jax_runs):
    """JAX's single-device run of each of ``jax_runs``: {(family, kind):
    (result, the assignment's members)}.  The fixture runs it in a process
    of its own, beside the port's runs."""
    test = federation()[3]
    out = {}
    for name, kind in jax_runs:
        j = _jax_engine(name, kind)
        out[name, kind] = (jax_scenario(j, test, inputs[name, kind], kind),
                           j.assignment.members)
    return out




def _assert_results_match(got, want):
    for k, v in want.items():
        if k == "replicas":
            continue
        if k == "history":                        # -loss curves
            assert got[k].keys() == v.keys()
            for lvl in v:
                _close(got[k][lvl], v[lvl])
        else:
            assert np.shape(got[k]) == np.shape(v), k
            _close(got[k], v)


@functools.lru_cache(maxsize=None)
def _unsharded_grads(name, level):
    """The family, its parameters and the unsharded member gradients of a
    case (shared by the case's meshes)."""
    fam, p, stack, toks = grad_inputs(name, level)
    return fam, p, member_grads(fam, level, stack, toks)


def suite(families=(), grad_cases=(), jax_runs=(), meshes=None) -> dict:
    """One file's fixture and tests: the dispatch runs of ``families``
    (names of ``FAMILIES``) on ``meshes`` (all of theirs by default) with
    JAX's single-device runs ``jax_runs`` ((family, kind) pairs), and the
    member-gradient cases ``grad_cases`` ((configuration, level) pairs) on
    ``GRAD_MESHES``.  A file puts the returned names in its globals."""
    families, jax_runs = tuple(families), tuple(jax_runs)
    runs_list = [r for r in RUNS if r[0] in families
                 and (meshes is None or r[1] in meshes)]
    grads_list = [(name, level, shape) for name, level in grad_cases
                  for shape in GRAD_MESHES]
    moe_grads = [c for c in grads_list if config(c[0]).n_experts]

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """{(family, kind): [JAX result, unsharded port result, unsharded
        capacities]} and the ranks' results.  JAX's engines run in a
        spawned process from the start; the unsharded port runs record
        JAX's draws, then the rank world runs."""
        engines, init_trees, draws, inputs, ref = {}, {}, {}, {}, {}
        for name in families:
            for kind in KINDS:
                t, test = engines[name, kind] = make_engine(
                    RecordingBridgedFedRAC, name, kind)
                assert all(t.assignment.members[lvl] for lvl in (0, 1))
                inputs[name, kind] = (
                    jax_inputs(JaxDraws(t, _jax_family(name)))
                    if kind == "buffered" else {})
        with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
            jax_done = (pool.submit(_jax_results, inputs, jax_runs)
                        if jax_runs else None)
            for name in families:
                draws[name] = InjectedFedRAC.draws = {}
                for kind in KINDS:
                    t, test = engines[name, kind]
                    init_trees[name] = InjectedFedRAC.init_trees = {
                        lvl: jax.tree.map(np.asarray, _jax_family(name).init(
                            jax.random.PRNGKey(SEED + lvl), lvl))
                        for lvl in range(t.m)}
                    ref[name, kind] = [
                        None, scenario(t, test, inputs[name, kind], kind),
                        {lvl: t._capacity(len(m))
                         for lvl, m in t.assignment.members.items()},
                        t.assignment.members]
            results = start_world(tp_families_rank,
                                  tmp_path_factory.mktemp("tp_families"),
                                  init_trees, draws, inputs,
                                  tuple(grad_cases), runs_list, world=4)
            if jax_done is not None:
                for key, (res, members) in jax_done.result().items():
                    assert members == ref[key][3]
                    ref[key][0] = res
        return ref, results()

    @pytest.mark.parametrize("name,level,shape", grads_list)
    def test_tp_member_grads_match_unsharded(runs, name, level, shape):
        m = int(shape.split("x")[1])
        fam, p, g = _unsharded_grads(name, level)
        spec = make_tp_plane_spec(p, fam.param_specs(level, p, m, "model"),
                                  msize=m)
        assert any(k is not None for _, _, k, _, _ in spec.recs)
        want = spec.to_plane(g).reshape(2, m, spec.d_loc)
        for rank, res in enumerate(runs[1]):
            _close(res[(name, level, shape)][0], want[:, rank % m])

    @pytest.mark.parametrize("name,level,shape", moe_grads)
    def test_tp_routing_matches_unsharded_or_near_tie(runs, name, level,
                                                      shape):
        """Every rank's routers choose the unsharded forward's experts,
        except where the k-th and (k+1)-th probabilities lie within
        ``NEAR_TIE``."""
        _, p, _, toks = grad_inputs(name, level)
        want = level_routing(name, level, p, toks[0])
        assert want
        for res in runs[1]:
            got = res[(name, level, shape)][1]
            assert len(got) == len(want)
            for (gi, _), (wi, gap) in zip(got, want):
                flipped = (np.sort(gi, -1) != np.sort(wi, -1)).any(-1)
                assert (gap[flipped] < NEAR_TIE).all(), gap[flipped]

    @pytest.mark.parametrize("name,shape,kind", runs_list)
    def test_tp_dispatch_matches_unsharded(runs, name, shape, kind):
        ref, ranks = runs
        for r in ranks:
            _assert_results_match(r[(name, shape, kind)], ref[name, kind][1])

    @pytest.mark.parametrize("name,kind", jax_runs)
    def test_unsharded_port_matches_jax(runs, name, kind):
        ref, _ = runs
        _assert_results_match(ref[name, kind][1], ref[name, kind][0])

    @pytest.mark.parametrize("name,shape,kind", runs_list)
    def test_replicated_copies_stay_bit_equal(runs, name, shape, kind):
        """Every rank computes the same bits for a whole leaf's gradient,
        so its copies in the TP plane's chunks never part."""
        for r in runs[1]:
            rep = r[(name, shape, kind)]["replicas"]
            assert rep and all(rep)

    @pytest.mark.parametrize("name,shape,kind", runs_list)
    def test_fedagg_on_each_rank_block(runs, name, shape, kind):
        """fedagg runs once a round (twice in a banked round) on each
        rank's (C/n, d_loc) block."""
        ref, ranks = runs
        n = int(shape.split("x")[0])
        for r in ranks:
            res = r[(name, shape, kind)]
            want = []
            for lvl in (0, 1):
                cap = res["capacity"][lvl]
                assert cap == -(-ref[name, kind][2][lvl] // n) * n
                want += ([(cap // n, res["d_loc"][lvl])] * CFG["rounds"]
                         * (2 if kind == "buffered" else 1))
            assert res["fedagg"] == want

    out = {"runs": runs}
    if grads_list:
        out["test_tp_member_grads_match_unsharded"] = (
            test_tp_member_grads_match_unsharded)
    if moe_grads:
        out["test_tp_routing_matches_unsharded_or_near_tie"] = (
            test_tp_routing_matches_unsharded_or_near_tie)
    if runs_list:
        out.update(
            test_tp_dispatch_matches_unsharded=(
                test_tp_dispatch_matches_unsharded),
            test_replicated_copies_stay_bit_equal=(
                test_replicated_copies_stay_bit_equal),
            test_fedagg_on_each_rank_block=test_fedagg_on_each_rank_block)
    if jax_runs:
        out["test_unsharded_port_matches_jax"] = (
            test_unsharded_port_matches_jax)
    return out
