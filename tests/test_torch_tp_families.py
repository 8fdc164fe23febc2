"""Port parity for the tensor-parallel member forward of the MoE, hybrid
Mamba, xLSTM and enc-dec families (``tp_forward=True`` on a 2D mesh): one
spawn of 4 gloo ranks holds the meshes 1x2 (two replicas side by side),
2x2 and 1x4 (``_torch_tp_families_common``), on smoke configurations.

* Member gradients, on 1x2 and 1x4 (2x2's model axis is 1x2's): under
  ``vmap(grad)`` over 2 members, each rank's gradients under the TP
  forward equal its chunk of the unsharded ones, for granite-moe (dense
  and capacity dispatch, ``moe_shard`` "tp" and "ep", capacity groups
  run in chunks; level 1's 2 experts fall back to the d_ff split at a
  model axis of 4), jamba (Mamba, attention, a dense and an MoE FFN),
  xlstm-350m (mLSTM on its scan and chunk routes, sLSTM; with 2 heads
  the split does not fall on heads at 4) and seamless-m4t-medium's FL
  build (decoder-only).  Every router makes the unsharded forward's
  top-k choices, or differs only at a near-tie.
* The dispatch path: "sync" (``train()``) and "buffered" (a banked block
  per level) runs of granite-moe (capacity dispatch that drops tokens;
  1x2, 2x2, 1x4), jamba and xlstm-350m (1x2), each mesh run held to
  the port's unsharded engine, and that engine to JAX's single-device
  path on JAX's parameter and batch-index draws (``JAX_RUNS``; JAX's
  mesh path fails under JAX 0.9.0, ROADMAP C2).  Every whole leaf's
  copies in a TP plane stay bit-equal across the chunks (routers, norms,
  ``w_if`` / ``b_if``, ``r``, ``b``); fedagg runs on each rank's (C/n,
  d_loc) block as often as the unsharded engine.

Tolerance rtol 2e-4 / atol 1e-5 in fp32.
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
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_common import CFG, KINDS, scenario
from _torch_tp_families_common import (CONFIGS, FAMILIES, GRAD_CASES,
                                       GRAD_MESHES, RUNS, SEED,
                                       config, federation, grad_inputs,
                                       level_routing, make_engine,
                                       member_grads, tp_families_rank)
from repro_torch.core.plane import make_tp_plane_spec
from repro_torch.core.scaling import compress_config
from repro_torch.core.tree import tree_map
from repro_torch.models import moe, tp

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
# the unsharded runs held to JAX's: granite-moe's both kinds, jamba's and
# xlstm-350m's banked block (JAX's engines take most of the file's time)
JAX_RUNS = (("granite", "sync"), ("granite", "buffered"),
            ("jamba", "buffered"), ("xlstm", "buffered"))
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


def _jax_results(inputs):
    """JAX's single-device run of each of ``JAX_RUNS``: {(family, kind):
    (result, the assignment's members)}.  The fixture runs it in a process
    of its own, beside the port's runs."""
    test = federation()[3]
    out = {}
    for name, kind in JAX_RUNS:
        j = _jax_engine(name, kind)
        out[name, kind] = (jax_scenario(j, test, inputs[name, kind], kind),
                           j.assignment.members)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(family, kind): [JAX result, unsharded port result, unsharded
    capacities]} and the ranks' results.  JAX's engines run in a spawned
    process from the start; the unsharded port runs record JAX's draws,
    then the rank world runs."""
    engines, init_trees, draws, inputs, ref = {}, {}, {}, {}, {}
    for name in FAMILIES:
        for kind in KINDS:
            t, test = engines[name, kind] = make_engine(
                RecordingBridgedFedRAC, name, kind)
            assert all(t.assignment.members[lvl] for lvl in (0, 1))
            inputs[name, kind] = (jax_inputs(JaxDraws(t, _jax_family(name)))
                                  if kind == "buffered" else {})
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        jax_runs = pool.submit(_jax_results, inputs)
        for name in FAMILIES:
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
                              init_trees, draws, inputs, world=4)
        for key, (res, members) in jax_runs.result().items():
            assert members == ref[key][3]
            ref[key][0] = res
    return ref, results()


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


GRADS = [(name, level, shape) for name, level in GRAD_CASES
         for shape in GRAD_MESHES]


@pytest.mark.parametrize("name,level,shape", GRADS)
def test_tp_member_grads_match_unsharded(runs, name, level, shape):
    m = int(shape.split("x")[1])
    fam, p, g = _unsharded_grads(name, level)
    spec = make_tp_plane_spec(p, fam.param_specs(level, p, m, "model"),
                              msize=m)
    assert any(k is not None for _, _, k, _, _ in spec.recs)
    want = spec.to_plane(g).reshape(2, m, spec.d_loc)
    for rank, res in enumerate(runs[1]):
        _close(res[(name, level, shape)][0], want[:, rank % m])


MOE_GRADS = [c for c in GRADS if config(c[0]).n_experts]


@pytest.mark.parametrize("name,level,shape", MOE_GRADS)
def test_tp_routing_matches_unsharded_or_near_tie(runs, name, level, shape):
    """Every rank's routers choose the unsharded forward's experts, except
    where the k-th and (k+1)-th probabilities lie within ``NEAR_TIE``."""
    _, p, _, toks = grad_inputs(name, level)
    want = level_routing(name, level, p, toks[0])
    assert want
    for res in runs[1]:
        got = res[(name, level, shape)][1]
        assert len(got) == len(want)
        for (gi, _), (wi, gap) in zip(got, want):
            flipped = (np.sort(gi, -1) != np.sort(wi, -1)).any(-1)
            assert (gap[flipped] < NEAR_TIE).all(), gap[flipped]


def test_tp_operations_without_a_context_return_their_input():
    """With no TP context every operation the mixers call returns its
    input (the product's bits for ``linear_whole``), so the single-device
    forward is unchanged."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 4, 8, generator=g), torch.randn(8, 6, generator=g)
    for partial in (False, True):
        assert tp.whole(x, 8, partial=partial) is x
        assert torch.equal(tp.linear_whole(x, w, 6, partial), x @ w)
    assert tp.own(x) is x
    for op in (tp.copy_to_tp, tp.reduce_from_tp, tp.max_from_tp,
               tp.gather_from_tp, tp.scatter_to_tp):
        assert op(x) is x


def test_expert_parallel_falls_back_to_the_ff_split():
    """granite level 1 holds 2 experts: "ep" splits them at a model axis
    of 2, and at 4 falls back to each expert's d_ff slice; the router
    stays whole."""
    fam, p, _, _ = grad_inputs("granite-ep", 1)
    cfg = compress_config(config("granite-ep"), 0.5, 1)
    assert cfg.n_experts == 2
    w_gate = p["blocks"]["p0"]["ffn"]["w_gate"]          # (1, E, d, f)
    for m, dim, split in ((2, 1, "ep"), (4, 3, "f")):
        spec = fam.param_specs(1, p, m, "model")["blocks"]["p0"]["ffn"]
        assert spec["w_gate"] == {"model": dim} and spec["router"] == {}
        loc = w_gate[0].narrow(dim - 1, 0, w_gate.shape[dim] // m)
        assert moe.expert_split({"w_gate": loc}, cfg) == split


def test_the_federation_drops_tokens():
    """granite's capacity dispatch keeps fewer routing choices than it
    makes on the federation's windows (their embeddings as the input)."""
    name = FAMILIES["granite"]
    V, n_data, cd, _ = federation()
    toks = torch.as_tensor(cd[0]["tokens"][:4])
    for level in (0, 1):
        cfg = compress_config(config(name), 0.5, level)
        fam, p, _, _ = grad_inputs(name, level)
        x = torch.nn.functional.embedding(toks, p["embed"])
        kept, made = moe.kept_choices(
            tree_map(lambda t: t[0], p["blocks"]["p0"]["ffn"]), cfg, x)
        assert kept < made


@pytest.mark.parametrize("name,shape,kind", RUNS)
def test_tp_dispatch_matches_unsharded(runs, name, shape, kind):
    ref, ranks = runs
    for r in ranks:
        _assert_results_match(r[(name, shape, kind)], ref[name, kind][1])


@pytest.mark.parametrize("name,kind", JAX_RUNS)
def test_unsharded_port_matches_jax(runs, name, kind):
    ref, _ = runs
    _assert_results_match(ref[name, kind][1], ref[name, kind][0])


@pytest.mark.parametrize("name,shape,kind", RUNS)
def test_replicated_copies_stay_bit_equal(runs, name, shape, kind):
    """Every rank computes the same bits for a whole leaf's gradient, so
    its copies in the TP plane's chunks never part."""
    for r in runs[1]:
        rep = r[(name, shape, kind)]["replicas"]
        assert rep and all(rep)


@pytest.mark.parametrize("name,shape,kind", RUNS)
def test_fedagg_on_each_rank_block(runs, name, shape, kind):
    """fedagg runs once a round (twice in a banked round) on each rank's
    (C/n, d_loc) block."""
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
