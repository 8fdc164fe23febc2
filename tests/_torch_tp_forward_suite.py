"""The fixture and tests of the tensor-parallel member forward of the
MLP, CNN and small dense LM families, shared by ``test_torch_tp_forward*.py``:
each file takes the cases of its meshes (``suite``) and spawns its own
world of 4 gloo ranks, so that no one rank world carries every mesh.
``tests/test_torch_tp_forward.py``'s docstring describes the tests.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import families as j_families
from repro.core import server as j_srv
from repro.core.resources import participants_from_matrix as j_parts

from _torch_mesh_common import InjectedFedRAC, federation, start_world
from _torch_mesh_jax import (JaxDraws, JTokenFedRAC, RecordingBridgedFedRAC,
                             jax_inputs, jax_scenario)
from _torch_tp_common import (CFG, FAMILIES, KINDS, LM, LM_GRAD_CASES, SEED,
                              RecordingPortFedRAC, engine_cls,
                              lm_federation, lm_grad_inputs, lm_member_grads,
                              make_engine, op_inputs, op_loss, scenario,
                              tp_rank)
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plane import make_tp_plane_spec
from repro_torch.models.attention import _local_kv_heads

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
# the (family, kind) runs whose unsharded port run is held to JAX's (in
# one file each): the LM's.  The unsharded engine is held to JAX's on the
# MLP in test_torch_mesh_fedrac.py and on the CNN in test_torch_fedrac.py
# and test_torch_sim_dispatch.py, so the CNN and MLP runs here, held to
# the unsharded port only, take the port's own draws
JAX_RUNS = (("lm", "sync"), ("lm", "buffered"))


def _kinds(name):
    return ("sync",) if name == "cnn-odd" else KINDS


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def _jax_family(name):
    if name == "lm":
        return j_families.lm_family(
            JModelConfig(**dict(LM, attn_impl="jnp")), 0.5)
    if name == "mlp":
        return j_families.mlp_family()
    return j_families.cnn_family(base_width=0.0625 if name == "cnn" else 0.1)


def _jax_engine(name, kind):
    V, n_data, cd, test = (lm_federation() if name == "lm"
                           else federation())
    cls, classes = (JTokenFedRAC, 64) if name == "lm" else (j_srv.FedRAC, 10)
    cfg = j_srv.FLConfig(**dict(CFG, aggregation=kind, donate_plane=False,
                                class_balanced=name != "lm"))
    return cls(j_parts(V, n_data=n_data), cd, _jax_family(name), cfg,
               classes=classes).setup()


def _assert_results_match(got, want, n_test, name):
    for k, v in want.items():
        if k == "replicas":
            continue
        if k == "history":
            assert got[k].keys() == v.keys()
            for lvl in v:
                if name == "lm":               # -loss curves
                    _close(got[k][lvl], v[lvl])
                else:                          # accuracies
                    np.testing.assert_allclose(got[k][lvl], v[lvl], rtol=0,
                                               atol=1.0 / n_test + 1e-9)
        else:
            assert np.shape(got[k]) == np.shape(v), k
            _close(got[k], v)


def suite(meshes, jax_runs=(), moe=False) -> dict:
    """One file's fixture and tests: the dispatch runs, the operations'
    and the LM's member gradients on ``meshes``, JAX's single-device runs
    ``jax_runs`` ((family, kind) pairs of ``JAX_RUNS``), and with ``moe``
    how an MoE engine builds on 1x2.  A file puts the returned names in
    its globals."""
    meshes, jax_runs = tuple(meshes), tuple(jax_runs)
    families = [n for n, shapes in FAMILIES.items()
                if set(shapes) & set(meshes)]
    cases = [(name, shape, kind) for name in families
             for shape in FAMILIES[name] if shape in meshes
             for kind in _kinds(name)]

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        """{(family, kind): (JAX result, unsharded port result, unsharded
        capacities)}, the ranks' results, and the test-set sizes.  The
        unsharded port runs record JAX's draws; the rank world then runs
        while JAX's engines run here."""
        init_trees, draws, inputs, ref = {}, {}, {}, {}
        n_test, tests = {}, {}
        for name in families:
            draws[name] = InjectedFedRAC.draws = {}
            # JAX's draws where JAX's run is held here, else the port's own
            jax_side = name in {n for n, _ in JAX_RUNS}
            for kind in _kinds(name):
                t, test = make_engine(engine_cls(
                    name, RecordingBridgedFedRAC if jax_side
                    else RecordingPortFedRAC), name, kind)
                assert all(t.assignment.members[lvl] for lvl in (0, 1))
                init_trees[name] = InjectedFedRAC.init_trees = {
                    lvl: (jax.tree.map(np.asarray, _jax_family(name).init(
                        jax.random.PRNGKey(SEED + lvl), lvl)) if jax_side
                          else interop.params_to_numpy(t.family.init(
                              torch.Generator().manual_seed(SEED + lvl),
                              lvl)))
                    for lvl in range(t.m)}
                inputs[name, kind] = (
                    jax_inputs(JaxDraws(t, _jax_family(name)))
                    if kind == "buffered" else {})
                ref[name, kind] = [
                    None, scenario(t, test, inputs[name, kind], kind),
                    {lvl: t._capacity(len(m))
                     for lvl, m in t.assignment.members.items()},
                    t.assignment.members]
                tests[name] = test
            n_test[name] = len(next(iter(test.values())))
        results = start_world(tp_rank, tmp_path_factory.mktemp("tp"),
                              init_trees, draws, inputs, meshes, moe,
                              world=4)
        for name, kind in jax_runs:
            j = _jax_engine(name, kind)
            assert j.assignment.members == ref[name, kind][3]
            ref[name, kind][0] = jax_scenario(j, tests[name],
                                              inputs[name, kind], kind)
        return ref, results(), n_test

    @pytest.mark.parametrize("name,shape,kind", cases)
    def test_tp_forward_matches_unsharded(runs, name, shape, kind):
        ref, ranks, n_test = runs
        for r in ranks:
            _assert_results_match(r[(name, shape, kind)], ref[name, kind][1],
                                  n_test[name], name)


    @pytest.mark.parametrize("name,kind", jax_runs)
    def test_unsharded_port_matches_jax(runs, name, kind):
        ref, _, n_test = runs
        _assert_results_match(ref[name, kind][1], ref[name, kind][0],
                              n_test[name], name)


    @pytest.mark.parametrize("name,shape,kind", cases)
    def test_replicated_copies_stay_bit_equal(runs, name, shape, kind):
        """Every rank computes the same bits for a whole leaf's gradient, so
        its copies in the TP plane's chunks never part."""
        _, ranks, _ = runs
        for r in ranks:
            rep = r[(name, shape, kind)]["replicas"]
            assert rep and all(rep)


    @pytest.mark.parametrize("name,shape,kind", cases)
    def test_fedagg_on_each_rank_block_and_no_plane_gather(runs, name, shape,
                                                           kind):
        """fedagg runs once a round (twice in a banked round) on each rank's
        (C/n, d_loc) block; the model axis gathers only the block's outputs
        at its end (the plane, and the history and bank when asked), never
        the plane's columns for a round."""
        ref, ranks, _ = runs
        n, m = (int(x) for x in shape.split("x"))
        rounds = CFG["rounds"]
        for r in ranks:
            res = r[(name, shape, kind)]
            want = []
            for lvl in (0, 1):
                cap = res["capacity"][lvl]
                assert cap == -(-ref[name, kind][2][lvl] // n) * n
                want += ([(cap // n, res["d_loc"][lvl])] * rounds
                         * (2 if kind == "buffered" else 1))
            assert res["fedagg"] == want
            # one block per level, which gathers its plane and history (and,
            # buffered, its bank)
            blocks, outputs = 2, 3 if kind == "buffered" else 2
            assert len(res["model_gathers"]) == blocks * outputs


    @pytest.mark.parametrize("shape", meshes)
    def test_tp_ops_match_unsharded_gradients(runs, shape):
        _, ranks, _ = runs
        x, w1, w2 = op_inputs()
        g1, g2 = torch.func.vmap(torch.func.grad(op_loss, argnums=(0, 1)))(
            w1, w2, x)
        n, m = (int(v) for v in shape.split("x"))
        k = w1.shape[-1] // m
        for rank, res in enumerate(ranks):
            r = rank % m
            got1, got2, mx = res[("ops", shape)]
            _close(got1, g1[..., r * k:(r + 1) * k])
            _close(got2, g2[:, r * k:(r + 1) * k])
            np.testing.assert_array_equal(mx, (x + (m - 1)).numpy())


    @pytest.mark.parametrize("case", LM_GRAD_CASES)
    @pytest.mark.parametrize("shape", meshes)
    def test_tp_lm_member_grads_match_unsharded(runs, case, shape):
        """Each rank's member gradients under the TP forward equal its chunk
        of the unsharded ones.  "remat": ``Recompute`` wraps the split
        superblock and its collectives.  "heads": 6 query heads over 3 K/V
        heads; at a model axis of 2 each rank's query groups straddle the K/V
        heads (gathered, then read by an index list), at 4 the query heads do
        not split (the attention runs whole, its output sliced for the
        row-parallel wo)."""
        m = int(shape.split("x")[1])
        if case == "heads":
            cfg = ModelConfig(**dict(LM, **LM_GRAD_CASES[case]))
            assert cfg.q_dim % m == 0 and cfg.kv_dim % m == 0
            if m == 2:
                assert cfg.n_kv_heads % m and all(
                    isinstance(_local_kv_heads(cfg, cfg.n_heads // m, r), list)
                    for r in range(m))
            else:
                assert cfg.n_heads % m
        fam, p, stack, toks = lm_grad_inputs(case)
        g = lm_member_grads(fam, stack, toks)
        spec = make_tp_plane_spec(p, fam.param_specs(0, p, m, "model"),
                                  msize=m)
        want = spec.to_plane(g).reshape(2, m, spec.d_loc)
        for rank, res in enumerate(runs[1]):
            _close(res[(case, shape)], want[:, rank % m])

    def test_moe_family_builds_on_1x2_both_ways(runs):
        _, ranks, _ = runs
        for r in ranks:
            assert r[("moe", True)] == (True, "TPPlaneSpec")
            assert r[("moe", False)] == (False, "PlaneSpec")

    out = {name: obj for name, obj in locals().items()
           if name == "runs" or name.startswith("test_")}
    if not jax_runs:
        out.pop("test_unsharded_port_matches_jax")
    if not moe:
        out.pop("test_moe_family_builds_on_1x2_both_ways")
    return out
