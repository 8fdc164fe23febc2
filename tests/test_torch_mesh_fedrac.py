"""Port parity for Fed-RAC on a mesh: the member-sharded dispatch path on
8 gloo ranks, meshes 8×1 and 4×2 (the latter with ``tp_forward=False``:
plane columns split along ``model`` and gathered each round), against the
unsharded port run and JAX's single-device dispatch run.

The federation is a small ``mlp_family`` one (10 participants, a master
and a slave cluster whose member counts do not divide 8 or 4) at R = 2:
"sync" is ``FedRAC.train()`` (FedAvg blocks, the slave under a fixed KD
teacher), "buffered" one banked block per level (the slave on a per-round
teacher stack).  Every run starts from JAX's parameter draw and takes
JAX's batch-index draws, recorded from the unsharded run (the
``StreamBridgedFedRAC`` trick).  JAX's own mesh path is not the oracle: it
fails under JAX 0.9.0 (ROADMAP C2).  Tolerance rtol 2e-4 / atol 1e-5;
accuracy curves within one test sample.  ``sim_run --mesh-shape 4`` is
held to the unsharded launcher's report, and the 4×2 mesh with the
tensor-parallel forward (``tp_forward=True``) to the unsharded run.
"""
import jax
import numpy as np
import pytest

from repro.core import server as j_srv
from repro.core.families import mlp_family as j_mlp_family
from repro.core.resources import participants_from_matrix as j_parts

from _torch_mesh_common import (CFG, MESHES, InjectedFedRAC, federation,
                                fedrac_rank, make_engine, run_world,
                                scenario)
from _torch_mesh_jax import RecordingBridgedFedRAC
from _torch_mesh_jax import jax_inputs as _inputs
from _torch_mesh_jax import jax_scenario as _jax_scenario
from _torch_sim_common import host_rows
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sim_run

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
KINDS = ("sync", "buffered")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def _jax_engine(kind):
    V, n_data, cd, test = federation()
    j = j_srv.FedRAC(j_parts(V, n_data=n_data), cd, j_mlp_family(),
                     j_srv.FLConfig(**dict(CFG, aggregation=kind,
                                           donate_plane=False)),
                     classes=10).setup()
    return j, test


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: (JAX result, unsharded port result)}, the mesh ranks'
    results, and the test-set size."""
    InjectedFedRAC.draws = {}
    ref = {}
    for kind in KINDS:
        j, test = _jax_engine(kind)
        InjectedFedRAC.init_trees = {
            lvl: jax.tree.map(np.asarray, j.family.init(
                jax.random.PRNGKey(j.cfg.seed + lvl), lvl))
            for lvl in range(j.m)}
        inputs = _inputs(j)
        t, _ = make_engine(RecordingBridgedFedRAC, kind)
        assert t.assignment.members == j.assignment.members
        ref[kind] = (_jax_scenario(j, test, inputs, kind),
                     scenario(t, test, inputs, kind),
                     {lvl: t._capacity(len(m)) for lvl, m in
                      t.assignment.members.items()})
    ranks = run_world(fedrac_rank, tmp_path_factory.mktemp("fedrac"),
                      InjectedFedRAC.init_trees, dict(InjectedFedRAC.draws),
                      inputs)
    return ref, ranks, len(test["y"])


def _assert_results_match(got, want, n_test):
    for k, v in want.items():
        if k == "history":
            assert got[k].keys() == v.keys()
            for lvl in v:
                np.testing.assert_allclose(got[k][lvl], v[lvl], rtol=0,
                                           atol=1.0 / n_test + 1e-9)
        else:
            assert np.shape(got[k]) == np.shape(v), k
            _close(got[k], v)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("against", ["unsharded", "jax"])
def test_mesh_fedrac_matches(runs, mesh, kind, against):
    ref, ranks, n_test = runs
    want = ref[kind][1] if against == "unsharded" else ref[kind][0]
    _assert_results_match(ranks[0][(mesh, kind)], want, n_test)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_rank_ends_with_the_same_result(runs, mesh, kind):
    _, ranks, _ = runs
    first = ranks[0][(mesh, kind)]
    for r in ranks[1:]:
        for k, v in first.items():
            if k not in ("fedagg", "history", "capacity", "d_pad"):
                np.testing.assert_array_equal(r[(mesh, kind)][k], v)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_fedagg_runs_on_each_rank_block(runs, mesh, kind):
    """Each rank runs fedagg as often as the unsharded engine does (once a
    round, twice in a banked round), always on its (C/n, D/m) block: the
    mesh capacity is the unsharded one rounded up to the data ranks, and
    the plane pads to a multiple of 128 · m."""
    ref, ranks, _ = runs
    n, m = t_mesh.parse_sim_mesh_shape(mesh)
    for r in ranks:
        res = r[(mesh, kind)]
        cap_t = ref[kind][2]
        for lvl, cap in res["capacity"].items():
            assert cap == -(-cap_t[lvl] // n) * n
            assert res["d_pad"][lvl] % (128 * m) == 0
        rounds = {lvl: (CFG["rounds"] if kind == "sync" else 2)
                  for lvl in (0, 1)}
        want = []
        for lvl in (0, 1):
            block = (res["capacity"][lvl] // n, res["d_pad"][lvl] // m)
            want += [block] * rounds[lvl] * (2 if kind == "buffered" else 1)
        assert res["fedagg"] == want


def test_2d_mesh_refuses_the_tp_forward(runs):
    """The 4×2 mesh with ``tp_forward=True`` (JAX's default), once
    refused, now trains on TP-layout planes with the member forward split
    over ``model``, and matches the unsharded run (the name is kept from
    when the test held the refusal)."""
    ref, ranks, n_test = runs
    for r in ranks:
        assert r["tp_forward"]
        _assert_results_match(r["tp"], ref["sync"][1], n_test)


_SIM_ARGS = ["--trace", "mixed", "--mar-policy", "buffer",
             "--rounds-per-dispatch", "4", "--rounds", "4",
             "--participants", "8", "--samples", "600", "--base-width",
             "0.125", "--device", "cpu"]


def test_sim_run_mesh_gives_the_unsharded_report(tmp_path):
    """``sim_run --mesh-shape 4`` starts its 4 ranks itself; rank 0's
    report (written once) reads as the unsharded launcher's."""
    rep = sim_run.main(_SIM_ARGS + ["--report-out", str(tmp_path / "u")])
    rep_m = sim_run.main(_SIM_ARGS + ["--mesh-shape", "4", "--report-out",
                                      str(tmp_path / "m")])
    assert host_rows(rep_m) == host_rows(rep)
    for ru, rm in zip(rep.rows, rep_m.rows):
        for cu, cm in zip(ru.clusters, rm.clusters):
            np.testing.assert_allclose(cm.mean_loss, cu.mean_loss,
                                       rtol=RTOL, atol=ATOL)
    assert rep_m.final_acc.keys() == rep.final_acc.keys()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m", "u"]
