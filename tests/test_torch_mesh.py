"""Port parity for the member-sharded mesh pieces: the sharded aggregation
ops on 8 gloo ranks (meshes 8×1 and 4×2, member and column counts that do
not divide), ``pad_member_rows``, ``plane_specs``, ``make_plane_spec``'s
model-axis padding, ``parse_sim_mesh_shape`` and the mesh contract.  This
mirrors the op suite of ``tests/test_mesh_plane.py`` (whose eight-way
cases need JAX's mesh path, which fails under JAX 0.9.0): the reference is
the unsharded ``aggregate_plane`` of both packages.

Every rank returns the global result; all ranks must agree bit for bit,
and with the reference at rtol 1e-5 / atol 1e-6 (the op suite's own
tolerance: a sum over ranks adds in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import aggregation as j_agg
from repro.core import plane as j_plane
from repro.launch import mesh as j_mesh

from _torch_mesh_common import MESHES, op_inputs, ops_rank, run_world
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import aggregation as t_agg
from repro_torch.core import plane as t_plane
from repro_torch.launch import mesh as t_mesh

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 1e-5, 1e-6
# (C, D, seed): 13 rows on 8 and 4 data ranks, 257 columns on 2 model ranks
CASES = ((13, 384, 2), (5, 257, 4), (8, 512, 5))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world(ops_rank, tmp_path_factory.mktemp("ops"), CASES)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"C{c[0]}xD{c[1]}")
def test_sharded_plane_ops_match_unsharded_and_jax(ranks, mesh, case):
    C, D, seed = case
    plane, w, stack = op_inputs(C, D, seed)
    want_t = t_agg.aggregate_plane(torch.tensor(plane), torch.tensor(w))
    want_j = j_agg.aggregate_plane(jnp.asarray(plane), jnp.asarray(w))
    got = [r[(mesh, C, D)] for r in ranks]
    for g in got[1:]:                     # every rank holds the same result
        for k in ("aggregate", "delta", "merge", "zero_delta"):
            np.testing.assert_array_equal(g[k], got[0][k])
    g = got[0]
    assert g["aggregate"].shape == (D,)
    _close(g["aggregate"], want_t)
    _close(g["aggregate"], want_j)
    _close(g["delta"], np.asarray(want_j) - plane[0])
    _close(g["merge"], want_j)
    np.testing.assert_array_equal(g["zero_delta"], 0.0)
    tree_j = j_agg.aggregate(jax.tree.map(jnp.asarray, stack),
                             jnp.asarray(w))
    for k in ("w", "b"):
        _close(g["tree"][k], tree_j[k])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"C{c[0]}xD{c[1]}")
def test_each_rank_contracts_its_block_with_fedagg(ranks, mesh, case):
    """One fedagg call per rank, on its (C/n, D/m) block: rows padded to a
    multiple of the data ranks, columns to a multiple of the model ranks."""
    C, D, _ = case
    n, m = t_mesh.parse_sim_mesh_shape(mesh)
    want = (-(-C // n), -(-D // m))
    for r in ranks:
        assert r[(mesh, C, D)]["shapes"] == [want]


def test_mesh_requires_dispatch_pipeline(ranks):
    for r in ranks:
        assert "rounds_per_dispatch>1" in r["refused"]


def test_data_axes(ranks):
    for r in ranks:
        assert r["data_axes"] == ("data",)


def test_pad_member_rows_matches_jax():
    rng = np.random.default_rng(0)
    plane = rng.standard_normal((5, 128)).astype(np.float32)
    w = np.asarray(j_agg.normalized_weights([3, 1, 4, 1, 5]))
    pj, wj = j_plane.pad_member_rows(jnp.asarray(plane), jnp.asarray(w), 8)
    pt, wt = t_plane.pad_member_rows(torch.tensor(plane), torch.tensor(w), 8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    _close(t_agg.aggregate_plane(pt, wt),
           t_agg.aggregate_plane(torch.tensor(plane), torch.tensor(w)))
    with pytest.raises(ValueError, match="cannot pad"):
        t_plane.pad_member_rows(torch.tensor(plane), torch.tensor(w), 3)


def _spec_of(pspec):
    """A JAX PartitionSpec as the port's {axis: dim} spec."""
    return {a: d for d, a in enumerate(pspec) if a is not None}


@pytest.mark.parametrize("model_axis", [None, "model"])
def test_plane_specs_match_jax(model_axis):
    pj = j_plane.plane_specs("data", model_axis)
    pt = t_plane.plane_specs("data", model_axis)
    assert pt.keys() == pj.keys()
    for k, spec in pj.items():
        assert isinstance(spec, P)
        assert pt[k] == _spec_of(spec), k


@pytest.mark.parametrize("model_size", [1, 2, 4, 3])
def test_plane_spec_model_padding_matches_jax(model_size):
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((17, 9)).astype(np.float32),
            "b": rng.standard_normal((9,)).astype(np.float32)}
    sj = j_plane.make_plane_spec(jax.tree.map(jnp.asarray, tree),
                                 model_size=model_size)
    st = t_plane.make_plane_spec({k: torch.tensor(v)
                                  for k, v in tree.items()},
                                 model_size=model_size)
    assert (st.d, st.d_pad) == (sj.d, sj.d_pad)
    assert st.d_pad % (t_plane.PLANE_ALIGN * model_size) == 0


@pytest.mark.parametrize("shape", [
    "8", "8x1", "4x2", "4×2", "1", 8, (4, 2), (2,), "2x2x2", "0", (0, 1),
    "4x0"])
def test_parse_sim_mesh_shape_matches_jax(shape):
    try:
        want = j_mesh.parse_sim_mesh_shape(shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_mesh.parse_sim_mesh_shape(shape)
        assert str(got.value) == str(e)
    else:
        assert t_mesh.parse_sim_mesh_shape(shape) == want


def test_mesh_shape_descriptions():
    assert t_mesh.host_mesh_shape(1, 1) == {"data": 1, "model": 1}
    assert t_mesh.default_backend("cpu", 8) == "gloo"
