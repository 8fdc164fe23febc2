"""The compile analysis (``launch.dryrun``, ``launch.hlo_analysis``) at
smoke size on the CPU.

* The fake world's collective record equals a real world's: each program
  (train, prefill, KD and decode on the "hd" cache on OLMo's smoke
  config; train, decode on the "batch" cache and the FL round on
  granite-moe's) is analysed on fake tensors in a fake world of 2 ranks,
  then run on real tensors by 2 gloo ranks, on the meshes 1x2 and 2x1;
  every rank's record of (function, axis, bytes) equals the fake rank's,
  call for call.  Both sides run in spawned processes, so no process
  group is left in the test worker.  A rank's decode logits and caches
  equal its block of the one-device decode's (atol 1e-5, fp32: the
  tensor-parallel decode sums the same products in another order).
* A dense arch's counted FLOPs against ``core.scaling.analytic_step_flops``
  (relative tolerance 1e-9, stated below with what the analytic count
  leaves out), and the depth extrapolation of ``analyze`` equal to the
  full count for flops, bytes and collective bytes.
* ``run_one``'s JSON keys are JAX's (``src/repro/launch/dryrun.py:388``,
  ``analyze``'s result; ``fits_16g`` becomes ``fits_80g``), for a train
  row and for a decode row on JAX's default "seq" cache; a row JAX skips
  (long_500k for a full-attention arch) says why.
* ``Roofline``: its terms, ``dominant``, ``useful_flops_ratio`` and the
  ``as_dict`` keys, as ``tests/test_hlo_analysis.py`` checks JAX's.
"""
import json
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import pytest

from _torch_dryrun_common import MESHES, PROGRAMS, TRAIN, fake_records, \
    real_rank
from _torch_mesh_common import start_world
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core.scaling import analytic_step_flops, param_count
from repro_torch.launch import dryrun, hlo_analysis

# the keys of JAX's ``analyze`` result (src/repro/launch/dryrun.py:388-403)
# and of its memory dict (:366-377), fits_16g there
JAX_KEYS = {"arch", "shape", "chips", "mesh", "kind", "remat", "moe_shard",
            "hlo_raw", "hlo_depth", "hlo_corrected", "analytic",
            "collectives", "memory", "roofline", "params", "active_params"}
JAX_MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
                   "temp_size_in_bytes", "generated_code_size_in_bytes",
                   "alias_size_in_bytes", "params_total_bytes",
                   "params_bytes_per_chip", "hbm_per_chip_est", "fits_16g"}


NO_COLLECTIVE = {("2x1", "olmo-prefill"), ("2x1", "olmo-decode-hd"),
                 ("2x1", "granite-decode-batch"), ("1x2", "granite-fl")}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(fake records, {mesh: [each rank's real records]})."""
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        fake = pool.submit(fake_records)
        real = {}
        for shape in MESHES:
            real[shape] = start_world(real_rank,
                                      tmp_path_factory.mktemp(shape), shape,
                                      world=2)()
        return fake.result(), real


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", [p[0] for p in PROGRAMS])
def test_fake_world_records_equal_a_real_world(records, shape, name):
    fake, real = records
    want = fake[shape, name]
    # a data-parallel prefill or decode and a model axis the clients do
    # not split along start none
    assert bool(want) != ((shape, name) in NO_COLLECTIVE)
    for rank in real[shape]:
        record, err = rank[name]
        assert record == want
        if "decode" in name:
            assert err < 1e-5


def _olmo(n_layers=4):
    return get_config("olmo-1b", smoke=True).replace(n_layers=n_layers)


def test_counted_flops_against_the_analytic_count():
    """OLMo's smoke config (no norm parameters, tied head) on one device:
    the matmul FLOPs counted on fake tensors are the analytic count of
    ``analytic_step_flops`` plus the half of the attention products it
    leaves out (it halves QK^T and PV for causality; the eager program
    computes the whole S x S product and masks it)."""
    cfg = _olmo()
    low, _ = dryrun.lower_one(cfg, TRAIN, None)
    flops = low.analyze()["flops"]
    B, S = TRAIN.global_batch, TRAIN.seq_len
    analytic = analytic_step_flops(cfg, "train", B, S)
    masked = 6.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * S * B * S
    assert flops == pytest.approx(analytic + masked, rel=1e-9)
    assert 6.0 * param_count(cfg) * B * S < flops


def test_depth_extrapolation_equals_the_full_count():
    """The eager trace counts every superblock, so the d1 / d2
    extrapolation of a stack of like superblocks is the full count of
    FLOPs and of collective bytes.  Bytes accessed grow faster than depth:
    the backward of each superblock's slice of a stacked leaf writes a
    gradient of the whole stack and adds it to the others, so the
    extrapolation falls short and ``hlo_corrected`` keeps the full count,
    as JAX's clamp does."""
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    with fake_world(2):
        res = dryrun.analyze(_olmo(4), TRAIN, make_host_mesh(1, 2))
    (f1, b1, c1), (f2, b2, c2) = res["hlo_depth"]["d1"], res["hlo_depth"]["d2"]
    raw = res["hlo_raw"]
    assert c1 > 0
    assert f1 + 3 * (f2 - f1) == raw["flops"]
    assert c1 + 3 * (c2 - c1) == raw["collective"]
    assert b1 + 3 * (b2 - b1) < raw["bytes"]
    assert res["hlo_corrected"] == raw


def test_run_one_writes_jax_keys(tmp_path):
    res = dryrun.run_one("olmo-1b", "train_4k", False, str(tmp_path))
    assert "error" not in res, res.get("error")
    with open(tmp_path / "olmo-1b_train_4k_pod16x16.json") as f:
        assert json.load(f) == res
    assert set(res) == JAX_KEYS | {"wall_s", "variant"}
    assert set(res["memory"]) == JAX_MEMORY_KEYS - {"fits_16g"} | {"fits_80g"}
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["roofline"]["flops_per_device"] >= (
        res["analytic"]["flops_per_device"])
    dec = dryrun.run_one("olmo-1b", "decode_32k", True, str(tmp_path))
    assert "error" not in dec, dec.get("error")
    assert set(dec) == JAX_KEYS | {"wall_s", "variant"}
    assert dec["kind"] == "decode" and dec["mesh"] == "2x16x16"
    assert dec["collectives"]["total"] > 0
    skip = dryrun.run_one("olmo-1b", "long_500k", False, str(tmp_path))
    assert "sub-quadratic" in skip["skipped"]


def test_roofline_terms():
    r = hlo_analysis.Roofline(flops_per_device=989e12,
                              bytes_per_device=3.35e12 * 2,
                              collective_bytes_per_device=450e9 * 0.5,
                              chips=4, model_flops_total=989e12 * 2)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.dominant == "memory"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert set(r.as_dict()) == {
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "chips", "compute_s", "memory_s",
        "collective_s", "dominant", "model_flops_total",
        "useful_flops_ratio"}
    assert hlo_analysis.Roofline(1.0, 0.0, 0.0, 1).useful_flops_ratio == 0.0


def test_collective_bytes_by_jax_op_names():
    calls = [("tp.all_reduce", "model", 8), ("sharding.all_gather", "data",
                                              32),
             ("sharding.all_reduce", "data", 4), ("tp.all_gather", "model",
                                                  2)]
    out = hlo_analysis.collective_bytes(calls)
    assert out["bytes"]["all-reduce"] == 12
    assert out["counts"] == {"all-reduce": 2, "all-gather": 2,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}
    assert out["total"] == 46
