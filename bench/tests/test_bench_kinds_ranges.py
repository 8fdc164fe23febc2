"""A model kind joins the benchmark by modules alone, and the readers'
contract: a stand-in kind, installed only as modules, runs a small cell
through ``run.run_cell`` with its own model FLOPs, and readers defined
here read a counter and a program range from ``run``.  The reduction of
the program's ranges by launch on a hand-made kineto timeline, and on a
small CPU cell equal to the stand-alone probe's."""
import json
import sys
import types
from types import SimpleNamespace

import pytest
import torch

from bench import manifest, probe_port_ranges, timeline
from bench.tests import small
from bench.tests.test_bench_run import load_run

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@pytest.fixture(scope="module")
def run():
    return load_run()


def readers_from(monkeypatch, own: dict):
    """``manifest.reader`` finding the test's readers first."""
    orig = manifest.reader
    monkeypatch.setattr(manifest, "reader", lambda name: (
        SimpleNamespace(read=own[name]) if name in own else orig(name)))


def per_layer(*names):
    return [{"name": n, "unit": "1"} for n in names]


def test_a_stand_in_kind_runs_by_modules_alone(run, monkeypatch, capsys):
    from bench.kinds import lm as lm_kind
    from bench.reference import lm as lm_ref
    kind = types.ModuleType("bench.kinds.standin")
    for k in ("UNIT", "EVAL_IS_ACCURACY", "family", "classes",
              "engine_base", "units_per_sample"):
        setattr(kind, k, getattr(lm_kind, k))
    own_flops = 1.25e15

    def flops_per_call(cfg, traffic, members, n_test):
        assert cfg["kind"] == "standin" and sum(members.values()) > 0
        return own_flops

    kind.flops_per_call = flops_per_call
    monkeypatch.setitem(sys.modules, "bench.kinds.standin", kind)
    monkeypatch.setitem(sys.modules, "bench.reference.standin", lm_ref)
    seen = {}

    def blocks(r):
        seen["counters"], seen["ranges"] = r.counters, r.ranges
        return r.counters["fl/dispatch_blocks"]

    def member_updates(r):
        return r.ranges["member_update"]["count"]

    readers_from(monkeypatch, {"standin_blocks": blocks,
                               "standin_member_updates": member_updates})
    cell = small.lm_cell()
    cell["config"].update(kind="standin", reference="standin")
    cell["per_layer"] = per_layer("standin_blocks", "standin_member_updates",
                                  "mfu.lm")
    out = run.run_cell(cell, 2 ** 31 + 53, 0.2, True, device="cpu")
    assert out["correct"] is True
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["model_flops_per_call"] == own_flops
    counters = next(x["counters"] for x in lines if "counters" in x)
    got = out["metrics"]
    assert got["standin_blocks"]["value"] == counters["fl/dispatch_blocks"]
    assert counters["fl/dispatch_blocks"] > 0
    # one member_update range a round and cluster in the ranges call
    fl = cell["traffic"]["fl"]
    lay = lines[0]["layout"]
    assert got["standin_member_updates"]["value"] == fl["rounds"] * len(lay)
    assert all(r["kernels"] == 0 for r in seen["ranges"].values())
    # mfu reads the kind's own count
    w = out["window"]
    clean_s = sum(t for t, p in zip(w["call_s"], w["phases"]) if p == "clean")
    assert got["mfu.lm"]["value"] == (100.0 * own_flops
                                      * w["phases"].count("clean")
                                      / (clean_s * 495e12))
    assert w["phases"][:2] == ["prof", "ranges"]


class Raw:
    """A kineto event as ``prof.profiler.kineto_results.events()`` gives
    it."""

    def __init__(self, name, start, end, device=CPU, corr=0,
                 annotation=False):
        self._v = (name, start, end, device, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def raw_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_launch_ranges_by_hand():
    prof = raw_prof([
        Raw("port.block_exec", 0, 1000),
        Raw("port.member_update", 100, 600),
        Raw("port.teacher_forward", 650, 900),
        Raw("port.member_update", 100, 600, CUDA, annotation=True),
        Raw("cudaLaunchKernel", 150, 160, corr=1),   # member_update
        Raw("cudaLaunchKernel", 200, 210, corr=2),   # member_update
        Raw("cudaLaunchKernel", 700, 710, corr=3),   # teacher_forward
        Raw("cudaLaunchKernel", 950, 960, corr=4),   # block_exec alone
        Raw("cudaLaunchKernel", 3000, 3010, corr=5),  # outside every range
        Raw("gemm", 1000, 1400, CUDA, corr=1),
        Raw("gemm", 1200, 1600, CUDA, corr=2),      # another stream
        Raw("softmax", 1700, 1800, CUDA, corr=3),
        Raw("fedagg", 1900, 2000, CUDA, corr=4),
        Raw("copy", 3100, 3200, CUDA, corr=5),
        Raw("orphan", 3300, 3400, CUDA, corr=6)])   # no runtime call
    ranges, totals = timeline.launch_ranges(prof, torch)
    assert ranges["port.member_update"] == {
        "count": 1, "kernels": 2, "sum_ms": 800e-6, "union_ms": 600e-6}
    assert ranges["port.teacher_forward"]["kernels"] == 1
    assert ranges["port.teacher_forward"]["union_ms"] == 100e-6
    assert ranges["port.block_exec"]["sum_ms"] == 100e-6
    assert totals == {"unranged_ms": 100e-6, "unmatched_ms": 100e-6,
                      "total_ms": pytest.approx(1200e-6, rel=1e-12),
                      "n_kernels": 6}
    got = timeline.program_ranges(prof, torch)
    assert set(got) == {"block_exec", "member_update", "teacher_forward"}
    run = SimpleNamespace(ranges=got)
    for name, want in (("member_update_ms.cnn", 600e-6),
                       ("member_update_ms.lm", 600e-6),
                       ("teacher_fwd_ms.lm", 100e-6)):
        assert manifest.reader(name).read(run) == want


def test_range_readers_read_none_without_kernels():
    empty = {"count": 4, "kernels": 0, "sum_ms": 0.0, "union_ms": 0.0}
    for ranges in ({}, {"member_update": empty, "teacher_forward": empty}):
        run = SimpleNamespace(ranges=ranges)
        for name in ("member_update_ms.cnn", "member_update_ms.lm",
                     "teacher_fwd_ms.lm"):
            assert manifest.reader(name).read(run) is None


def test_run_ranges_equal_the_probes_on_a_small_cell(run, monkeypatch):
    seen = {}

    def keep(r):
        seen["ranges"] = r.ranges

    readers_from(monkeypatch, {"keep_ranges": keep})
    cell = small.cnn_cell()
    cell["per_layer"] = per_layer("keep_ranges")
    seed = 2 ** 31 + 43
    assert run.run_cell(cell, seed, 0.1, True, device="cpu")["correct"]
    prof = probe_port_ranges.probe(small.cnn_cell(), seed, 1,
                                   "cpu")["profile"]
    got = seen["ranges"]
    assert {"member_update", "teacher_forward", "block_exec"} <= set(got)
    assert {timeline.PORT + n: r["count"] for n, r in got.items()} == \
        prof["ranges"]
    # no kernels on the CPU: nothing counted on either side
    assert prof["n_kernels"] == 0 and prof["device_ms_by_launch"] == {}
    assert all(r["kernels"] == 0 and r["union_ms"] == 0.0
               for r in got.values())
