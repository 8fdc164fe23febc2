"""The port's tracer on the profiler's clock, on a tiny CNN ``FedRAC`` whose
slave distils from the master on the dispatch path (the CPU).

A recording tracer holds a ``torch.profiler.record_function`` range named
``port.<span>`` open while it holds a span open, so a traced ``train()``
draws each of its spans on the profiler's timeline, nested as the code
nests them.  ``NULL_OBS`` enters no range and records nothing, and the
training it runs is bit-identical to the traced one.  The ``block_exec``
args carry the block's members, capacity and rounds (the padded-row
arithmetic), and the tracer's file passes the validator with the
``cluster`` span as its coverage root.  Last, the launcher's
``profiled_train`` (``launch/fl_train.py --profile-out``) writes the
profiler's Chrome trace with the ranges in it.
"""
import json

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.core import server as srv
from repro_torch.core.families import cnn_family
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.core.tree import tree_leaves
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (SPECS, make_classification,
                                        train_test_split)
from repro_torch.launch import fl_train
from repro_torch.obs import NULL_OBS, make_observability, validate
from repro_torch.obs.trace import RANGE_PREFIX

ROUNDS, R = 2, 2
# each span of FedRAC.train and the span it sits in
PARENT = {"cluster": None, "init_params.draw": "cluster",
          "init_params.to_device": "cluster", "plane_of": "cluster",
          "dispatch.prepare": "cluster", "block_exec": "cluster",
          "teacher_forward": "block_exec", "member_update": "block_exec",
          "params_of": "cluster", "evaluate": "cluster"}


class Recording(srv.FedRAC):
    """Keeps every dispatch block's member losses."""

    def dispatch_rounds(self, *args, **kw):
        out = super().dispatch_rounds(*args, **kw)
        self.block_losses.append(out.losses.clone())
        return out


def engine():
    """12 participants in two clusters, KD in the slave, two rounds as one
    dispatch block (the launcher's synthetic MNIST at a small size)."""
    ds = make_classification("synth-mnist", 600, seed=3)
    train, test = train_test_split(ds)
    parts_idx = dirichlet_partition(train.y, 12, alpha=1.0, seed=3)
    V = TABLE_III[np.random.default_rng(3).integers(0, 40, 12)]
    parts = participants_from_matrix(V, n_data=[len(p) for p in parts_idx])
    shape, classes = SPECS["synth-mnist"]
    fam = cnn_family(classes=classes, in_channels=shape[-1], alpha=0.5,
                     base_width=0.125, input_hw=shape[0])
    cfg = srv.FLConfig(rounds=ROUNDS, rounds_per_dispatch=R,
                       steps_per_round=2, compact_to=4, seed=3, use_kd=True)
    eng = Recording(parts, [{"x": train.x[p], "y": train.y[p]}
                            for p in parts_idx], fam, cfg, classes=classes,
                    device="cpu").setup()
    eng.block_losses = []
    return eng, {"x": test.x, "y": test.y}


class CountingRange(torch.profiler.record_function):
    entered = []

    def __enter__(self):
        CountingRange.entered.append(self.name)
        return super().__enter__()


def trained(obs, monkeypatch):
    """A fresh engine's ``train()`` under ``obs``, inside a profiler, with
    the ranges the engine enters counted."""
    eng, test = engine()
    eng.obs = obs
    CountingRange.entered = []
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = eng.train(test)
    monkeypatch.undo()
    ranges = [e for e in prof.events()
              if e.name.startswith(RANGE_PREFIX)]
    return eng, res, ranges, list(CountingRange.entered)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        traced = trained(make_observability(trace=True), mp)
        before = NULL_OBS.registry.snapshot()
        null = trained(NULL_OBS, mp)
    finally:
        mp.undo()
    return {"traced": traced, "null": null,
            "null_registry": (before, NULL_OBS.registry.snapshot())}


# records made after the fact (``Tracer.complete``): the tracer's alone
AFTER_THE_FACT = {"compile", "pack_h2d"}


def spans(eng):
    return [e for e in eng.obs.tracer.events()
            if e["name"] not in AFTER_THE_FACT]


def fedrac_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(RANGE_PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name[len(RANGE_PREFIX):]


def test_the_slave_distils_on_the_dispatch_path(runs):
    eng, res, _, _ = runs["traced"]
    sizes = {l: len(m) for l, m in eng.assignment.members.items() if m}
    assert len(sizes) >= 2 and all(n > 0 for n in sizes.values())
    assert all(k[0] == "dispatch" for k in eng.compile_stats())
    assert eng.cfg.use_kd and len(eng.block_losses) == len(sizes)


def test_every_span_is_a_range(runs):
    eng, _, ranges, entered = runs["traced"]
    names = [e.name[len(RANGE_PREFIX):] for e in ranges]
    assert set(names) == set(PARENT)
    # one range a span
    got = sorted(names)
    assert got == sorted(e["name"] for e in spans(eng))
    assert sorted(n[len(RANGE_PREFIX):] for n in entered) == got
    assert AFTER_THE_FACT <= {e["name"] for e in eng.obs.tracer.events()}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_ranges_nest_as_the_code(runs, name):
    _, _, ranges, _ = runs["traced"]
    mine = [e for e in ranges if e.name == RANGE_PREFIX + name]
    assert mine and {fedrac_parent(e) for e in mine} == {PARENT[name]}


def test_range_counts_follow_the_layout(runs):
    eng, _, ranges, _ = runs["traced"]
    n = {k: sum(e.name == RANGE_PREFIX + k for e in ranges) for k in PARENT}
    clusters = len([m for m in eng.assignment.members.values() if m])
    blocks = clusters * (ROUNDS // R)
    assert n["cluster"] == n["init_params.draw"] == clusters
    assert n["block_exec"] == n["dispatch.prepare"] == blocks
    assert n["member_update"] == blocks * R
    # only the slaves distil: one teacher forward a slave round
    assert n["teacher_forward"] == (clusters - 1) * ROUNDS
    assert n["evaluate"] == clusters * ROUNDS


def test_null_obs_enters_no_range_and_trains_the_same_bits(runs):
    eng_t, res_t, _, entered_t = runs["traced"]
    eng_n, res_n, ranges_n, entered_n = runs["null"]
    assert entered_t and entered_n == [] and ranges_n == []
    assert eng_n.obs is NULL_OBS and NULL_OBS.tracer.events() == []
    before, after = runs["null_registry"]
    assert after == before
    assert res_n.history == res_t.history
    assert len(eng_n.block_losses) == len(eng_t.block_losses)
    for a, b in zip(eng_n.block_losses, eng_t.block_losses):
        assert torch.equal(a, b)
    for level, p in eng_t.cluster_params.items():
        for a, b in zip(tree_leaves(eng_n.cluster_params[level]),
                        tree_leaves(p)):
            assert torch.equal(a, b)


def test_block_exec_args_give_the_padded_rows(runs):
    eng, _, _, _ = runs["traced"]
    blocks = [e["args"] for e in spans(eng) if e["name"] == "block_exec"]
    layout = {l: len(m) for l, m in eng.assignment.members.items() if m}
    assert sorted((a["level"], a["members"], a["capacity"], a["R"])
                  for a in blocks) == sorted(
        (l, c, eng._capacity(c), R) for l, c in layout.items())
    pad = sum((a["capacity"] - a["members"]) * a["R"] for a in blocks)
    rows = sum(a["capacity"] * a["R"] for a in blocks)
    want = sum(eng._capacity(c) - c for c in layout.values()) / sum(
        eng._capacity(c) for c in layout.values())
    assert pad / rows == pytest.approx(want, rel=0, abs=1e-12)
    # the cluster spans carry the same members
    assert sorted((e["args"]["level"], e["args"]["members"])
                  for e in spans(eng) if e["name"] == "cluster") == sorted(
        layout.items())


def test_trace_file_passes_the_validator_with_cluster_root(runs, tmp_path):
    eng, _, _, _ = runs["traced"]
    path = tmp_path / "trace.json"
    eng.obs.tracer.write(path)
    # the validator's default coverage, 0.95
    assert validate.main(["--trace", str(path), "--coverage-root",
                          "cluster"]) == 0
    out = validate.validate_trace(path, coverage_root="cluster")
    assert out["coverage"] >= 0.95


def chrome_names(path):
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {e.get("name") for e in events}


def test_profiled_train_draws_the_dispatch_ranges(tmp_path, capsys):
    eng, test = engine()
    path = tmp_path / "profile.json"
    fl_train.profiled_train(eng, test, path)
    assert f"-> {path}" in capsys.readouterr().out
    assert {RANGE_PREFIX + n for n in PARENT} <= chrome_names(path)


def test_launcher_profile_out_holds_the_ranges(tmp_path, capsys):
    # the launcher's one-round programs: no dispatch block
    path = tmp_path / "profile.json"
    fl_train.main(["--participants", "12", "--rounds", "2",
                   "--steps-per-round", "2", "--samples", "600",
                   "--base-width", "0.125", "--device", "cpu",
                   "--profile-out", str(path)])
    assert f"-> {path}" in capsys.readouterr().out
    names = chrome_names(path)
    assert {RANGE_PREFIX + n for n in (
        "cluster", "init_params.draw", "init_params.to_device",
        "teacher_forward", "member_update", "evaluate")} <= names
    assert RANGE_PREFIX + "block_exec" not in names


def test_launcher_without_profile_out_keeps_obs_off(monkeypatch, capsys):
    seen = []
    real = srv.FedRAC.train

    def spy(self, test, *a):
        seen.append(self.obs)
        return real(self, test, *a)

    monkeypatch.setattr(srv.FedRAC, "train", spy)
    fl_train.main(["--participants", "12", "--rounds", "1",
                   "--steps-per-round", "1", "--samples", "600",
                   "--base-width", "0.125", "--device", "cpu"])
    assert seen == [NULL_OBS]
    assert "profile:" not in capsys.readouterr().out
