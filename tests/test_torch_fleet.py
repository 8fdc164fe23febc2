"""Port parity of the vectorized fleet simulator (``sim/fleet.py``) and of
``sim_run --fleet-size``.

Both packages run ``FleetSim`` on copies of one ``Fleet`` and on the same
``FleetTrace`` (``FleetSim`` writes the fleet's arrays in place, so each
package gets its own copy).  Every ``FleetRoundRecord`` field, the MAR
budgets, the final levels and ``summary()`` must be exactly equal: the
simulator is host numpy float64 in both, and its setup's labels are held
equal by ``tests/test_torch_clustering_methods.py``.  The setup's
clustering depends only on the fleet, so this file computes it once per
fleet and package and reuses it across the cases.
"""
import json

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.core.resources import Fleet as JFleet
from repro.launch import sim_run as j_sim_run
from repro.sim import FleetSim as JFleetSim
from repro.sim import FleetSimConfig as JFleetSimConfig
from repro.sim import fleet as j_fleet

from repro_torch.core.resources import LAMBDA_PAPER, Fleet
from repro_torch.launch import sim_run
from repro_torch.sim import (FleetReport, FleetRoundRecord, FleetSim,
                             FleetSimConfig, make_fleet_trace,
                             sample_profiles)
from repro_torch.sim import fleet as t_fleet
from repro_torch.sim.faults import (FaultInjector, FaultPlan, SimulatedCrash,
                                    corrupt_checkpoint)
from repro_torch.ckpt.run_state import make_checkpointer

N, ROUNDS = 1500, 6
FIELDS = ("round", "duration", "time", "active", "masked", "dropped",
          "offline", "unselected", "violations", "banked", "flushed",
          "bytes", "events")


@pytest.fixture(autouse=True, scope="module")
def _clustering_once():
    """Memoize each package's ``fleet_optimal_clusters`` on (fleet, λ,
    seed, k_cap, samples): the first call of a fleet computes it."""
    mp = pytest.MonkeyPatch()
    for mod in (j_fleet, t_fleet):
        real, cache = mod.fleet_optimal_clusters, {}

        def memo(V, lam, *, _real=real, _cache=cache, **kw):
            key = (np.asarray(V).tobytes(), tuple(lam),
                   tuple(sorted((k, str(v)) for k, v in kw.items())))
            if key not in _cache:
                _cache[key] = _real(V, lam, **kw)
            return _cache[key]

        mp.setattr(mod, "fleet_optimal_clusters", memo)
    yield
    mp.undo()


def _rows(report):
    return [{f: (getattr(r, f).tolist()
                 if isinstance(getattr(r, f), np.ndarray) else getattr(r, f))
             for f in FIELDS} for r in report.rows]


def _pair(n=N, rounds=ROUNDS, trace_seed=4, **cfg):
    V = sample_profiles(n, seed=3)
    trace = make_fleet_trace("mixed", n, rounds, seed=trace_seed)
    sj = JFleetSim(JFleet.from_matrix(V.copy()), trace,
                   JFleetSimConfig(rounds=rounds, seed=3, **cfg))
    st = FleetSim(Fleet.from_matrix(V.copy()), trace,
                  FleetSimConfig(rounds=rounds, seed=3, **cfg), device="cpu")
    return sj, st


def _assert_same(rj, rt):
    assert isinstance(rt, FleetReport)
    assert all(isinstance(r, FleetRoundRecord) for r in rt.rows)
    assert _rows(rt) == _rows(rj)
    assert rt.mar == rj.mar and rt.k == rj.k and rt.n == rj.n
    assert rt.di_values == rj.di_values
    assert np.array_equal(rt.levels, rj.levels)
    assert rt.summary() == rj.summary()


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("select", ["all", "fedcs"])
@pytest.mark.parametrize("policy", ["drop", "mask", "wait", "buffer"])
def test_fleet_sim_matches_jax(policy, select, mode):
    sj, st = _pair(mar_policy=policy, select=select, mode=mode,
                   lam=LAMBDA_PAPER)
    rj, rt = sj.run(), st.run()
    _assert_same(rj, rt)
    s = rt.summary()
    for row in rt.rows:       # every slot in exactly one bucket
        assert (row.active + row.masked + row.dropped + row.offline
                + row.unselected + row.banked).sum() == N
    if select == "fedcs":
        assert s["mar_violations"] == 0 and s["unselected_total"] > 0
    else:
        assert s["mar_violations"] > 0
    if policy == "buffer":
        assert s["banked_total"] == s["flushed_total"]
    if mode == "async":
        sync = _pair(mar_policy=policy, select=select, lam=LAMBDA_PAPER)[1]
        assert s["wall_clock_s"] <= sync.run().summary()["wall_clock_s"]


@pytest.mark.parametrize("budget", [5, 64])
def test_fleet_sim_select_budget_matches_jax(budget):
    sj, st = _pair(select="fedcs", select_budget=budget, mar_policy="mask",
                   schedule="sequential")
    rj, rt = sj.run(), st.run()
    _assert_same(rj, rt)
    for row in rt.rows:
        assert ((row.active + row.masked + row.dropped + row.banked)
                <= budget).all()


def test_fleet_sim_explicit_mar_matches_jax():
    sj, st = _pair(mar=0.3, kappa=0.5, mar_policy="drop")
    _assert_same(sj.run(), st.run())


@pytest.mark.parametrize("bad,match", [
    (dict(select="best-effort"), "unknown select"),
    (dict(mar_policy="retry"), "unknown mar_policy"),
    (dict(schedule="diagonal"), "unknown schedule"),
    (dict(mode="eventual"), "unknown mode"),
    (dict(mode="async", schedule="sequential"), "requires schedule"),
])
def test_fleet_sim_refuses_bad_config(bad, match):
    V = sample_profiles(64, seed=0)
    trace = make_fleet_trace("stable", 64, 2)
    with pytest.raises(ValueError, match=match):
        FleetSim(Fleet.from_matrix(V), trace, FleetSimConfig(**bad),
                 device="cpu")
    with pytest.raises(ValueError, match=match):
        JFleetSim(JFleet.from_matrix(V), trace, JFleetSimConfig(**bad))


def test_fleet_sim_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = sample_profiles(64, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetSim(Fleet.from_matrix(V), make_fleet_trace("stable", 64, 2),
                 FleetSimConfig())


# ------------------------------------------------------------ resume
def _run_fleet(ckpt_dir=None, resume=False, plan=None, rounds=ROUNDS):
    fleet = Fleet.from_matrix(sample_profiles(N, seed=3))
    trace = make_fleet_trace("mixed", N, rounds, seed=4)
    ck = (make_checkpointer(str(ckpt_dir), every=2, resume=resume)
          if ckpt_dir else None)
    sim = FleetSim(fleet, trace, FleetSimConfig(rounds=rounds, seed=3,
                                                mar_policy="buffer"),
                   checkpoint=ck, faults=FaultInjector(plan) if plan else None,
                   device="cpu")
    try:
        rep = sim.run()
    except SimulatedCrash:
        return None
    return _rows(rep), rep.summary(), rep.levels.tolist()


@pytest.mark.parametrize("corrupt", [None, "truncate", "garbage"])
def test_fleet_resume_bit_identical(tmp_path, corrupt):
    """Killed at round boundary 5 (cadence 2, so the resume also redoes an
    unsaved round), then a fresh simulator resumes: every column, the
    summary and the levels equal the uninterrupted run's.  With the newest
    checkpoint corrupted the resume starts from the one before."""
    ctrl = _run_fleet()
    assert _run_fleet(tmp_path, plan=FaultPlan(kill_at_round=5,
                                               raise_instead=True)) is None
    if corrupt:
        corrupt_checkpoint(str(tmp_path), corrupt)
    assert _run_fleet(tmp_path, resume=True) == ctrl


# ------------------------------------------------------------ launcher
_FLEET = ["--fleet-size", "2000", "--rounds", "4", "--trace", "mixed"]


@pytest.mark.parametrize("extra", [
    [], ["--select", "fedcs", "--mar-policy", "buffer"],
    ["--mode", "async", "--mar-policy", "mask"]], ids=["drop", "fedcs",
                                                       "async"])
def test_sim_run_fleet_size_matches_jax(capsys, tmp_path, extra):
    out = str(tmp_path / "r.json")
    rt = sim_run.main(_FLEET + extra + ["--device", "cpu", "--json",
                                        "--report-out", out])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    rj = j_sim_run.main(_FLEET + extra + ["--json"])
    assert doc == json.loads(json.dumps(rj.summary()))
    assert json.loads(open(out).read()) == doc
    _assert_same(rj, rt)


def test_sim_run_fleet_refusals_and_card(monkeypatch, tmp_path):
    with pytest.raises(SystemExit, match="does not apply to the fleet"):
        sim_run.main(_FLEET + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path), "--kill-mid-block", "2",
                               "--rounds-per-dispatch", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_run.main(_FLEET)


def test_sim_run_fleet_kill_and_resume(tmp_path, capsys):
    """``--kill-at-round`` then ``--resume`` through the launcher (the
    kill raises in process here) equals the uninterrupted summary."""
    base = _FLEET + ["--device", "cpu", "--json", "--ckpt-dir",
                     str(tmp_path)]
    ctrl = sim_run.main(_FLEET + ["--device", "cpu"]).summary()
    injector = sim_run.FaultInjector

    def raising(plan):
        plan.raise_instead = True
        return injector(plan)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim_run, "FaultInjector", raising)
        with pytest.raises(SimulatedCrash):
            sim_run.main(base + ["--kill-at-round", "2"])
    assert sim_run.main(base + ["--resume"]).summary() == ctrl
    capsys.readouterr()


def test_sim_run_fleet_graceful_exit(tmp_path):
    """The SIGTERM path on the fleet simulator: a final checkpoint at the
    last boundary, the partial summary with the signal, exit 128 + 15."""
    args = type("Args", (), {"report_out": str(tmp_path / "r.json"),
                             "metrics_out": None, "trace_out": None,
                             "fence": False})()
    ck = make_checkpointer(str(tmp_path / "ck"), every=100)
    sim = FleetSim(Fleet.from_matrix(sample_profiles(300, seed=0)),
                   make_fleet_trace("mixed", 300, 3, seed=0),
                   FleetSimConfig(rounds=3), checkpoint=ck, device="cpu")
    sim.run()
    assert ck.manager.steps() == []            # the cadence never fired
    with pytest.raises(SystemExit) as e:
        sim_run._graceful_exit(args, sim, None, 15)
    assert e.value.code == 143
    assert ck.manager.steps() == [3]
    doc = json.loads(open(args.report_out).read())
    assert doc["interrupted"] == 15 and doc["rounds"] == 3
    assert doc["fleet_size"] == 300
