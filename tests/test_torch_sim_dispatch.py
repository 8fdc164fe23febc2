"""Port parity of the synchronous heterogeneity simulator on the dispatch
path (``rounds_per_dispatch > 1``): fused blocks between events, the bank
riding the block, per-round KD teacher planes under both schedules, and the
fedagg launch count that ``chip_smoke.py`` asserts on the card.

Against the JAX package (same parameters, same batch-index draws): host
fields equal, losses and final parameters at rtol 2e-4 / atol 1e-5,
accuracies within one test sample.  Within the port: R = 1 and R = 2 give
equal host telemetry, R = 2 and R = 4 equal parameters at that tolerance.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

from _torch_sim_common import (ATOL, CHURN_SEED, FUSED_SEED, RTOL,
                               assert_runs_match, blip_run, engines,
                               host_rows, mixed_traces, planes, run_jax,
                               run_port, sim_cfg)
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core import server as t_srv
from repro_torch.kernels.fedagg import ref as fedagg_ref
from repro_torch.obs import make_observability
from repro_torch.sim import HeterogeneitySim, SimConfig

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] /
    "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
ShapeFedRAC, CountingSim = chip_smoke.sim_classes(t_srv, HeterogeneitySim)


@pytest.mark.parametrize("schedule", ["parallel", "sequential"])
def test_sim_dispatch_buffer_matches_jax(schedule):
    j, t, test = engines(2, "buffer")
    trace_j, trace_t = mixed_traces(FUSED_SEED)
    sj, rj = run_jax(j, test, trace_j, "buffer", schedule)
    st, rt = run_port(t, test, trace_t, "buffer", schedule)
    assert_runs_match(rj, rt, planes(j, sj.params), planes(t, st.params),
                      len(test["y"]))
    # rounds 0 and 1 ran as one block, the bank riding it: round 1 merged
    # round 0's banked rows inside the block
    assert not rt.rows[1].events
    assert rt.rows[0].clusters[0].banked
    assert rt.rows[1].clusters[0].flushed == len(rt.rows[0].clusters[0].banked)


def test_sim_dispatch_all_banked_then_offline_flush_matches_jax():
    blip_run(2)


@pytest.fixture(scope="module")
def churn_runs():
    """The port alone at R = 1, 2 and 4 on a trace with a Procedure-2
    migration, R = 2 with observability on."""
    out = {}
    for R in (1, 2, 4):
        _, t, test = engines(R, "buffer", cls=t_srv.FedRAC)
        obs = make_observability() if R == 2 else None
        sim, rep = run_port(t, test, mixed_traces(CHURN_SEED)[1], "buffer",
                            obs=obs)
        out[R] = (t, sim, rep)
    return out


def test_sim_dispatch_telemetry_equals_one_round_path(churn_runs):
    """The records' host fields are the same at R = 1 and R = 2; the
    churned cluster's shard pack is a delta update, and every program is
    built once."""
    t2, _, r2 = churn_runs[2]
    assert host_rows(churn_runs[1][2]) == host_rows(r2)
    assert any("→" in e for r in r2.rows for e in r.events)
    reg = t2.obs.registry
    assert reg.counters["fl/pack_delta"].value >= 1
    assert set(t2.compile_stats().values()) == {1}
    assert all(c.value == 1 for k, c in reg.counters.items()
               if k.startswith("fl/compiles/"))


def test_sim_dispatch_width_invariant(churn_runs):
    """R = 2 and R = 4 run the same rounds (the port's draws are keyed on
    the absolute round): equal telemetry, parameters at tolerance."""
    (t2, s2, r2), (t4, s4, r4) = churn_runs[2], churn_runs[4]
    assert host_rows(r2) == host_rows(r4)
    for lvl in s2.params:
        np.testing.assert_allclose(t4.plane_of(lvl, s4.params[lvl]).numpy(),
                                   t2.plane_of(lvl, s2.params[lvl]).numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R", [1, 2])
def test_fedagg_launch_count_formula(monkeypatch, R):
    """``chip_smoke.expected_fedagg_launches`` against the calls the engine
    makes: on the CPU the wrapper runs the plain version, whose calls are
    counted here in place of the card's launches.  The one-round path
    makes none."""
    calls = []
    plain = fedagg_ref.weighted_aggregate
    monkeypatch.setattr(fedagg_ref, "weighted_aggregate",
                        lambda p, w: calls.append(p.shape) or plain(p, w))
    _, t, test = engines(R, "buffer", cls=ShapeFedRAC)
    sim = CountingSim(t, mixed_traces(FUSED_SEED)[1],
                      SimConfig(**sim_cfg("buffer")),
                      obs=make_observability())
    rep = sim.run(test)
    comp = int(sim.obs.registry.counter("agg/bank_compressions").value)
    want = (chip_smoke.expected_fedagg_launches(rep.rows, sim.terminal,
                                                comp, banked=True)
            if R > 1 else 0)
    assert len(calls) == want
    if R > 1:
        assert want > 2 * len(rep.rows)     # bank merges and a flush ran
        assert sim.terminal
        assert set(calls) <= t.fedagg_shapes
