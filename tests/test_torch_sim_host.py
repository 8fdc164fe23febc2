"""Port parity of the simulator's host modules, which are numpy (or plain
Python) in both packages and so must give the JAX package's results
exactly: traces for every scenario, the event queue's order, the report's
rows and summary, the metrics registry's exports, the tracer, the
validator and the new cost-model functions."""
import json
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core import cost_model as j_cost
from repro.core.resources import participants_from_matrix as j_parts
from repro.obs import MetricsRegistry as JRegistry, Tracer as JTracer
from repro.obs import span_coverage as j_span_coverage
from repro.obs import validate as j_validate
from repro.sim import report as j_report, traces as j_traces

from repro_torch.core import cost_model
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.obs import (NULL_OBS, NULL_TRACER, MetricsRegistry, Tracer,
                             make_observability, span_coverage, validate)
from repro_torch.sim import (Arrival, Departure, EventQueue, ResourceDrift,
                             SpikeEnd, StragglerSpike, traces)
from repro_torch.sim.events import decode_event, encode_event
from repro_torch.sim.faults import NULL_FAULTS
from repro_torch.sim.report import (ClusterRoundStats, RoundRecord,
                                    SimReport, decode_rows, encode_rows)


def _encoded(trace):
    return ([(t, encode_event(ev)) for t, ev in trace.events],
            sorted(trace.initially_offline))


def _encoded_j(trace):
    return ([(t, [type(ev).__name__, asdict(ev)]) for t, ev in trace.events],
            sorted(trace.initially_offline))


# ------------------------------------------------------------ traces
@pytest.mark.parametrize("scenario", sorted(j_traces.SCENARIOS))
@pytest.mark.parametrize("n,rounds,seed", [(8, 4, 3), (40, 8, 3),
                                           (200, 6, 11)])
def test_trace_equals_jax(scenario, n, rounds, seed):
    assert sorted(traces.SCENARIOS) == sorted(j_traces.SCENARIOS)
    assert traces.scenario_knobs(scenario) == j_traces.scenario_knobs(scenario)
    got = traces.make_trace(scenario, n, rounds, seed=seed)
    want = j_traces.make_trace(scenario, n, rounds, seed=seed)
    assert got.name == want.name
    assert _encoded(got) == _encoded_j(want)
    fg = traces.make_fleet_trace(scenario, n, rounds, seed=seed)
    fw = j_traces.make_fleet_trace(scenario, n, rounds, seed=seed)
    for tab in ("dropouts", "drifts", "spikes", "arrivals"):
        a, b = getattr(fg, tab), getattr(fw, tab)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert fg.n_events == fw.n_events


def test_trace_knobs_and_unknown_scenario_raise_like_jax():
    got = traces.make_trace("mixed", 20, 5, seed=2, dropout_rate=0.3)
    want = j_traces.make_trace("mixed", 20, 5, seed=2, dropout_rate=0.3)
    assert _encoded(got) == _encoded_j(want)
    with pytest.raises(TypeError, match="does not accept"):
        traces.make_trace("drift", 4, 2, spike_rate=0.1)
    with pytest.raises(ValueError, match="unknown scenario"):
        traces.make_trace("nope", 4, 2)


@pytest.mark.parametrize("rate", [0.05, 0.3])
def test_vectorized_traces_equal_scalar_loops(rate):
    n, rounds, seed = 30, 7, 5
    pairs = [(traces.dropout_events, traces.legacy_dropout_events),
             (traces.drift_events, traces.legacy_drift_events),
             (traces.straggler_events, traces.legacy_straggler_events)]
    for vec, loop in pairs:
        assert vec(n, rounds, rate, seed) == loop(n, rounds, rate, seed)
    assert (traces.late_arrivals(n, rounds, rate, seed)
            == traces.legacy_late_arrivals(n, rounds, rate, seed))


def test_sample_profiles_equal_jax():
    np.testing.assert_array_equal(traces.sample_profiles(40, seed=3),
                                  j_traces.sample_profiles(40, seed=3))


# ------------------------------------------------------------ events
def test_event_queue_fifo_tie_break():
    q = EventQueue()
    q.push(1.0, Departure(0))
    q.push(0.0, Arrival(1))
    q.push(1.0, StragglerSpike(2))
    q.push(1.0, Arrival(3))
    assert [e for _, e in q.pop_due(0.5)] == [Arrival(1)]
    # equal timestamps pop Arrivals first (priority 0), then the other
    # classes in insertion order — the total (time, priority, seq) key
    assert [e.pid for _, e in q.pop_due(1.0)] == [3, 0, 2]
    assert len(q) == 0 and q.next_time() is None and q.pop() is None


def test_event_queue_encode_roundtrip():
    q = EventQueue()
    for t, ev in [(2.0, ResourceDrift(1, s_mult=0.5)), (1.0, SpikeEnd(2, 7)),
                  (1.0, Arrival(4, token=3))]:
        q.push(t, ev)
    q2 = EventQueue()
    q2.load_encoded(json.loads(json.dumps(q.encode())))
    assert q2.pop_due(5.0) == q.pop_due(5.0)
    assert decode_event(encode_event(Departure(3, 2.0))) == Departure(3, 2.0)


# ------------------------------------------------------------ report
def _rows():
    a = ClusterRoundStats(level=0, time=1.5, active=[0, 1], dropped=[2],
                          masked={1: 2}, violations=[1, 2], bytes=3e6,
                          mean_loss=0.7, acc=0.25)
    b = ClusterRoundStats(level=1, time=0.25, active=[5], offline=[6],
                          banked=[7], unselected=[8], flushed=2,
                          bytes=1.25e6)
    c = ClusterRoundStats(level=0, time=2.0, active=[0, 1, 2], bytes=4.5e6,
                          mean_loss=0.5)
    d = ClusterRoundStats(level=1, time=0.0, offline=[5, 6, 7])
    return [RoundRecord(0, 0.0, 1.5, [a, b], ["drop(p2)"]),
            RoundRecord(1, 1.5, 2.0, [c, d], [])]


def test_rows_encode_decode_roundtrip():
    rows = _rows()
    doc = json.loads(json.dumps(encode_rows(rows)))
    # compared as JSON text: NaN losses are equal there
    want = json.dumps([asdict(r) for r in rows])
    assert json.dumps([asdict(r) for r in decode_rows(doc)]) == want
    # the JAX package reads the same document to the same rows
    assert json.dumps([asdict(r) for r in j_report.decode_rows(doc)]) == want


def test_summary_timeline_and_flush_equal_jax():
    doc = encode_rows(_rows())
    rep = SimReport("mixed", "buffer", "parallel")
    rep_j = j_report.SimReport("mixed", "buffer", "parallel")
    for r, rj in zip(decode_rows(doc), j_report.decode_rows(doc)):
        rep.add(r)
        rep_j.add(rj)
    rep.final_acc = rep_j.final_acc = {0: 0.41, 1: 0.12}
    rep.bump_flushed(1, 3)
    rep_j.bump_flushed(1, 3)
    assert rep.summary() == rep_j.summary()
    assert rep.summary()["flushed_total"] == 5
    assert rep.timeline() == rep_j.timeline()
    assert rep.to_dict() == rep_j.to_dict()


# ------------------------------------------------------------ obs
def _fill(reg):
    reg.counter("fl/h2d_bytes").inc(1024)
    reg.counter("fl/h2d_bytes").inc(0.5)
    reg.gauge("fl/compile_s/x").set(0.125)
    reg.gauge("never_set")
    for v in (3e-6, 0.02, 0.02, 40.0):
        reg.histogram("fl/compile_s").observe(v)
    t = reg.table("sim/rounds", {"round": "int64", "t_start": "float64",
                                 "duration": "float64", "events": "int64"},
                  capacity=2, max_rows=3)
    for i in range(5):
        t.append(round=i, t_start=0.1 * i, duration=0.3, events=i % 2)


def test_registry_exports_equal_jax(tmp_path):
    reg, reg_j = MetricsRegistry(), JRegistry()
    _fill(reg)
    _fill(reg_j)
    assert reg.render_text() == reg_j.render_text()
    assert json.dumps(reg.snapshot()) == json.dumps(reg_j.snapshot())
    reg.to_jsonl(tmp_path / "t.jsonl")
    reg_j.to_jsonl(tmp_path / "j.jsonl")
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    meta, arrays = reg.state()
    meta_j, arrays_j = reg_j.state()
    assert json.dumps(meta) == json.dumps(meta_j)
    assert arrays.keys() == arrays_j.keys()
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], arrays_j[k])
    assert reg.tables["sim/rounds"].dropped == 2
    fresh = MetricsRegistry()
    fresh.load_state(meta, arrays)
    assert fresh.render_text() == reg.render_text()


def _spans(tracer):
    with tracer.span("sim.run", cat="engine", rounds=2):
        with tracer.span("round", cat="engine", round=0):
            tracer.instant("tick", n=1)
        tracer.complete("compile", 0, 10, cat="fl", program="p")
        with tracer.span("round", cat="engine", round=1, obj=object()):
            pass


def test_tracer_events_match_jax_and_fence_is_inert_on_cpu(tmp_path):
    tr, tr_j = Tracer(fence=True), JTracer()
    _spans(tr)
    _spans(tr_j)
    shape = [(e["name"], e["cat"], e["ph"], sorted(e.get("args", {})))
             for e in tr.events()]
    assert shape == [(e["name"], e["cat"], e["ph"], sorted(e.get("args", {})))
                     for e in tr_j.events()]
    x = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    assert tr.fence(x) is x and NULL_TRACER.fence(x) is x
    tr.write(tmp_path / "t.json")
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["traceEvents"][0]["ph"] == "M"
    assert NULL_TRACER.events() == [] and not NULL_OBS.on
    NULL_FAULTS.round_boundary(3)
    NULL_FAULTS.mid_block(0, 2)


def test_span_coverage_equals_jax():
    ev = [{"name": "sim.run", "ph": "X", "ts": 0.0, "dur": 100.0},
          {"name": "a", "ph": "X", "ts": 0.0, "dur": 30.0},
          {"name": "b", "ph": "X", "ts": 20.0, "dur": 30.0},
          {"name": "c", "ph": "X", "ts": 60.0, "dur": 35.0},
          {"name": "outside", "ph": "X", "ts": 90.0, "dur": 30.0}]
    assert span_coverage(ev, "sim.run") == j_span_coverage(ev, "sim.run") \
        == pytest.approx(0.85)
    with pytest.raises(ValueError):
        span_coverage(ev, "missing")


def test_validate_accepts_port_outputs_and_rejects_drift(tmp_path):
    obs = make_observability(fence=False)
    rep = SimReport("mixed", "buffer", "parallel", obs=obs)
    for r in _rows():
        rep.add(r)
    rep.bump_flushed(0, 1)
    with obs.tracer.span("sim.run", cat="engine"):
        with obs.tracer.span("round", cat="engine"):
            pass
    m, t, r = tmp_path / "m.jsonl", tmp_path / "t.json", tmp_path / "r.json"
    obs.registry.to_jsonl(m)
    obs.tracer.write(t)
    r.write_text(json.dumps(rep.to_dict(), default=float))
    args = ["--metrics", str(m), "--trace", str(t), "--coverage-root",
            "sim.run", "--min-coverage", "0.0", "--report", str(r)]
    assert validate.main(args) == 0
    assert j_validate.main(args) == 0          # the JAX validator agrees
    lines = m.read_text().splitlines()
    bad = [json.dumps(dict(json.loads(l), extra=1))
           if json.loads(l)["kind"] == "row" else l for l in lines]
    m.write_text("\n".join(bad) + "\n")
    assert validate.main(args[:2]) == 1


def test_bank_helpers_count_like_jax():
    """``compress_bank_rows`` and ``merge_buffered`` take ``obs=`` and
    count what the JAX package counts."""
    import jax.numpy as jnp
    from repro.core import aggregation as j_agg
    from repro.obs import make_observability as j_make_observability
    from repro_torch.core import aggregation as t_agg
    rows = np.random.default_rng(0).standard_normal((5, 256)).astype(
        np.float32)
    us = [0.5, 0.25, 1.0, 0.125, 0.75]
    ot, oj = make_observability(), j_make_observability()
    for obs, agg, arr in ((ot, t_agg, torch.tensor), (oj, j_agg,
                                                      jnp.asarray)):
        agg.compress_bank_rows([arr(r) for r in rows], us, 3, obs=obs)
        agg.compress_bank_rows([arr(r) for r in rows[:2]], us[:2], 3,
                               obs=obs)
        agg.merge_buffered({"w": arr(rows[0])}, [{"w": arr(rows[1])},
                                                 {"w": arr(rows[2])}],
                           [0.25, 0.5], obs=obs)
    assert ot.registry.snapshot()["counters"] == \
        oj.registry.snapshot()["counters"] == {
            "agg/bank_compressions": 1.0, "agg/bank_merges": 1.0,
            "agg/bank_rows_compressed": 5.0, "agg/bank_rows_merged": 2.0}


# ------------------------------------------------------------ cost model
def test_new_cost_model_functions_equal_jax():
    V = TABLE_III[:12]
    n = np.arange(12) * 37 + 50
    parts, parts_j = (participants_from_matrix(V, n_data=list(n)),
                      j_parts(V, n_data=list(n)))
    s = np.array([p.s for p in parts])
    r = np.array([p.r for p in parts])
    for slow in (1.0, np.linspace(1.0, 4.0, 12)):
        np.testing.assert_array_equal(
            cost_model.train_time_vec(s, 2.5e7, 2, n, slow),
            j_cost.train_time_vec(s, 2.5e7, 2, n, slow))
    np.testing.assert_array_equal(cost_model.comm_time_vec(r, 6.5e6),
                                  j_cost.comm_time_vec(r, 6.5e6))
    # the vector form is the scalar Eq. 2 terms, element by element
    np.testing.assert_array_equal(
        cost_model.train_time_vec(s, 2.5e7, 2, n)
        + cost_model.comm_time_vec(r, 6.5e6),
        [cost_model.round_time(p, 2.5e7, 6.5e6, 2) for p in parts])
    for kw in ({}, {"upload": False}, {"download": False},
               {"download": False, "upload": False}):
        assert cost_model.round_bytes(6.5e6, **kw) == \
            j_cost.round_bytes(6.5e6, **kw)
    times = np.array([cost_model.round_time(p, 2.5e7, 6.5e6, 2)
                      for p in parts])
    assert cost_model.total_time_sync(times, 7) == \
        j_cost.total_time_sync(times, 7) == 7 * times.max()
    assert [cost_model.round_time(p, 1e6, 1e5, 1) for p in parts] == \
        [j_cost.round_time(p, 1e6, 1e5, 1) for p in parts_j]
