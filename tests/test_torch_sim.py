"""Port parity of the synchronous heterogeneity simulator on the one-round
path (``rounds_per_dispatch == 1``), and its launcher.

Both packages run the simulator tests' federation from the same initial
parameters (the one-round path's host batch stream is the same in both) and
replay the same trace under each MAR policy.  Every record's host fields
(decisions, times, bytes, events) must be equal; losses and final
parameters agree at rtol 2e-4 / atol 1e-5, accuracies within one test
sample.
"""
import json

import pytest
import torch

from _torch_sim_common import (N_PART, POLICY_SEED, assert_runs_match,
                               blip_run,
                               engines, host_rows, mixed_traces, planes,
                               run_jax, run_port)
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core import server as t_srv
from repro_torch.launch import sim_run
from repro_torch.obs import validate
from repro_torch.sim import HeterogeneitySim, SimConfig, make_trace


@pytest.mark.parametrize("policy,select", [
    ("drop", "all"), ("mask", "all"), ("wait", "all"), ("buffer", "all"),
    ("wait", "fedcs")])
def test_sim_one_round_path_matches_jax(policy, select):
    j, t, test = engines(1, policy)
    trace_j, trace_t = mixed_traces(POLICY_SEED)
    kw = dict(select=select, select_budget=3 if select == "fedcs" else 0)
    sj, rj = run_jax(j, test, trace_j, policy, **kw)
    st, rt = run_port(t, test, trace_t, policy, **kw)
    assert_runs_match(rj, rt, planes(j, sj.params), planes(t, st.params),
                      len(test["y"]))
    s = rt.summary()
    if select == "fedcs":
        # FedCS admits at most 3 a cluster, each within the deadline
        assert s["unselected_total"] > 0 and s["mar_violations"] == 0
        return
    assert s["mar_violations"] > 0
    if policy in ("drop", "mask"):
        assert s["dropped_total"] > 0
    if policy == "mask":
        assert any(c.masked for r in rt.rows for c in r.clusters)
    if policy == "buffer":
        assert s["banked_total"] == s["flushed_total"] > 0


def test_sim_one_round_all_banked_then_offline_flush_matches_jax():
    blip_run(1)


def test_sim_refuses_what_is_not_ported():
    _, t, _ = engines(1, "drop", cls=t_srv.FedRAC)
    trace = make_trace("stable", N_PART, 2)
    with pytest.raises(ValueError, match="parallel"):
        HeterogeneitySim(t, trace, SimConfig(mode="async",
                                             schedule="sequential"))
    with pytest.raises(ValueError, match="buffered"):
        HeterogeneitySim(t, trace, SimConfig(mar_policy="buffer"))
    with pytest.raises(ValueError, match="unknown mar_policy"):
        HeterogeneitySim(t, trace, SimConfig(mar_policy="skip"))


# ------------------------------------------------------------ launcher
_SMALL = ["--participants", "8", "--samples", "600", "--base-width",
          "0.125", "--trace", "mixed", "--rounds", "4"]


def test_sim_run_cpu_json_and_observability(tmp_path, capsys):
    """The launcher on the CPU at R = 4 with every observability output:
    the validator accepts them (summary parity, ≥ 95 % span coverage of
    sim.run), and the summary's host totals equal the JAX launcher's."""
    m, tr, r = (str(tmp_path / f) for f in ("m.jsonl", "t.json", "r.json"))
    rep = sim_run.main(_SMALL + [
        "--mar-policy", "buffer", "--rounds-per-dispatch", "4", "--json",
        "--device", "cpu", "--metrics-out", m, "--trace-out", tr,
        "--report-out", r, "--fence"])
    out = capsys.readouterr().out
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["summary"] == json.loads(json.dumps(rep.summary()))
    assert validate.main(["--metrics", m, "--trace", tr, "--coverage-root",
                          "sim.run", "--report", r]) == 0
    report = json.loads(open(r).read())
    assert set(report["params_crc32"]) == {"0", "1"}
    from repro.launch import sim_run as j_sim_run
    rep_j = j_sim_run.main(_SMALL + ["--mar-policy", "buffer",
                                     "--rounds-per-dispatch", "4"])
    host = ("rounds", "wall_clock_s", "total_bytes", "participants",
            "participation_rate", "mar_violations", "dropped_total",
            "banked_total", "flushed_total")
    assert {k: rep.summary()[k] for k in host} == \
        {k: rep_j.summary()[k] for k in host}
    assert host_rows(rep) == host_rows(rep_j)


@pytest.mark.parametrize("flags,item", [
    (["--mesh-shape", "2x2", "--rounds-per-dispatch", "2"], "item 11b"),
    (["--mesh-shape", "2x2", "--rounds-per-dispatch", "2", "--tp-forward"],
     "item 11b")])
def test_sim_run_refused_flags_name_their_item(flags, item, capfd):
    """A 2D mesh's tensor-parallel forward, the default as in JAX (first
    case) or asked for (second), was refused naming ROADMAP item 11b (the
    test's name and ids are kept).  Now ``sim_run --mesh-shape 2x2``
    starts its 4 ranks on the CPU, rank 0 reports the member forward split
    over ``model``, and the run ends with its records."""
    rep = sim_run.main(_SMALL + ["--device", "cpu"] + flags)
    out = capfd.readouterr().out
    assert "tensor-parallel member forward" in out
    assert f"ROADMAP {item}" not in out
    assert len(rep.rows) == 4
def test_sim_run_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_run.main(_SMALL)
