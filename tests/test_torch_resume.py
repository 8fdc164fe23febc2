"""Crash-safe resume of the port's simulator: a resumed run is bit-identical
to an uninterrupted one.

In-process tests stand in for SIGKILL with ``FaultPlan(raise_instead=True)``
(→ ``SimulatedCrash``) and then build a FRESH engine (a new process's) with
``resume=True``, as the JAX tests do (``tests/test_ckpt_resume.py``): both
sync paths, a mid-block kill that recomputes the lost block, a checkpoint
of one path resuming the other, a corrupt newest checkpoint, none valid, a
foreign seed, ``save_now``, and async runs killed at a merge event.  The
CLI tests deliver a real SIGKILL and a real SIGTERM to
``repro_torch.launch.sim_run`` on the CPU.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.ckpt.manifest import CheckpointManager
from repro_torch.ckpt.run_state import make_checkpointer
from repro_torch.core import server as srv
from repro_torch.core.families import cnn_family
from repro_torch.core.resources import participants_from_matrix
from repro_torch.core.tree import tree_leaves
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification, train_test_split
from repro_torch.launch import sim_run
from repro_torch.sim import HeterogeneitySim, SimConfig, make_trace
from repro_torch.sim.faults import (FaultInjector, FaultPlan, SimulatedCrash,
                                    compare_reports, corrupt_checkpoint)
from repro_torch.sim.traces import sample_profiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAM = cnn_family(classes=10, in_channels=1, base_width=0.125)
# the JAX resume tests' federation and trace (tests/test_ckpt_resume.py)
TRACE_SEED = 5


def _setup(seed=0, **cfg_kw):
    ds = make_classification("synth-mnist", 400, seed=seed)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, 8, alpha=2.0, seed=seed)
    parts = participants_from_matrix(sample_profiles(8, seed=seed),
                                     n_data=[len(p) for p in idx])
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    cfg = srv.FLConfig(steps_per_round=2, lr=0.08, seed=seed, local_batch=8,
                       compact_to=2, **cfg_kw)
    eng = srv.FedRAC(parts, cd, FAM, cfg, classes=10, device="cpu").setup()
    return eng, {"x": test.x, "y": test.y}


def _run_sim(ckpt_dir=None, resume=False, plan=None, rounds=4,
             policy="mask", sim_kw=None, **cfg_kw):
    if policy == "buffer":
        cfg_kw["aggregation"] = "buffered"
    eng, test = _setup(**cfg_kw)
    trace = make_trace("mixed", 8, rounds, seed=TRACE_SEED)
    ck = (make_checkpointer(str(ckpt_dir), every=1, resume=resume)
          if ckpt_dir else None)
    sim = HeterogeneitySim(eng, trace,
                           SimConfig(rounds=rounds, mar_policy=policy,
                                     **(sim_kw or {})),
                           checkpoint=ck,
                           faults=FaultInjector(plan) if plan else None)
    try:
        rep = sim.run(test)
    except SimulatedCrash:
        return None
    return _sim_key(sim, rep)


def _sim_key(sim, rep):
    params = {lvl: [x.numpy().copy() for x in tree_leaves(p)]
              for lvl, p in sim.params.items()}
    rows = [(r.round, r.t_start, r.duration, list(r.events),
             [(c.level, c.time, c.mean_loss, sorted(c.active),
               sorted(c.dropped), sorted(c.offline),
               sorted(c.masked.items()), sorted(c.violations),
               sorted(c.banked), sorted(c.unselected), c.flushed, c.bytes,
               c.acc) for c in r.clusters]) for r in rep.rows]
    summary = {k: v for k, v in rep.summary().items()
               if k not in ("compiles", "transfers")}   # process-local
    return params, rows, summary


def _assert_identical(ctrl, res, tag):
    assert res is not None, f"[{tag}] resume crashed"
    for lvl in ctrl[0]:
        for a, b in zip(ctrl[0][lvl], res[0][lvl]):
            assert np.array_equal(a, b), f"[{tag}] params differ L{lvl}"
    assert ctrl[1] == res[1], f"[{tag}] rows differ"
    assert ctrl[2] == res[2], f"[{tag}] summary differs"


def _crash(tmp_path, plan_kw, **kw):
    assert _run_sim(tmp_path, plan=FaultPlan(raise_instead=True, **plan_kw),
                    **kw) is None


@pytest.mark.parametrize("path", ["one-round", "dispatch"])
def test_engine_resume_bit_identical(tmp_path, path):
    """Crash at a round boundary, resume in a FRESH engine → final params,
    per-round rows and summary totals are bit-identical to the
    uninterrupted control run, on both paths."""
    kw = {"rounds_per_dispatch": 4} if path == "dispatch" else {}
    ctrl = _run_sim(**kw)
    _crash(tmp_path, {"kill_at_round": 2}, **kw)
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2]
    _assert_identical(ctrl, _run_sim(tmp_path, resume=True, **kw), path)


def test_engine_resume_mid_block_recompute(tmp_path):
    """A kill inside a dispatch block (its programs ran, its rounds not yet
    recorded) loses the in-flight work; resume recomputes the whole block
    from the last boundary checkpoint bit-identically."""
    kw = {"rounds_per_dispatch": 3, "rounds": 5}
    ctrl = _run_sim(**kw)
    _crash(tmp_path, {"kill_mid_block": 4}, **kw)
    _assert_identical(ctrl, _run_sim(tmp_path, resume=True, **kw),
                      "mid-block")


def test_engine_resume_cross_path(tmp_path):
    """Checkpoints hold planes on both paths, so a one-round-path
    checkpoint loads under a dispatch engine: the restored rows are kept
    verbatim and the run completes (bit-equality ACROSS paths is not
    expected: the two paths draw different batch streams)."""
    ctrl = _run_sim()
    _crash(tmp_path, {"kill_at_round": 2})
    res = _run_sim(tmp_path, resume=True, rounds_per_dispatch=4)
    assert res is not None
    assert res[1][:2] == ctrl[1][:2], "restored row prefix mutated"
    assert len(res[1]) == len(ctrl[1])


def test_engine_resume_skips_corrupt_newest(tmp_path):
    """The newest checkpoint is garbage-corrupted after the crash: resume
    degrades to the previous valid one (recomputing one more round) and the
    run is STILL bit-identical."""
    kw = {"rounds_per_dispatch": 4}
    ctrl = _run_sim(**kw)
    _crash(tmp_path, {"kill_at_round": 3}, **kw)
    corrupt_checkpoint(str(tmp_path), "garbage")
    _assert_identical(ctrl, _run_sim(tmp_path, resume=True, **kw),
                      "corrupt-newest")


def test_engine_resume_no_valid_checkpoint_starts_fresh(tmp_path):
    """No checkpoint validates at all → a from-scratch run (with a
    warning), which still ends bit-identical to the control."""
    ctrl = _run_sim()
    (tmp_path / "MANIFEST.json").write_text("not json at all")
    _assert_identical(ctrl, _run_sim(tmp_path, resume=True),
                      "fresh-fallback")


def test_engine_resume_rejects_foreign_seed(tmp_path):
    """A checkpoint whose sampler stream differs from the engine's config
    fails LOUDLY (resuming it could not be bit-identical)."""
    _crash(tmp_path, {"kill_at_round": 2})
    with pytest.raises(CheckpointError, match="seed"):
        _run_sim(tmp_path, resume=True, seed=1)


def test_engine_resume_rejects_the_jax_stream_fingerprint(tmp_path):
    """A JAX run-state checkpoint records its threefry stream's
    fingerprint (``repro.data.device_sampler.stream_fingerprint``), not
    the port's: a checkpoint carrying it is refused like a foreign seed."""
    from repro.data import device_sampler as j_sampler
    _crash(tmp_path, {"kill_at_round": 2})
    mgr = CheckpointManager(str(tmp_path))
    meta, arrays = mgr.load_step(2)
    meta["sampler"]["fingerprint"] = j_sampler.stream_fingerprint(
        meta["sampler"]["seed"], meta["sampler"]["round"])
    mgr.save(3, meta, arrays)
    with pytest.raises(CheckpointError, match="fingerprint"):
        _run_sim(tmp_path, resume=True)


def test_engine_save_now_writes_pending_boundary(tmp_path):
    """``save_now`` (the SIGTERM path) writes the newest retained boundary
    snapshot even when the periodic cadence never fired."""
    eng, test = _setup()
    ck = make_checkpointer(str(tmp_path), every=100)   # never due
    sim = HeterogeneitySim(eng, make_trace("mixed", 8, 3, seed=TRACE_SEED),
                           SimConfig(rounds=3, mar_policy="mask"),
                           checkpoint=ck)
    sim.run(test)
    assert ck.manager.steps() == []                    # cadence never fired
    assert sim.save_now() == 3
    step, meta, _ = ck.load_latest("hetero-sim")
    assert step == 3 and meta["round"] == 3
    # no checkpointer armed → save_now is a harmless no-op
    assert HeterogeneitySim(eng, make_trace("stable", 8, 1),
                            SimConfig(rounds=1)).save_now() is None


@pytest.mark.parametrize("path", ["one-round", "dispatch"])
def test_async_resume_at_merge_event(tmp_path, path):
    """Async with independent clocks (``max_staleness=None``), killed at
    the third merge event and resumed in a fresh engine: servers, ledger,
    clocks, in-flight blocks and the completion queue come back, and the
    run ends bit-identical to the uninterrupted one.  An async checkpoint
    does not resume a sync engine."""
    kw = dict(policy="buffer", sim_kw={"mode": "async",
                                       "max_staleness": None},
              rounds_per_dispatch=4 if path == "dispatch" else 1)
    ctrl = _run_sim(**kw)
    _crash(tmp_path, {"kill_at_round": 3}, **kw)
    meta = CheckpointManager(str(tmp_path)).load_step(3)[0]
    assert meta["async"]["pending"], "no block in flight at the kill"
    _assert_identical(ctrl, _run_sim(tmp_path, resume=True, **kw),
                      f"async-{path}")
    with pytest.raises(CheckpointError, match="mode mismatch"):
        _run_sim(tmp_path, resume=True, policy="buffer",
                 rounds_per_dispatch=kw["rounds_per_dispatch"])


# ------------------------------------------------------------ real signals
SIM_CLI = [sys.executable, "-m", "repro_torch.launch.sim_run", "--trace",
           "mixed", "--participants", "8", "--samples", "400",
           "--steps-per-round", "2", "--base-width", "0.125",
           "--device", "cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["PYTHONUNBUFFERED"] = "1"
    env["OMP_NUM_THREADS"] = "1"       # as one_torch_thread, per process
    return env


def _cli(args, expect):
    r = subprocess.run(SIM_CLI + args, env=_env(), capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == expect, (r.returncode, r.stdout[-1000:],
                                    r.stderr[-2000:])
    return r


def test_cli_sigkill_resume_bit_identical(tmp_path):
    """A real SIGKILL inside a dispatch block, then ``--resume`` in a new
    process: the resumed report JSON, per-level params CRC32 included, is
    bit-identical to the uninterrupted control's (run in this process)."""
    run = ["--rounds", "4", "--mar-policy", "buffer",
           "--rounds-per-dispatch", "4"]
    ctrl, res = str(tmp_path / "ctrl.json"), str(tmp_path / "res.json")
    ck = str(tmp_path / "ckpt")
    sim_run.main(SIM_CLI[3:] + run + ["--report-out", ctrl])   # control
    _cli(run + ["--ckpt-dir", ck, "--kill-mid-block", "2"], -signal.SIGKILL)
    assert CheckpointManager(ck).steps() == [1, 2]
    _cli(run + ["--ckpt-dir", ck, "--resume", "--report-out", res], 0)
    assert compare_reports(ctrl, res) == []
    with open(res) as f:
        assert set(json.load(f)["params_crc32"]) == {"0", "1"}


def test_cli_sigterm_graceful_shutdown(tmp_path):
    """SIGTERM mid-run: the sync CLI writes a final checkpoint (the newest
    round boundary) and a partial report, flushes its metrics and exits
    128+15."""
    ck = str(tmp_path / "ckpt")
    rep = str(tmp_path / "partial.json")
    # far more rounds than run before the signal lands
    cmd = SIM_CLI + ["--rounds", "2000", "--mar-policy", "mask",
                     "--eval-every", "0", "--ckpt-dir", ck,
                     "--report-out", rep,
                     "--metrics-out", str(tmp_path / "m.jsonl")]
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        # the CLI prints its timeline only at the end, so progress is seen
        # through the checkpoints themselves
        deadline = time.time() + 240
        while time.time() < deadline and not CheckpointManager(ck).steps():
            assert proc.poll() is None, proc.communicate()[0][-2000:]
            time.sleep(0.25)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 128 + signal.SIGTERM, (proc.returncode,
                                                     out[-2000:])
    final = [int(line.split()[-1]) for line in out.splitlines()
             if "final checkpoint at round" in line]
    assert len(final) == 1 and 0 < final[0] < 2000, out[-2000:]
    assert CheckpointManager(ck).steps()[-1] == final[0]
    with open(rep) as f:
        doc = json.load(f)
    assert doc["interrupted"] == signal.SIGTERM
    assert len(doc["rows"]) >= final[0]
    assert os.path.getsize(tmp_path / "m.jsonl") > 0
