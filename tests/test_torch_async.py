"""The port's continuous-time async server (``mode="async"``), within the
port.

The server object's ledger protocol, the per-merge conservation invariant
and mode validation, as the JAX tests hold them
(``tests/test_async_server.py``).  Synchronized arrivals
(``max_staleness=0``) reproduce the sync buffered path BIT-exactly on both
paths and with a KD slave; unbounded staleness runs ahead.  The parity
with the JAX package is ``tests/test_torch_async_jax.py``.
"""
import numpy as np
import pytest

from _torch_sim_common import (CFG, FUSED_SEED, N_PART, POLICY_SEED, WIDTH,
                               federation, host_rows, run_port)
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core import server as t_srv
from repro_torch.core.families import cnn_family
from repro_torch.core.resources import participants_from_matrix
from repro_torch.core.tree import tree_leaves
from repro_torch.obs import make_observability
from repro_torch.sim import (AsyncPlaneServer, ClusterClock, HeterogeneitySim,
                             SimConfig, make_trace)
from repro_torch.sim.report import ClusterRoundStats


# ------------------------------------------------------------ server object
def test_async_server_ledger_protocol():
    bank = []
    srv = AsyncPlaneServer(0, state="s0", ledger=bank)
    assert srv.pull() == ("s0", 0)
    bank.append({"pid": 7, "round": 0, "n_eff": 3, "plane": None})
    assert srv.ripe() == []          # banked AT the current version: not ripe
    srv.commit("s1", 2)
    assert srv.pull() == ("s1", 2) and srv.merges == 1
    assert len(srv.ripe()) == 1 and srv.lag_of(bank[0]) == 2
    bank.append({"pid": 8, "round": 2, "n_eff": 1, "plane": None})
    srv.drop_ripe()
    assert [b["pid"] for b in bank] == [8]
    assert srv.ledger is bank        # in place: the engine's alias survives


def test_cluster_clock():
    c = ClusterClock()
    c.advance(1.5, rounds=2)
    c.advance(0.5)
    assert (c.now, c.round) == (2.0, 2)


def test_conservation_invariant_raises():
    ok = ClusterRoundStats(level=0, time=1.0, active=[0, 1], dropped=[2],
                           offline=[3], banked=[4], unselected=[5])
    HeterogeneitySim._check_conservation(ok, 6, 0)
    with pytest.raises(RuntimeError, match="conservation"):
        HeterogeneitySim._check_conservation(ok, 7, 0)


def _port_engine(R, compact_to=2):
    """The parity tests' federation on the port alone (no JAX engine)."""
    V, n_data, cd, test = federation()
    kw = dict(CFG, rounds_per_dispatch=R, aggregation="buffered",
              compact_to=compact_to)
    t = t_srv.FedRAC(participants_from_matrix(V, n_data=n_data), cd,
                     cnn_family(base_width=WIDTH), t_srv.FLConfig(**kw),
                     classes=10, device="cpu").setup()
    return t, test


def test_async_mode_validation():
    t, _ = _port_engine(1)
    trace = make_trace("stable", N_PART, 2)
    with pytest.raises(ValueError, match="parallel"):
        HeterogeneitySim(t, trace, SimConfig(rounds=2, mode="async",
                                             schedule="sequential"))
    with pytest.raises(ValueError, match="mode"):
        HeterogeneitySim(t, trace, SimConfig(rounds=2, mode="bogus"))


# ------------------------------------------------------------ port anchor
def _port_run(R, seed, rounds=4, compact_to=2, **sim_kw):
    t, test = _port_engine(R, compact_to)
    trace = make_trace("mixed", N_PART, rounds, seed=seed)
    obs = make_observability(trace=False)
    sim, rep = run_port(t, test, trace, "buffer", obs=obs, rounds=rounds,
                        **sim_kw)
    params = {l: [x.numpy() for x in tree_leaves(p)]
              for l, p in sim.params.items()}
    losses = [c.mean_loss for r in rep.rows for c in r.clusters]
    accs = [c.acc for r in rep.rows for c in r.clusters]
    return t, rep, params, losses, accs


@pytest.mark.parametrize("R,compact_to,rounds", [
    (1, 2, 4), (8, 2, 4), (8, 1, 6), (2, 2, 6)],
    ids=["R1-kd", "R8-kd", "R8-one-cluster", "R2-kd-fused"])
def test_async_barrier_is_bit_equal_to_sync_buffered(R, compact_to, rounds):
    """``max_staleness=0`` (every cluster merges at the shared barrier)
    reproduces the sync buffered engine BIT-exactly: final planes, mean
    losses, accuracies and every record's host fields.  A record's
    ``t_start`` is the earliest of the clusters' own clocks, which equals
    the sync engine's barrier clock with one cluster only.  With a KD
    slave the teacher rides ``MasterBlock``: at the barrier the slave's
    block aligns with the master's and gets the exact per-round teacher
    stack."""
    seed = FUSED_SEED if R == 2 else POLICY_SEED
    t, rep_s, ps, ls, acc_s = _port_run(R, seed, rounds, compact_to)
    _, rep_a, pa, la, acc_a = _port_run(R, seed, rounds, compact_to,
                                        mode="async", max_staleness=0)
    rows_s, rows_a = host_rows(rep_s), host_rows(rep_a)
    if compact_to > 1:
        rows_s = [r[:1] + r[2:] for r in rows_s]
        rows_a = [r[:1] + r[2:] for r in rows_a]
    assert rows_a == rows_s
    assert np.array_equal(ls, la, equal_nan=True)
    assert acc_a == acc_s
    for lvl in ps:
        for x, y in zip(ps[lvl], pa[lvl]):
            assert np.array_equal(x, y), f"L{lvl} not bit-equal"
    assert rep_a.registry.counter("async/merges").value > 0
    if compact_to == 2:
        assert len(t.assignment.members[1]) > 0, "no KD slave"


def test_async_unbounded_staleness_runs_ahead():
    """``max_staleness=None``: clusters run on their own clocks, so the
    faster one runs ahead of the slowest (a version lag > 0), ledger
    entries merge at a version lag, and the async wall clock (the slowest
    cluster's own clock) is below the barrier schedule's on this trace."""
    _, rep_s, *_ = _port_run(2, FUSED_SEED, rounds=6)
    _, rep_a, pa, _, _ = _port_run(2, FUSED_SEED, rounds=6, mode="async",
                                   max_staleness=None)
    reg = rep_a.registry
    assert max(reg.gauge(f"async/version_lag/{l}").value
               for l in (0, 1)) > 0
    assert (reg.gauge("async/wall_clock_s").value
            < rep_s.summary()["wall_clock_s"])
    assert reg.histogram("async/staleness").min >= 1
    assert reg.histogram("async/staleness").count > 0
    assert len(rep_a.rows) == 6
    assert all(np.isfinite(x).all() for lvl in pa for x in pa[lvl])
    assert rep_a.summary()["banked_total"] == rep_a.summary()["flushed_total"]
