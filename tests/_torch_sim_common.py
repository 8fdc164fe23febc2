"""Shared set-up of the port's simulator parity tests
(``test_torch_sim*.py``, ``test_torch_server_buffered.py``): the JAX
simulator tests' federation (``tests/test_sim.py``: 8 participants resampled
from Table III by ``sample_profiles(8, seed=0)``, the CNN at base width
0.125, 500 samples, 3 local steps of batch 8), JAX and port engines on it,
and both simulators run on one trace.

The port engines carry the JAX initial parameters
(``_torch_fedrac_common.CarriedFedRAC``) and, on the dispatch path, the JAX
batch-index draws (``BridgedFedRAC``).  Host telemetry (MAR decisions,
times, bytes, events) must be exactly equal; losses and parameters agree at
rtol 2e-4 / atol 1e-5; accuracies within one test sample.
"""
import jax.numpy as jnp
import numpy as np

from repro.core import server as j_srv
from repro.core.families import cnn_family as j_cnn_family
from repro.core.resources import participants_from_matrix as j_parts
from repro.sim import HeterogeneitySim as JSim, SimConfig as JSimConfig
from repro.sim import make_trace as j_make_trace
from repro.sim.events import Departure as JDeparture

from _torch_fedrac_common import BridgedFedRAC, CarriedFedRAC  # noqa: F401
from repro_torch.core import server as t_srv
from repro_torch.core.families import cnn_family as t_cnn_family
from repro_torch.core.resources import participants_from_matrix
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification, train_test_split
from repro_torch.sim import (Departure, HeterogeneitySim, SimConfig,
                             make_trace)
from repro_torch.sim.traces import sample_profiles

__all__ = ["BridgedFedRAC", "CarriedFedRAC", "RTOL", "ATOL", "SEED",
           "N_PART", "ROUNDS", "POLICY_SEED", "FUSED_SEED", "CHURN_SEED",
           "engines", "mixed_traces",
           "run_jax", "run_port", "planes", "host_rows",
           "assert_runs_match", "blip_run", "sim_cfg"]

RTOL, ATOL = 2e-4, 1e-5
SEED, N_PART, WIDTH = 0, 8, 0.125
# The "mixed" traces the runs replay (8 participants, 4 rounds), by seed:
# - 12: every policy acts on it (drop and mask cut members, mask grants
#   partial steps, buffer banks three), events in every round;
# - 25: round 1 has no event, so R = 2 fuses rounds 0 and 1 and the bank
#   rides that block;
# - 19: a Procedure-2 migration (p1 drifts from C1 to C2 at round 2).
# Parity at rtol 2e-4 needs a run whose rounds are well conditioned.  Some
# are not: a ReLU input within rounding of zero flips between the
# packages, and one member's update jumps.  At seed 3 (R = 2), at 19 under
# "wait" and at 25 under "mask", and in the all-banked scenario below with 6
# participants, the JAX package alone moves its result by the same amount
# when its input is nudged by 1e-7 (relative): at seed 3's round-2 block
# one member's row moves 2.2e-3 in JAX and between the packages alike.
# The runs compared with JAX here (seed 12 under every policy at R = 1,
# seed 25 at R = 2, the all-banked scenario with 8 participants) stay
# within 0.005 of the tolerance.
POLICY_SEED, FUSED_SEED, CHURN_SEED = 12, 25, 19
ROUNDS = 4
CFG = dict(steps_per_round=3, lr=0.08, seed=SEED, local_batch=8,
           compact_to=2)
HOST_FIELDS = ("level", "time", "active", "dropped", "offline", "masked",
               "violations", "banked", "unselected", "flushed", "bytes")


def federation(n=N_PART):
    ds = make_classification("synth-mnist", 500, seed=SEED)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, n, alpha=2.0, seed=SEED)
    V = sample_profiles(n, seed=SEED)
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return V, [len(p) for p in idx], cd, {"x": test.x, "y": test.y}


def engines(R, policy, cls=BridgedFedRAC, n=N_PART, **extra):
    """(JAX engine, port engine, test set) for one policy at width R."""
    V, n_data, cd, test = federation(n)
    kw = dict(CFG, rounds_per_dispatch=R,
              aggregation="buffered" if policy == "buffer" else "sync")
    kw.update(extra)
    j = j_srv.FedRAC(j_parts(V, n_data=n_data), cd,
                     j_cnn_family(base_width=WIDTH),
                     j_srv.FLConfig(**dict(kw, donate_plane=False)),
                     classes=10).setup()
    t = cls(participants_from_matrix(V, n_data=n_data), cd,
            t_cnn_family(base_width=WIDTH), t_srv.FLConfig(**kw),
            classes=10, device="cpu").setup()
    assert j.assignment.members == t.assignment.members
    return j, t, test


def mixed_traces(seed):
    """The same trace in both packages."""
    return (j_make_trace("mixed", N_PART, ROUNDS, seed=seed),
            make_trace("mixed", N_PART, ROUNDS, seed=seed))


def sim_cfg(policy, schedule="parallel", **kw):
    return dict(dict(rounds=ROUNDS, mar_policy=policy, schedule=schedule,
                     eval_every=2), **kw)


def run_jax(j, test, trace, policy, schedule="parallel", **kw):
    sim = JSim(j, trace, JSimConfig(**sim_cfg(policy, schedule, **kw)))
    rep = sim.run({k: jnp.asarray(v) for k, v in test.items()})
    return sim, rep


def run_port(t, test, trace, policy, schedule="parallel", obs=None, **kw):
    sim = HeterogeneitySim(t, trace,
                           SimConfig(**sim_cfg(policy, schedule, **kw)),
                           obs=obs)
    return sim, sim.run(test)


def planes(eng, params):
    """{level: (D_pad,) numpy plane} of a simulator's final params."""
    return {l: np.asarray(eng.plane_of(l, p)) for l, p in params.items()}


def host_rows(rep):
    """Every record's host fields: the exact part of the telemetry."""
    return [(r.round, r.t_start, r.duration, list(r.events),
             [tuple(getattr(c, f) for f in HOST_FIELDS) for c in r.clusters])
            for r in rep.rows]


def assert_runs_match(rep_j, rep_t, params_j, params_t, n_test):
    """Host fields equal, losses and parameters at rtol, accuracies within
    one test sample."""
    assert host_rows(rep_t) == host_rows(rep_j)
    for rj, rt in zip(rep_j.rows, rep_t.rows):
        for cj, ct in zip(rj.clusters, rt.clusters):
            np.testing.assert_allclose(ct.mean_loss, cj.mean_loss,
                                       rtol=RTOL, atol=ATOL)
            assert (cj.acc is None) == (ct.acc is None)
            if cj.acc is not None:
                assert abs(cj.acc - ct.acc) <= 1.0 / n_test + 1e-9
    assert rep_j.final_acc.keys() == rep_t.final_acc.keys()
    for lvl, a in rep_j.final_acc.items():
        assert abs(a - rep_t.final_acc[lvl]) <= 1.0 / n_test + 1e-9
    assert params_j.keys() == params_t.keys()
    for lvl in params_j:
        np.testing.assert_allclose(params_t[lvl], params_j[lvl],
                                   rtol=RTOL, atol=ATOL)


def _blip_traces():
    """Round 0: every member misses the deadline and is banked; round 1:
    every member is offline, so the ripe bank flushes anchored on the
    current model; round 2: everyone is back."""
    tj = j_make_trace("stable", N_PART, 3)
    tt = make_trace("stable", N_PART, 3)
    for pid in range(N_PART):
        tj.events.append((1.0, JDeparture(pid, rejoin_after=1.0)))
        tt.events.append((1.0, Departure(pid, rejoin_after=1.0)))
    return tj, tt


def blip_run(R):
    """The JAX simulator tests' all-banked, then offline, buffer scenario:
    stack-only rounds (no live weight, the program still runs), an anchored
    flush with no live member and a terminal flush."""
    j, t, test = engines(R, "buffer", compact_to=1, mar=1e9)
    j.specs[0].mar = t.specs[0].mar = 1e-9          # everyone is late
    trace_j, trace_t = _blip_traces()
    sj, rj = run_jax(j, test, trace_j, "buffer", rounds=3, eval_every=0)
    st, rt = run_port(t, test, trace_t, "buffer", rounds=3, eval_every=0)
    assert_runs_match(rj, rt, planes(j, sj.params), planes(t, st.params),
                      len(test["y"]))
    c0, c1 = rt.rows[0].clusters[0], rt.rows[1].clusters[0]
    assert sorted(c0.banked) == list(range(N_PART)) and not c0.active
    assert len(c1.offline) == N_PART and c1.flushed == N_PART
    assert rt.summary()["banked_total"] == rt.summary()["flushed_total"]
    return t, rt
