"""Port parity of the engine parts only the simulator drives (ROADMAP item
7a): the buffered one-round path (``cluster_round(buffered=...,
return_stack=...)``, with its stack-only and bank-only rounds), banked
dispatch blocks with per-round teacher planes, delta shard packs, the
per-pid reference loop, plane donation and the observability hooks.

JAX and port engines run the simulator tests' federation
(``_torch_sim_common``) from the same parameters, and on the dispatch path
from the same batch-index draws; results agree at rtol 2e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sim_common import ATOL, RTOL, SEED, engines
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import interop
from repro_torch.core import server as t_srv
from repro_torch.core.families import mlp_family
from repro_torch.core.tree import tree_leaves
from repro_torch.obs import Observability, Tracer, make_observability


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def pair():
    return engines(2, "buffer")


def _carried(j, level, key):
    """A params pytree of one level in both packages, from a JAX draw."""
    pj = j.family.init(jax.random.PRNGKey(key), level)
    return pj, interop.params_from_numpy(jax.tree.map(np.asarray, pj))


# ------------------------------------------------------------ one round
@pytest.mark.parametrize("case", ["live", "live_kd", "stack_only",
                                  "bank_only", "bank_and_stack"])
def test_cluster_round_buffered_matches_jax(pair, case):
    j, t, _ = pair
    level = 1 if case == "live_kd" else 0
    members = j.assignment.members[level]
    C = len(members)
    pj, pt = _carried(j, level, SEED + level)
    contribs = [_carried(j, level, k) for k in (7, 8)]
    us = [1.25, 0.5]
    masks = np.ones((C, j.cfg.steps_per_round), np.float32)
    masks[0, 1:] = 0.0                       # a masked member: one step
    weights = np.array([j.assignment.n_eff[p] for p in members], np.float32)
    buffered = case in ("live", "live_kd", "bank_only", "bank_and_stack")
    if case in ("stack_only", "bank_only", "bank_and_stack"):
        weights[:] = 0.0                     # no live contributor
    else:
        weights[-1] = 0.0                    # one banked member
    return_stack = case != "bank_only"
    teacher_j = teacher_t = None
    if level:
        teacher_j, teacher_t = _carried(j, 0, 42)
    kw = dict(step_masks=masks, weights=weights, return_stack=return_stack)
    oj = j.cluster_round(level, members, pj, 3, teacher=teacher_j,
                         buffered=([(c[0], u) for c, u in zip(contribs, us)]
                                   if buffered else None), **kw)
    ot = t.cluster_round(level, members, pt, 3, teacher=teacher_t,
                         buffered=([(c[1], u) for c, u in zip(contribs, us)]
                                   if buffered else None), **kw)
    assert len(ot) == len(oj) == (3 if return_stack else 2)
    _close(j.plane_of(level, oj[0]), t.plane_of(level, ot[0]))
    _close(oj[1], ot[1])
    assert tuple(ot[1].shape) == (C,)
    if case == "stack_only":
        # nothing aggregates: the params come back as they went in
        assert ot[0] is pt
    if return_stack:
        sj = jax.vmap(lambda p: j.plane_of(level, p))(oj[2])
        _close(sj, t.plane_of(level, ot[2]))
        assert tree_leaves(ot[2])[0].shape[0] == t._capacity(C)


# ------------------------------------------------------------ dispatch
def _plane_pair(j, level, key):
    pj = j.plane_of(level, j.family.init(jax.random.PRNGKey(key), level))
    return pj, interop.plane_from_numpy(np.asarray(pj))


@pytest.mark.parametrize("level", [0, 1])
def test_dispatch_banked_block_matches_jax(pair, level):
    """One R = 2 banked block: rows enter the bank, member 0 is re-banked
    every round; the slave takes a per-round teacher stack.  The entering
    rows lie near the plane, as banked updates (a few local steps from it)
    do: rows far from it, such as other random draws, put a ReLU or
    max-pool kink inside the round's rounding error, where the JAX package
    alone moves by 5e-5 under a 1e-7 relative nudge of its input."""
    j, t, _ = pair
    members = j.assignment.members[level]
    C, cap = len(members), t._capacity(len(members))
    plane_j, plane_t = _plane_pair(j, level, SEED + level)
    n_rows = min(2, cap)
    noise = np.random.default_rng(5).standard_normal((cap, plane_t.shape[0]))
    rows = (plane_t.numpy()[None] * (1.0 + 0.02 * noise)).astype(np.float32)
    rows[n_rows:] = 0.0
    bank_w = np.zeros(cap, np.float32)
    bank_w[:n_rows] = [0.9, 0.36][:n_rows]
    gain = np.zeros(cap, np.float32)
    gain[0] = 0.6 * j.assignment.n_eff[members[0]]
    weights = np.array([j.assignment.n_eff[p] for p in members], np.float32)
    weights[0] = 0.0
    kw_j, kw_t = {}, {}
    if level:
        stack = np.stack([np.asarray(_plane_pair(j, 0, k)[0])
                          for k in (42, 43)])
        kw_j["teacher_planes"] = jnp.asarray(stack)
        kw_t["teacher_planes"] = interop.plane_from_numpy(stack)
    oj = j.dispatch_rounds(level, members, plane_j, 0, 2, weights=weights,
                           bank=(jnp.asarray(rows), jnp.asarray(bank_w),
                                 jnp.asarray(gain)),
                           want_history=True, **kw_j)
    ot = t.dispatch_rounds(level, members, plane_t, 0, 2, weights=weights,
                           bank=(torch.tensor(rows), torch.tensor(bank_w),
                                 torch.tensor(gain)),
                           want_history=True, **kw_t)
    assert tuple(ot.losses.shape) == (2, C)
    _close(oj.losses, ot.losses)
    _close(oj.history, ot.history)
    _close(oj.plane, ot.plane)
    _close(oj.bank[0], ot.bank[0])
    _close(oj.bank[1], ot.bank[1])


def test_dispatch_teacher_planes_length_must_match(pair):
    _, t, _ = pair
    members = t.assignment.members[1]
    plane = t.plane_of(1, t.init_params(1))
    stack = t.plane_of(0, t.init_params(0))[None].expand(3, -1)
    with pytest.raises(ValueError, match="3 rounds for a 2-round block"):
        t.dispatch_rounds(1, members, plane, 0, 2, teacher_planes=stack)


@pytest.mark.parametrize("donate", [True, False])
def test_dispatch_donation_writes_into_the_input_plane(donate):
    _, t, _ = engines(2, "buffer", cls=t_srv.FedRAC, donate_plane=donate)
    members = t.assignment.members[0]
    plane = t.plane_of(0, t.init_params(0))
    before = plane.clone()
    out = t.dispatch_rounds(0, members, plane, 0, 2)
    assert (out.plane is plane) == donate
    torch.testing.assert_close(plane, out.plane if donate else before,
                               rtol=0, atol=0)
    assert not torch.equal(out.plane, before)


# ------------------------------------------------------------ shard packs
def test_delta_shard_pack_equals_full_build_and_jax(pair):
    """Membership churn at one capacity: the delta pack (surviving rows
    permuted on the device, the new member's shard copied) equals a full
    build, and the JAX package's pack."""
    j, _, _ = pair
    _, t, _ = engines(2, "buffer", cls=t_srv.FedRAC)
    t.obs = make_observability()
    members = list(j.assignment.members[0])
    outsider = j.assignment.members[1][0]
    churned = [members[2], members[0], outsider] + members[3:]
    cap = t._capacity(len(members))
    assert t._capacity(len(churned)) == cap
    t._shard_pack(0, members, cap, True)
    delta = t._shard_pack(0, churned, cap, True)
    reg = t.obs.registry
    assert reg.counters["fl/pack_builds"].value == 2
    assert reg.counters["fl/pack_delta"].value == 1
    _, full_eng, _ = engines(2, "buffer", cls=t_srv.FedRAC)
    full = full_eng._shard_pack(0, churned, cap, True)
    j._shard_pack(0, members, cap, True)
    want = j._shard_pack(0, churned, cap, True)
    for k in ("x", "y"):
        torch.testing.assert_close(delta["shards"][k], full["shards"][k],
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(delta["shards"][k].numpy(),
                                      np.asarray(want["shards"][k]))
    for k in ("n", "tables", "counts"):
        np.testing.assert_array_equal(delta[k], full[k])
        np.testing.assert_array_equal(delta[k], np.asarray(want[k]))
    spans = [e["name"] for e in t.obs.tracer.events()]
    assert spans.count("pack_h2d") == 2


# ------------------------------------------------------------ loop
def test_train_cluster_loop_equals_vmapped_and_jax():
    """``vmap_clusters=False`` trains member by member: the same params as
    the vmapped one-round path, and as the JAX package's loop."""
    j, loop, test = engines(1, "drop", vmap_clusters=False, rounds=1)
    _, vm, _ = engines(1, "drop", rounds=1)
    rj = j.train({k: jnp.asarray(v) for k, v in test.items()})
    rl, rv = loop.train(test), vm.train(test)
    assert any(k[0] == "loop" for k in loop.compile_stats())
    assert not any(k[0] == "loop" for k in vm.compile_stats())
    for level in rj.final_acc:
        assert abs(rl.final_acc[level] - rj.final_acc[level]) <= \
            1.0 / len(test["y"]) + 1e-9
    for level in loop.cluster_params:
        pl = loop.plane_of(level, loop.cluster_params[level])
        _close(vm.plane_of(level, vm.cluster_params[level]), pl)
        _close(j.plane_of(level, j.cluster_params[level]), pl)


def test_config_contract():
    fam, kw = mlp_family(), dict(classes=10, device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation"):
        t_srv.FedRAC([], [], fam, t_srv.FLConfig(aggregation="async"), **kw)
    with pytest.raises(ValueError, match="vmap_clusters=True"):
        t_srv.FedRAC([], [], fam, t_srv.FLConfig(rounds_per_dispatch=2,
                                                 vmap_clusters=False), **kw)
    t_srv.FedRAC([], [], fam, t_srv.FLConfig(
        rounds_per_dispatch=2, vmap_clusters=False,
        allow_loop_dispatch=True), **kw)
    # a mesh shards the dispatch path: the one-round path refuses it, as
    # JAX's engine does (the mesh itself is tested in test_torch_mesh*.py)
    with pytest.raises(ValueError, match="rounds_per_dispatch>1"):
        t_srv.FedRAC([], [], fam, t_srv.FLConfig(), mesh=object(), **kw)


def test_allow_loop_dispatch_takes_the_dispatch_path():
    _, t, test = engines(2, "drop", cls=t_srv.FedRAC, vmap_clusters=False,
                         allow_loop_dispatch=True, rounds=2)
    t.train(test)
    stats = t.compile_stats()
    assert stats and all(k[0] == "dispatch" for k in stats)


# ------------------------------------------------------------ obs
def test_dispatch_observability_counters_and_spans():
    _, t, _ = engines(2, "buffer", cls=t_srv.FedRAC)
    t.obs = Observability(tracer=Tracer(fence=True))
    members = t.assignment.members[0]
    C = len(members)
    plane = t.plane_of(0, t.init_params(0))
    for r0 in (0, 2):
        plane = t.dispatch_rounds(0, members, plane, r0, 2).plane
    reg = t.obs.registry
    assert reg.counters["fl/dispatch_blocks"].value == 2
    assert reg.counters["fl/dispatch_rounds"].value == 4
    assert reg.counters["fl/d2h_bytes"].value == 2 * (2 * C * 4)
    assert reg.counters["fl/h2d_bytes"].value > 0
    label = f"dispatch_L0_cap{t._capacity(C)}_R2"
    # the program is built once and its first call timed once
    assert reg.counters[f"fl/compiles/{label}"].value == 1
    assert reg.counters["fl/compile_total"].value == 1
    assert reg.gauges[f"fl/compile_s/{label}"].value > 0
    names = [e["name"] for e in t.obs.tracer.events()]
    assert names.count("block_exec") == 2 and names.count("compile") == 1
    assert set(t.compile_stats().values()) == {1}
