"""The port's continuous-time async server against the JAX package's
(``repro.sim``, ``mode="async"``).

``_torch_sim_common``'s engines carry the JAX initial weights and, on the
dispatch path, the JAX batch draws; both packages replay one trace at
``max_staleness`` 0 (the barrier), 1 and None (independent clocks, stale
teachers, version-lag merges).  Host fields exactly equal, losses and
planes at rtol 2e-4 / atol 1e-5, accuracies within one test sample.
"""
import pytest

from _torch_sim_common import (FUSED_SEED, POLICY_SEED, assert_runs_match,
                               engines, mixed_traces, planes, run_jax,
                               run_port)
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.obs import make_observability


@pytest.mark.parametrize("R,max_staleness", [
    (2, 0), (2, 1), (2, None), (1, None)],
    ids=["R2-barrier", "R2-lead1", "R2-unbounded", "R1-unbounded"])
def test_async_matches_jax(R, max_staleness):
    """Port async against JAX async on one trace (seed 25 at R = 2: rounds
    0 and 1 fuse; seed 12 at R = 1; both well conditioned, as
    ``_torch_sim_common`` explains)."""
    seed = FUSED_SEED if R == 2 else POLICY_SEED
    j, t, test = engines(R, "buffer")
    trace_j, trace_t = mixed_traces(seed)
    kw = dict(mode="async", max_staleness=max_staleness)
    sj, rj = run_jax(j, test, trace_j, "buffer", **kw)
    st, rt = run_port(t, test, trace_t, "buffer",
                      obs=make_observability(trace=False), **kw)
    assert_runs_match(rj, rt, planes(j, sj.params), planes(t, st.params),
                      len(test["y"]))
    assert len(t.assignment.members[1]) > 0, "no KD slave"
    assert rt.summary()["banked_total"] == rt.summary()["flushed_total"] > 0
    assert rt.registry.counter("async/merges").value == \
        rj.registry.counter("async/merges").value
