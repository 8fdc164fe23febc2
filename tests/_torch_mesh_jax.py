"""JAX-side halves of the port's mesh tests (``test_torch_mesh_fedrac.py``,
``test_torch_tp_forward.py``, ``test_torch_tp_families.py``): the unsharded
port engine that takes and records JAX's batch-index draws, the banked
blocks' inputs drawn from a JAX engine, the token-only JAX engine, and the
run the JAX engine is held to (single device, no mesh: JAX's own mesh
path fails under JAX 0.9.0, ROADMAP C2)."""
import jax
import jax.numpy as jnp
import numpy as np

from jax.flatten_util import ravel_pytree

from repro.core import server as j_srv
from repro.data import device_sampler as j_ds

from _torch_mesh_common import InjectedFedRAC


class RecordingBridgedFedRAC(InjectedFedRAC):
    """The unsharded port run: JAX's draws, recorded for the mesh ranks."""

    def _draw_indices(self, pack, r, balanced):
        key = j_ds.round_key(self.cfg.seed, r)
        S, B = self.cfg.steps_per_round, self.cfg.local_batch
        if balanced:
            idx = j_ds.balanced_indices(key, S, B,
                                        jnp.asarray(pack["tables"]),
                                        jnp.asarray(pack["counts"]))
        else:
            idx = j_ds.uniform_indices(key, S, B,
                                       jnp.asarray(pack["n"], jnp.int32))
        idx = np.asarray(idx)
        self.draws[(pack["level"], r)] = idx
        return idx


def jax_inputs(j):
    """The banked blocks' inputs (true lengths): each level's plane from a
    JAX draw, bank rows near it (as banked updates lie), bank and member
    weights, and the slave's two-round teacher stack."""
    inputs = {}
    for lvl in (0, 1):
        members = j.assignment.members[lvl]
        C = len(members)
        spec = j.plane_spec(lvl)
        plane = np.asarray(j.plane_of(lvl, j.family.init(
            jax.random.PRNGKey(11 + lvl), lvl)))[:spec.d]
        noise = np.random.default_rng(5 + lvl).standard_normal((C, spec.d))
        rows = (plane[None] * (1.0 + 0.02 * noise)).astype(np.float32)
        rows[2:] = 0.0
        bank_w = np.zeros(C, np.float32)
        bank_w[:2] = [0.9, 0.36]
        gain = np.zeros(C, np.float32)
        gain[0] = 0.6 * j.assignment.n_eff[members[0]]
        weights = np.array([j.assignment.n_eff[p] for p in members],
                           np.float32)
        weights[0] = 0.0
        inputs.update({("plane", lvl): plane, ("rows", lvl): rows,
                       ("bank_w", lvl): bank_w, ("gain", lvl): gain,
                       ("weights", lvl): weights})
    inputs["teacher"] = np.stack([np.asarray(j.plane_of(0, j.family.init(
        jax.random.PRNGKey(k), 0)))[:j.plane_spec(0).d] for k in (42, 43)])
    return inputs


def jax_scenario(j, test, inputs, kind):
    """``scenario`` on the JAX engine (single device, no mesh)."""
    out = {}
    if kind == "sync":
        res = j.train({k: jnp.asarray(v) for k, v in test.items()})
        for lvl, p in j.cluster_params.items():
            out[("plane", lvl)] = np.asarray(
                j.plane_of(lvl, p))[:j.plane_spec(lvl).d]
        out["history"] = res.history
        return out
    for lvl in (0, 1):
        members = j.assignment.members[lvl]
        C, cap = len(members), j._capacity(len(members))
        spec = j.plane_spec(lvl)

        def pad(x, shape):
            o = np.zeros(shape, np.float32)
            o[tuple(slice(0, s) for s in np.shape(x))] = x
            return jnp.asarray(o)
        kw = {}
        if lvl:
            kw["teacher_planes"] = pad(inputs["teacher"],
                                       (2, j.plane_spec(0).d_pad))
        o = j.dispatch_rounds(
            lvl, members, pad(inputs["plane", lvl], (spec.d_pad,)), 0, 2,
            weights=inputs["weights", lvl],
            bank=(pad(inputs["rows", lvl], (cap, spec.d_pad)),
                  pad(inputs["bank_w", lvl], (cap,)),
                  pad(inputs["gain", lvl], (cap,))),
            want_history=True, **kw)
        out[("plane", lvl)] = np.asarray(o.plane)[:spec.d]
        out[("losses", lvl)] = np.asarray(o.losses)
        out[("history", lvl)] = np.asarray(o.history)[:, :spec.d]
        out[("bank", lvl)] = np.asarray(o.bank[0])[:C, :spec.d]
        out[("bank_w", lvl)] = np.asarray(o.bank[1])[:C]
    return out


class JTokenFedRAC(j_srv.FedRAC):
    """JAX's engine on token-only data: the KD hard label is the last
    token, evaluation is -loss."""

    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        loss, _ = self.family.loss_and_logits(level, params, test)
        return -float(loss)


class JaxDraws:
    """What ``jax_inputs`` reads of a JAX engine: the port engine's
    assignment (asserted equal to JAX's where both run), JAX's family and
    its ravel, so the banked inputs need no JAX engine set up."""

    def __init__(self, t, family):
        self.assignment, self.family, self._t = t.assignment, family, t

    def plane_spec(self, lvl):
        return self._t.plane_spec(lvl)

    def plane_of(self, lvl, params):
        return ravel_pytree(params)[0]
