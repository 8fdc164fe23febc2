"""Rank-side halves of ``tests/test_torch_tp_forward*.py``: the federations
it runs (the MLP, the CNN and a small dense LM), the run every engine is
held to with planes carried in the unsharded layout, and what each rank
of the 4-rank gloo world computes.  Like ``_torch_mesh_common``, this
module imports neither JAX nor the JAX package.

One world of 4 ranks holds the three meshes: ``2x2`` and ``1x4`` over the
whole world, and ``1x2`` as two replicas of a 1x2 mesh side by side (a
leading ``replica`` dim no engine reads).
"""
import numpy as np
import torch

from _torch_mesh_common import FedaggShapes, InjectedFedRAC, federation
from repro_torch.configs.base import ModelConfig
from repro_torch.core import server as t_srv
from repro_torch.core.families import cnn_family, lm_family, mlp_family
from repro_torch.core.plane import make_plane_spec, make_tp_plane_spec
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import lm_batches, make_lm_corpus
from repro_torch.launch import sharding
from repro_torch.models import tp

MESHES = ("1x2", "2x2", "1x4")
KINDS = ("sync", "buffered")
SEED = 3
CFG = dict(steps_per_round=2, local_batch=4, lr=0.08, seed=SEED,
           compact_to=2, rounds=2, rounds_per_dispatch=2)
# n_kv_heads 2 of head_dim 8: at a model axis of 4 wk's 16 columns split
# 4 to a rank, cutting through a head (the K/V heads are gathered)
LM = dict(name="tp-lm", family="dense", n_layers=2, d_model=32, n_heads=4,
          n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64, rope_theta=1e4,
          qk_norm=True, attn_impl="pallas")
N_LM = 8
# the member-gradient cases of the small LM: remat wrapping the split
# superblock; and 6 query heads over 3 K/V heads, whose query groups
# straddle the ranks at a model axis of 2 (each rank gathers K/V and reads
# one K/V head per query head by an index list) and whose query heads do
# not split at 4 (wq's 48 columns do: the attention runs whole on every
# rank and its output is sliced for the row-parallel wo)
LM_GRAD_CASES = {"remat": dict(remat=True),
                 "heads": dict(n_heads=6, n_kv_heads=3)}
# family -> the meshes it runs on (1x4 splits the LM's K/V heads)
FAMILIES = {"mlp": MESHES, "cnn": MESHES, "lm": MESHES, "cnn-odd": ("1x2",)}


def make_family(name):
    if name == "mlp":
        return mlp_family()
    if name == "cnn":
        # widths 8, 4, 8, 16, 32: every leaf splits at 2 and at 4
        return cnn_family(base_width=0.0625)
    if name == "cnn-odd":
        # widths 13, 6, 13, 26, 51: the odd convs' input splits and the
        # head's rows are demoted at 2, so activations are gathered and
        # sliced between layers
        return cnn_family(base_width=0.1)
    return lm_family(ModelConfig(**LM), 0.5)


def lm_federation():
    """8 members of 32 windows of 17 tokens (vocabulary 64)."""
    corpus = make_lm_corpus(64, 8_000, seed=0)
    cd = [{"tokens": lm_batches(ch, 32, 17, 1, seed=i)[0]}
          for i, ch in enumerate(np.array_split(corpus, N_LM))]
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_LM)]
    test = {"tokens": lm_batches(corpus, 8, 17, 1, seed=99)[0]}
    return V, [32] * N_LM, cd, test


class TokenHooks:
    """Token-only data: ``_batch_from_gathered`` adds the KD hard label;
    evaluation is -loss."""

    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        test = self._to_device(test)
        with torch.no_grad():
            loss, _ = self.family.loss_and_logits(level, params, test)
        return -float(loss)


class RecordingPortFedRAC(InjectedFedRAC):
    """The unsharded port run on the port's own batch-index draws,
    recorded for the mesh ranks (for the families not held to JAX
    here)."""

    def _draw_indices(self, pack, r, balanced):
        idx = t_srv.FedRAC._draw_indices(self, pack, r, balanced)
        self.draws[(pack["level"], r)] = idx
        return idx


def engine_cls(name, base=InjectedFedRAC):
    """The engine class of a family: token hooks for the LM."""
    if name != "lm":
        return base
    return type(f"Token{base.__name__}", (TokenHooks, base), {})


def make_engine(cls, name, kind, mesh=None, **extra):
    V, n_data, cd, test = (lm_federation() if name == "lm"
                           else federation())
    cfg = t_srv.FLConfig(**dict(CFG, aggregation=kind,
                                class_balanced=name != "lm", **extra))
    eng = cls(participants_from_matrix(V, n_data=n_data), cd,
              make_family(name), cfg, classes=64 if name == "lm" else 10,
              device="cpu", mesh=mesh).setup()
    return eng, test


def _padded(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in np.shape(x))] = x
    return out


class Layout:
    """An engine's planes <-> the unsharded layout (``make_plane_spec``),
    through the params pytree; identity for an unsharded engine."""

    def __init__(self, eng, lvl):
        self.eng, self.lvl = eng, lvl
        self.flat = make_plane_spec(eng.family.init(
            torch.Generator().manual_seed(0), lvl))

    def to_engine(self, x):
        x = torch.tensor(_padded(x, np.shape(x)[:-1] + (self.flat.d_pad,)))
        return self.eng.plane_of(self.lvl, self.flat.to_params(x))

    def from_engine(self, x):
        return self.flat.to_plane(self.eng.params_of(self.lvl, x))[
            ..., :self.flat.d].numpy()


def scenario(eng, test, inputs: dict, kind: str) -> dict:
    """The run every engine is held to, planes in the unsharded layout:
    ``train()`` for "sync" (FedAvg on the master, the slave under a fixed
    KD teacher); for "buffered", an R = 2 banked block per level (the
    slave on a per-round teacher stack).  With a TP engine, ``replicas``
    holds, for every plane it returned, whether each whole leaf's copies
    are bit-equal across the chunks."""
    out, replicas = {}, []

    def check(lvl, x):
        spec = eng.plane_spec(lvl)
        if hasattr(spec, "local_params"):
            chunks = x.reshape(*x.shape[:-1], spec.msize, spec.d_loc)
            for _, _, k, off, s in spec.recs:
                if k is None:
                    c = chunks[..., off:off + s]
                    replicas.append(bool((c == c[..., :1, :]).all()))

    if kind == "sync":
        res = eng.train(test)
        for lvl, p in eng.cluster_params.items():
            lay = Layout(eng, lvl)
            check(lvl, eng.plane_of(lvl, p))
            out[("plane", lvl)] = lay.flat.to_plane(p)[:lay.flat.d].numpy()
        out["history"] = res.history
        out["replicas"] = replicas
        return out
    for lvl in (0, 1):
        members = eng.assignment.members[lvl]
        C, cap = len(members), eng._capacity(len(members))
        lay = Layout(eng, lvl)
        kw = {}
        if lvl:
            kw["teacher_planes"] = Layout(eng, 0).to_engine(inputs["teacher"])
        o = eng.dispatch_rounds(
            lvl, members, lay.to_engine(inputs["plane", lvl]), 0, 2,
            weights=inputs["weights", lvl],
            bank=(lay.to_engine(_padded(inputs["rows", lvl],
                                        (cap, lay.flat.d))),
                  torch.tensor(_padded(inputs["bank_w", lvl], (cap,))),
                  torch.tensor(_padded(inputs["gain", lvl], (cap,)))),
            want_history=True, **kw)
        for x in (o.plane, o.history, o.bank[0]):
            check(lvl, x)
        out[("plane", lvl)] = lay.from_engine(o.plane)
        out[("losses", lvl)] = o.losses.numpy()
        out[("history", lvl)] = lay.from_engine(o.history)
        out[("bank", lvl)] = lay.from_engine(o.bank[0])[:C]
        out[("bank_w", lvl)] = o.bank[1][:C].numpy()
    out["replicas"] = replicas
    return out


def make_mesh(shape):
    """The 4-rank world's mesh of ``shape`` (dims ``data``, ``model``)."""
    from torch.distributed.device_mesh import DeviceMesh
    n, m = (int(x) for x in shape.split("x"))
    return DeviceMesh("cpu", torch.arange(4).reshape(4 // (n * m), n, m),
                      mesh_dim_names=("replica", "data", "model"))


class ModelGathers:
    """Records the numel of every ``launch.sharding.all_gather`` call
    along ``model`` while it is entered."""

    def __init__(self):
        self.calls = []
        self._orig = sharding.all_gather

    def __enter__(self):
        def rec(mesh, x, axis, dim):
            if axis == "model":
                self.calls.append(int(x.numel()))
            return self._orig(mesh, x, axis, dim)
        sharding.all_gather = rec
        return self

    def __exit__(self, *exc):
        sharding.all_gather = self._orig


# ------------------------------------------------------------ the ops
def op_loss(w1, w2, x):
    z = torch.tanh(x @ w1) @ w2
    return (z ** 2).sum() + z.logsumexp(-1).sum()


def op_inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.randn(3, 5, 8, generator=g),        # (members, B, d) x
            torch.randn(3, 8, 12, generator=g),       # w1 (d, h)
            torch.randn(3, 12, 8, generator=g))       # w2 (h, d)


def op_grads_tp(mesh):
    """The four operations on a column/row-parallel pair with a
    gather/scatter round trip, under ``vmap(grad)`` over 3 members: this
    rank's gradient slices, and a vmapped max over the ranks."""
    x, w1, w2 = op_inputs()
    with tp.tp_shard_ctx(mesh, "model"):
        m, r = tp.tp_size(), tp.tp_rank()
        k = w1.shape[-1] // m

        def loss(w1l, w2l, x):
            z = tp.reduce_from_tp(torch.tanh(tp.copy_to_tp(x) @ w1l) @ w2l)
            z = tp.gather_from_tp(tp.scatter_to_tp(z, -1), -1)
            return (z ** 2).sum() + z.logsumexp(-1).sum()

        g1, g2 = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(
            w1[..., r * k:(r + 1) * k], w2[:, r * k:(r + 1) * k], x)
        mx = torch.func.vmap(tp.max_from_tp)(x + r)
    return g1.numpy(), g2.numpy(), mx.numpy()


def lm_grad_inputs(case):
    """The small LM of ``LM_GRAD_CASES[case]``, its level-0 parameters for
    2 members and their token batches."""
    fam = lm_family(ModelConfig(**dict(LM, **LM_GRAD_CASES[case])), 0.5)
    p = fam.init(torch.Generator().manual_seed(1), 0)
    stack = tree_map(lambda x: torch.stack([x, 1.01 * x]), p)
    toks = torch.randint(0, LM["vocab_size"], (2, 3, 9),
                         generator=torch.Generator().manual_seed(2))
    return fam, p, stack, toks


def lm_member_grads(fam, params, toks):
    """``vmap(grad)`` over members of the LM family's loss (and its KD
    logits), as the engine's member step takes it."""
    def loss(p, t):
        ce, kd = fam.loss_and_logits(0, p, {"tokens": t})
        return ce + 0.1 * kd.square().mean()
    return torch.func.vmap(torch.func.grad(loss))(params, toks)


def lm_grads_tp(mesh, case):
    """This rank's chunk of the ``case`` LM's member gradients under the
    TP forward."""
    fam, p, stack, toks = lm_grad_inputs(case)
    with tp.tp_shard_ctx(mesh, "model"):
        m, r = tp.tp_size(), tp.tp_rank()
        spec = make_tp_plane_spec(p, fam.param_specs(0, p, m, "model"),
                                  msize=m)
        chunk = spec.to_plane(stack).reshape(2, m, spec.d_loc)[:, r]
        g = lm_member_grads(fam, spec.local_params(chunk), toks)
    return spec.local_to_chunk(g).numpy()


# ------------------------------------------------------------ the rank
def tp_rank(rank, init_trees, draws, inputs, meshes=MESHES, moe=True):
    """Every (family, mesh, kind) case of ``meshes`` on this rank: the
    run's results in the unsharded layout, the fedagg shapes, the
    model-axis plane gathers of each block, and the operations' and the
    LM's member gradients; then, with ``moe``, how an MoE engine builds on
    1x2 with and without the TP forward."""
    out = {}
    for shape in meshes:
        out[("ops", shape)] = op_grads_tp(make_mesh(shape))
        for case in LM_GRAD_CASES:
            out[(case, shape)] = lm_grads_tp(make_mesh(shape), case)
    for name, shapes in FAMILIES.items():
        if name not in init_trees:
            continue
        InjectedFedRAC.init_trees = init_trees[name]
        InjectedFedRAC.draws = draws[name]
        cls = engine_cls(name)
        for shape in (s for s in shapes if s in meshes):
            mesh = make_mesh(shape)
            for kind in KINDS:
                if (name, kind) not in inputs:
                    continue
                eng, test = make_engine(cls, name, kind, mesh=mesh)
                assert eng._tp
                with FedaggShapes() as rec, ModelGathers() as gat:
                    res = scenario(eng, test, inputs[name, kind], kind)
                res["fedagg"] = rec.shapes
                res["model_gathers"] = gat.calls
                res["capacity"] = {lvl: eng._capacity(len(m)) for lvl, m in
                                   eng.assignment.members.items()}
                res["d_loc"] = {lvl: eng.plane_spec(lvl).d_loc
                                for lvl in eng.assignment.members}
                out[(name, shape, kind)] = res
    if not moe:
        return out
    # the MoE family on a 2D mesh: it builds with the TP forward (its TP
    # plane layout) and with the column-gather path
    from repro_torch.configs import get_config
    V, n_data, cd, _ = lm_federation()
    moe = lm_family(get_config("granite-moe-1b-a400m", smoke=True), 0.5)
    for tp_forward in (True, False):
        eng = t_srv.FedRAC(participants_from_matrix(V, n_data=n_data), cd,
                           moe, t_srv.FLConfig(**dict(CFG,
                                                      tp_forward=tp_forward)),
                           classes=64, device="cpu", mesh=make_mesh("1x2"))
        out[("moe", tp_forward)] = (eng._tp,
                                    type(eng.plane_spec(0)).__name__)
    return out
