"""Rank-side halves of ``tests/test_torch_tp_families.py``: the smoke
configurations it holds (granite-moe with capacity or expert-parallel
dispatch, jamba, xlstm-350m, seamless-m4t-medium), their token federation,
and what each rank of the 4-rank gloo world computes.  Like
``_torch_tp_common``, whose meshes, schedule and scenario it shares, this
module imports neither JAX nor the JAX package.
"""
import numpy as np
import torch

from _torch_mesh_common import FedaggShapes, InjectedFedRAC
from _torch_tp_common import (CFG, MESHES, KINDS, TokenHooks, make_mesh,
                              scenario)
from repro_torch.configs import get_config
from repro_torch.core import server as t_srv
from repro_torch.core.families import lm_family
from repro_torch.core.plane import make_tp_plane_spec
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.core.scaling import compress_config
from repro_torch.core.tree import tree_map
from repro_torch.data.synthetic import lm_batches, make_lm_corpus
from repro_torch.models import moe, tp, transformer

SEED, N_LM, WINDOW = 3, 8, 9
# capacity dispatch in groups of one window at capacity factor 0.5: 18
# routing choices for 4 experts of 4 slots (2 of 5 at level 1), so tokens
# are dropped; ``moe_chunk_groups=1`` runs the groups one chunk at a time
CAP = dict(moe_impl="capacity", moe_group=WINDOW, moe_capacity=0.5)
# name -> (arch, overrides) of the smoke configuration
CONFIGS = {
    "granite": ("granite-moe-1b-a400m", {}),
    "granite-cap": ("granite-moe-1b-a400m", dict(CAP, moe_chunk_groups=1)),
    "granite-ep": ("granite-moe-1b-a400m", dict(moe_shard="ep")),
    "granite-ep-cap": ("granite-moe-1b-a400m",
                       dict(CAP, moe_shard="ep", moe_chunk_groups=1)),
    "jamba": ("jamba-v0.1-52b", {}),
    "xlstm": ("xlstm-350m", {}),
    "xlstm-chunk": ("xlstm-350m", dict(mlstm_impl="chunk")),
    # 2 heads: at a model axis of 4 the mLSTM's d_inner and the sLSTM's wx
    # split but their heads do not (the cut tensors are gathered)
    "xlstm-h2": ("xlstm-350m", dict(n_heads=2, n_kv_heads=2)),
    "seamless": ("seamless-m4t-medium", {}),
}
# the member-gradient cases: (configuration, level).  Level 1 of granite
# holds 2 experts, so "ep" at a model axis of 4 falls back to the d_ff split
GRAD_CASES = [(n, 0) for n in CONFIGS] + [("granite-ep", 1),
                                          ("granite-ep-cap", 1)]
# the meshes of the member-gradient cases (2x2's model axis is 1x2's)
GRAD_MESHES = ("1x2", "1x4")
# the dispatch path's families: name -> configuration, and its runs
# (family, mesh, kind): granite-moe on every mesh, jamba and xlstm-350m on
# 1x2 (the member-gradient cases take them to 1x4)
FAMILIES = {"granite": "granite-cap", "jamba": "jamba", "xlstm": "xlstm"}
RUNS = ([("granite", s, k) for s in MESHES for k in KINDS]
        + [(n, "1x2", k) for n in ("jamba", "xlstm") for k in KINDS])


def config(name):
    arch, kw = CONFIGS[name]
    return get_config(arch, smoke=True).replace(**kw)


def family(name):
    return lm_family(config(name), 0.5)


def federation():
    """8 members of 16 windows of 9 tokens (token ids below 64)."""
    corpus = make_lm_corpus(64, 4_000, seed=0)
    cd = [{"tokens": lm_batches(ch, 16, WINDOW, 1, seed=i)[0]}
          for i, ch in enumerate(np.array_split(corpus, N_LM))]
    V = TABLE_III[np.random.default_rng(SEED).integers(0, 40, N_LM)]
    test = {"tokens": lm_batches(corpus, 8, WINDOW, 1, seed=99)[0]}
    return V, [16] * N_LM, cd, test


def make_engine(cls, name, kind, mesh=None):
    V, n_data, cd, test = federation()
    cfg = t_srv.FLConfig(**dict(CFG, aggregation=kind, class_balanced=False))
    cls = type(f"Token{cls.__name__}", (TokenHooks, cls), {})
    eng = cls(participants_from_matrix(V, n_data=n_data), cd,
              family(FAMILIES[name]), cfg, classes=64, device="cpu",
              mesh=mesh).setup()
    return eng, test


# ------------------------------------------------------------ gradients
def grad_inputs(name, level):
    """The configuration's level parameters for 2 members and their token
    batches (3 windows each)."""
    fam = family(name)
    p = fam.init(torch.Generator().manual_seed(1), level)
    stack = tree_map(lambda x: torch.stack([x, 1.01 * x]), p)
    toks = torch.randint(0, 64, (2, 3, WINDOW),
                         generator=torch.Generator().manual_seed(2))
    return fam, p, stack, toks


def member_grads(fam, level, params, toks):
    """``vmap(grad)`` over members of the family's loss and KD logits."""
    def loss(p, t):
        ce, kd = fam.loss_and_logits(level, p, {"tokens": t})
        return ce + 0.1 * kd.square().mean()
    return torch.func.vmap(torch.func.grad(loss))(params, toks)


class Routing:
    """Records, while entered, every router top-k: the choices and the
    gap between the k-th and the (k+1)-th probability of each token."""

    def __init__(self):
        self.calls, self._orig = [], moe.top_k

    def __enter__(self):
        def rec(probs, k):
            vals, idx = self._orig(probs, k)
            s = torch.sort(probs, dim=-1, descending=True).values
            gap = (s[..., k - 1] - s[..., k] if k < s.shape[-1]
                   else torch.full(s.shape[:-1], torch.inf))
            self.calls.append((idx.numpy(), gap.numpy()))
            return vals, idx
        moe.top_k = rec
        return self

    def __exit__(self, *exc):
        moe.top_k = self._orig


def grads_tp(mesh, name, level):
    """This rank's chunk of the member gradients under the TP forward, and
    the routing choices of member 0's forward."""
    fam, p, stack, toks = grad_inputs(name, level)
    with tp.tp_shard_ctx(mesh, "model"):
        m, r = tp.tp_size(), tp.tp_rank()
        spec = make_tp_plane_spec(p, fam.param_specs(level, p, m, "model"),
                                  msize=m)
        chunk = spec.to_plane(stack).reshape(2, m, spec.d_loc)[:, r]
        loc = spec.local_params(chunk)
        g = member_grads(fam, level, loc, toks)
        rt = level_routing(name, level, tree_map(lambda x: x[0], loc),
                           toks[0])
    return spec.local_to_chunk(g).numpy(), rt


def level_routing(name, level, params, toks):
    """The top-k calls of one member's forward at ``level`` (no vmap, no
    gradient)."""
    with Routing() as rt, torch.no_grad():
        transformer.forward(compress_config(config(name), 0.5, level),
                            params, toks)
    return rt.calls


# ------------------------------------------------------------ the rank
def tp_families_rank(rank, init_trees, draws, inputs, grad_cases, runs):
    """The member-gradient cases ``grad_cases`` on their meshes, then the
    (family, mesh, kind) runs ``runs`` of the dispatch path: the run's
    results in the unsharded layout, and the fedagg shapes."""
    out = {}
    for shape in GRAD_MESHES:
        for name, level in grad_cases:
            out[(name, level, shape)] = grads_tp(make_mesh(shape), name,
                                                 level)
    for name, shape, kind in runs:
        InjectedFedRAC.init_trees = init_trees[name]
        InjectedFedRAC.draws = draws[name]
        eng, test = make_engine(InjectedFedRAC, name, kind,
                                mesh=make_mesh(shape))
        assert eng._tp
        with FedaggShapes() as rec:
            res = scenario(eng, test, inputs[name, kind], kind)
        res["fedagg"] = rec.shapes
        res["capacity"] = {lvl: eng._capacity(len(m))
                           for lvl, m in eng.assignment.members.items()}
        res["d_loc"] = {lvl: eng.plane_spec(lvl).d_loc
                        for lvl in eng.assignment.members}
        out[(name, shape, kind)] = res
    return out
