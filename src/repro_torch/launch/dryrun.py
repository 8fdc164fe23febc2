"""Compile analysis of every (arch × input shape × mesh) without a card,
the torch counterpart of ``repro.launch.dryrun``: memory, FLOPs, bytes
accessed and collective traffic of one training, prefill or KD step, or
one Fed-RAC FL round, on the production mesh (``launch.mesh``), for the
roofline.

JAX lowers one GSPMD program for the whole mesh and reads XLA's analyses.
The port has no partitioner: each rank runs an explicit program on its own
blocks (``launch.sharding``'s rules), and every rank of that SPMD program
is alike, so rank 0 stands for all.  ``lower_one`` builds rank 0's program
and the global shapes and specs of its inputs; ``Lowered.analyze`` runs it
under ``FakeTensorMode`` (no tensor holds data, nothing is allocated) in a
``launch.mesh.fake_world`` of the mesh's size, with ``FlopCounterMode``,
``hlo_analysis.record_collectives``, ``hlo_analysis.BytesAccessed`` and
``MemTracker`` watching.  ``Lowered.materialize`` gives the same program
real inputs, so it also runs on a real world (the tests' gloo ranks, the
card).

In ``tp`` mode the parameters are sliced by ``param_specs``, the forward
runs Megatron-split under ``models.tp.tp_shard_ctx(mesh, "model")``, the
batch is the rank's ``batch_specs`` block, gradients are summed over the
axes the batch splits along, the global-norm clip sums the squared norms
of split leaves over their axes, and AdamW updates the local shards in
place (JAX donates them).  Logits split over the vocabulary give a
vocab-parallel loss, CE and KD alike.  An FL round trains the rank's
clients (``P(dp)`` on the client axis), sums their weighted models over
the data axes and hands every client the aggregate, as JAX's round does.

The analysis reaches no kernel, as JAX's reaches no Pallas kernel: the
archs run ``attn_impl="jnp"``, the KD loss is the plain ``kd_loss``, and the
fake tensors lie on the CPU, so the device-routed wrappers
(``kernels/*/ops.py``) take their plain branches.

Memory: ``argument_size_in_bytes`` is the rank's parameter, optimizer and
batch bytes, ``output_size_in_bytes`` its outputs (``alias_size_in_bytes``
of them updated in place), ``temp_size_in_bytes`` MemTracker's peak less
the arguments, ``generated_code_size_in_bytes`` 0.  The output's keys are
JAX's (``repro/launch/dryrun.py::analyze``) but for ``fits_16g``, a TPU's
HBM, which is ``fits_80g`` here: the H100's 80 GB.  Every number is a
prediction from fake tensors and the H100's datasheet, not a measurement.

Decode splits every mixer tensor-parallel over the rank's block of the
cache (``cache_specs``' layouts: "batch", "hd" and "seq"; a batch of 1
splits the sequence over the data axes too): attention's query heads (or,
where they do not divide the axis or the sequence splits, every head
against the rank's slice, the partial softmax combined by ``all_reduce``;
``models.attention.seq_shard_ctx``), Mamba's and the xLSTM cells' state
along its split dim, and the enc-dec model's cross-attention over its
cached encoder K/V alike.  In ``fsdp`` mode (``models.fsdp``) each
parameter is this rank's slice, all-gathered where it is used (inside a
remat'd superblock's recomputation too) and its gradient reduce-scattered;
the batch splits over the data and model axes, and the decode gathers
each leaf and cuts it to its tensor-parallel block.  A program whose
per-token Python loop is longer than ``MAX_LOOP_STEPS`` (xlstm-350m at 4k
and 32k tokens) is traced at the lengths ``SEQ_EXTRAPOLATE`` and its
counts extrapolated along the sequence; its row says
``seq_extrapolated``.  Skipped, as in JAX: ``specs.applicable``'s
long_500k for full-attention archs.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m --fl
  python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scaling import active_param_count, param_count
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import hlo_analysis, sharding, specs
from repro_torch.launch.mesh import (axis_size, fake_world,
                                     make_production_mesh, mesh_shape)
from repro_torch.launch.sharding import P
from repro_torch.models import fsdp, registry, tp
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import optimizers

HBM_BYTES = 80e9          # one H100 SXM5 80GB


# a per-token Python loop (the sLSTM cell, the mLSTM's "scan" route) of
# more steps than this, summed over its layers, is not traced at its
# length (at about 0.3 ms a fake op it would take hours): the program is
# traced at the two sequence lengths SEQ_EXTRAPOLATE and its counts
# extrapolated along the sequence (``_measure``)
MAX_LOOP_STEPS = 1 << 16
SEQ_EXTRAPOLATE = (64, 128)


class NotPorted(Exception):
    """A program the port's analysis does not build (module docstring)."""


def _loop_steps(cfg: ModelConfig, seq: int) -> int:
    """Per-token Python steps of one forward: the recurrent cells' layers
    times the sequence length."""
    n = sum(1 for k in cfg.block_pattern
            if k == "slstm" or (k == "mlstm" and cfg.mlstm_impl == "scan"))
    return n * cfg.n_superblocks * seq


# ------------------------------------------------------------ rank helpers
def _tp_ctx(cfg: ModelConfig, mesh):
    """The Megatron context of a ``tp``-mode program on a model axis of
    more than one rank."""
    if (mesh is None or cfg.shard_mode != "tp"
            or axis_size(mesh, "model") == 1):
        return nullcontext()
    return tp.tp_shard_ctx(mesh, "model")


def _fsdp_ctx(cfg: ModelConfig, mesh, p_spec, tp_spec=None):
    """The FSDP context of an ``fsdp``-mode program: its leaves are
    slices by ``p_spec``, gathered per use (``models.fsdp``)."""
    if mesh is None or cfg.shard_mode != "fsdp":
        return nullcontext()
    return fsdp.fsdp_ctx(mesh, p_spec, tp_spec)


def _value_and_grad(fn, params):
    """``fn(params)`` -> ((out...), grads): the first output's gradient
    with respect to every leaf of ``params`` (zeros where unused)."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    out = fn(params)
    grads = torch.autograd.grad(out[0], leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    for x in leaves:
        x.requires_grad_(False)
    return tuple(o.detach() for o in out), tree_unflatten(params, grads)


def _split_axes(mesh, spec) -> tuple:
    """The mesh axes of more than one rank a spec splits along."""
    return tuple(a for a in sharding.spec_dims(spec)
                 if axis_size(mesh, a) > 1)


def _sum_over(mesh, x, axes):
    for a in axes:
        x = sharding.all_reduce(mesh, x, a)
    return x


def _mean_over(mesh, x, axes):
    """The mean of a per-rank scalar over ``axes`` (a copy)."""
    if mesh is None or not axes:
        return x
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return _sum_over(mesh, x.clone(), axes) / n


def _sync_grads(mesh, grads, axes, fsdp_spec=None):
    """The mean of the ranks' gradients over the batch's split axes.
    ``fsdp_spec``: the leaves are FSDP slices whose gradients the gather's
    backward already summed over their split axes (a reduce-scatter), so
    each is summed over the other batch axes only, and divided by the
    ranks of both."""
    if mesh is None:
        return grads
    leaves = tree_leaves(grads)

    def sync(g, s):
        split = _split_axes(mesh, s)
        n = 1
        for a in set(split) | set(axes):
            n *= axis_size(mesh, a)
        if n == 1:
            return g
        return _sum_over(mesh, g, [a for a in axes if a not in split]).div_(n)

    return tree_unflatten(grads, [sync(g, s) for g, s in zip(
        leaves, _spec_leaves(fsdp_spec) if fsdp_spec is not None
        else [None] * len(leaves))])


def _clip(grads, max_norm: float, mesh, p_spec):
    """``optimizers.clip_by_global_norm`` of the whole gradient: each
    split leaf's squared norm is summed over the axes it splits along."""
    if mesh is None:
        return optimizers.clip_by_global_norm(grads, max_norm)
    groups = {}
    for g, s in zip(tree_leaves(grads), _spec_leaves(p_spec)):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        ax = _split_axes(mesh, s)
        groups[ax] = groups[ax] + sq if ax in groups else sq
    total = sum(_sum_over(mesh, sq, ax) for ax, sq in groups.items())
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _spec_leaves(specs_tree) -> list:
    """A spec pytree's ``Spec`` leaves in ``tree_leaves`` order."""
    if isinstance(specs_tree, sharding.Spec) or specs_tree is None:
        return [specs_tree]
    if isinstance(specs_tree, dict):
        return [s for k in sorted(specs_tree)
                for s in _spec_leaves(specs_tree[k])]
    return [s for v in specs_tree for s in _spec_leaves(v)]


def _kd_vocab(cfg_s: ModelConfig, s_logits, labels, t_logits, *,
              T: float = 2.0, alpha: float = 0.3):
    """``core.distill.kd_loss`` over the padded vocabulary with its valid
    mask; vocab-parallel when the logits are this rank's vocabulary slice
    (``transformer.vocab_split``): the log-sum-exps take one max and one
    sum over the model axis, the KL one more sum."""
    from repro_torch.core.distill import kd_loss
    from repro_torch.models import transformer
    mask = transformer.vocab_mask(cfg_s, s_logits.device)
    if not transformer.vocab_split(cfg_s):
        return kd_loss(s_logits, labels, t_logits, T=T, alpha=alpha,
                       valid_mask=mask[None, None])
    neg = -2.0 ** 30
    v = s_logits.shape[-1]
    mask = mask[tp.tp_rank() * v:(tp.tp_rank() + 1) * v]
    s = torch.where(mask, s_logits.to(torch.float32), neg)
    t = torch.where(mask, t_logits.to(torch.float32), neg)
    ce = tp.vocab_parallel_ce(s, labels.long())

    def lse(x):
        mx = tp.max_from_tp(x.detach().amax(dim=-1))
        return torch.log(tp.reduce_from_tp(
            torch.exp(x - mx[..., None]).sum(dim=-1))) + mx

    ts, ss = t / T, s / T
    lt, ls = ts - lse(ts)[..., None], ss - lse(ss)[..., None]
    kl = tp.reduce_from_tp(torch.sum(torch.exp(lt) * (lt - ls), dim=-1))
    return torch.mean(alpha * ce + (1.0 - alpha) * (T ** 2) * kl)


# ------------------------------------------------------------ the steps
def make_train_step(cfg: ModelConfig, lr: float = 1e-4, *, mesh=None,
                    p_spec=None, batch_axes=()):
    """One rank's AdamW training step (the whole step on one device when
    ``mesh`` is None): ``train_step(params, opt_state, batch)`` ->
    (params, opt_state, ce), the first two updated in place."""
    opt = optimizers.adamw()

    fsdp_spec = p_spec if cfg.shard_mode == "fsdp" else None

    def train_step(params, opt_state, batch):
        with _tp_ctx(cfg, mesh), _fsdp_ctx(cfg, mesh, p_spec):
            (_, ce), grads = _value_and_grad(
                lambda p: registry.loss_fn(cfg, p, batch), params)
        grads = _sync_grads(mesh, grads, batch_axes, fsdp_spec)
        grads = _clip(grads, 1.0, mesh, p_spec)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, _mean_over(mesh, ce, batch_axes)

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, *, mesh=None, p_spec=None):
    def prefill(params, batch):
        with torch.no_grad(), _tp_ctx(cfg, mesh), _fsdp_ctx(cfg, mesh,
                                                             p_spec):
            logits, _ = registry.forward(cfg, params, batch)
        return logits[:, -1]
    return prefill


def make_serve_step(cfg: ModelConfig, *, mesh=None, seq_axes=None,
                    p_spec=None, tp_spec=None, token_axes=()):
    """One rank's decode step: ``serve_step(params, cache, token, pos)``
    -> (logits, cache), every mixer split by its tensor-parallel decode
    over the rank's cache block; ``seq_axes`` ({cache leaf name: axes},
    ``attention.seq_shard_ctx``) where the cache's sequence splits.  In
    ``fsdp`` mode the parameters are slices by ``p_spec``: each is
    gathered where it is used and cut to its ``tp_spec`` block, and the
    token rows split over ``token_axes`` beyond the cache's batch block
    are gathered first, so the decode runs tensor-parallel as in ``tp``
    mode."""
    from repro_torch.models import attention
    fsdp_mode = mesh is not None and cfg.shard_mode == "fsdp"

    def serve_step(params, cache, token, pos):
        seq = (attention.seq_shard_ctx(mesh, seq_axes) if seq_axes
               else nullcontext())
        ctx = _tp_ctx(cfg, mesh)
        if fsdp_mode:
            for a in reversed(token_axes):
                token = sharding.all_gather(mesh, token, a, 0)
            ctx = (tp.tp_shard_ctx(mesh, "model")
                   if axis_size(mesh, "model") > 1 else nullcontext())
        with torch.no_grad(), ctx, seq, _fsdp_ctx(cfg, mesh, p_spec,
                                                  tp_spec):
            return registry.decode_step(cfg, params, cache, token, int(pos))
    return serve_step


def make_kd_train_step(cfg_t: ModelConfig, cfg_s: ModelConfig,
                       lr: float = 1e-4, chunk: int = 0, *, mesh=None,
                       s_spec=None, batch_axes=(), t_spec=None):
    """Master-slave KD training step (the paper's technique on an LM):
    teacher forward (frozen) + student update under the Hinton KD loss over
    the full (padded-)vocab logits.  chunk>0 computes the loss in sequence
    chunks from the final hiddens, never materializing both (B,S,V) logit
    tensors at once.  Returns (kd_step, kd_step_cached), the second taking
    the teacher's logits as an input (the paper's broadcast schedule)."""
    from repro_torch.models import transformer
    opt = optimizers.adamw()

    def full_loss(sp, t_params, batch):
        with torch.no_grad(), _fsdp_ctx(cfg_t, mesh, t_spec):
            t_logits, _ = registry.forward(cfg_t, t_params, batch)
        s_logits, aux = registry.forward(cfg_s, sp, batch)
        lbl = batch["tokens"][:, 1:]
        l = _kd_vocab(cfg_s, s_logits[:, :-1], lbl, t_logits[:, :-1])
        return l + cfg_s.router_aux_coef * aux, l

    def head(cfg, params, h):
        name = "embed" if cfg.tie_embeddings else "lm_head"
        w = fsdp.gather(params[name], (name,))
        if transformer.vocab_split(cfg):
            h = tp.copy_to_tp(h)
        return h @ w.T.to(h.dtype)

    def chunked_loss(sp, t_params, batch):
        with torch.no_grad(), _fsdp_ctx(cfg_t, mesh, t_spec):
            h_t, _ = transformer.forward(cfg_t, t_params, batch["tokens"],
                                         return_hidden=True)
        h_s, aux = transformer.forward(cfg_s, sp, batch["tokens"],
                                       return_hidden=True)
        S = h_s.shape[1]
        n = (S - 1) // chunk
        cut = n * chunk
        tail = (S - 1) - cut
        toks = batch["tokens"]
        total = torch.zeros((), dtype=torch.float32, device=h_s.device)
        for c in range(n):
            sl = slice(c * chunk, (c + 1) * chunk)
            with torch.no_grad(), _fsdp_ctx(cfg_t, mesh, t_spec):
                tl = head(cfg_t, t_params, h_t[:, sl])
            sl_s = head(cfg_s, sp, h_s[:, sl])
            total = total + _kd_vocab(cfg_s, sl_s, toks[:, c * chunk + 1:
                                                        (c + 1) * chunk + 1],
                                      tl)
        # kd_loss is a MEAN over its positions: chunk means combine by
        # token count, the (S-1) mod chunk remainder as a chunk of its own
        l = total * chunk
        if tail:
            with torch.no_grad(), _fsdp_ctx(cfg_t, mesh, t_spec):
                tl = head(cfg_t, t_params, h_t[:, cut:S - 1])
            sl_s = head(cfg_s, sp, h_s[:, cut:S - 1])
            l = l + tail * _kd_vocab(cfg_s, sl_s, toks[:, cut + 1:], tl)
        l = l / (S - 1)
        return l + cfg_s.router_aux_coef * aux, l

    def cached_loss(sp, t_logits, batch):
        s_logits, aux = registry.forward(cfg_s, sp, batch)
        lbl = batch["tokens"][:, 1:]
        l = _kd_vocab(cfg_s, s_logits[:, :-1], lbl, t_logits[:, :-1])
        return l + cfg_s.router_aux_coef * aux, l

    loss = chunked_loss if chunk else full_loss

    def step(loss_fn, teacher, s_params, opt_state, batch):
        with _tp_ctx(cfg_s, mesh), _fsdp_ctx(cfg_s, mesh, s_spec):
            (_, l), grads = _value_and_grad(
                lambda p: loss_fn(p, teacher, batch), s_params)
        grads = _sync_grads(mesh, grads, batch_axes,
                            s_spec if cfg_s.shard_mode == "fsdp" else None)
        grads = _clip(grads, 1.0, mesh, s_spec)
        s_params, opt_state = opt.update(grads, opt_state, s_params, lr)
        return s_params, opt_state, _mean_over(mesh, l, batch_axes)

    def kd_step(t_params, s_params, opt_state, batch):
        return step(loss, t_params, s_params, opt_state, batch)

    def kd_step_cached(t_logits, s_params, opt_state, batch):
        return step(cached_loss, t_logits, s_params, opt_state, batch)

    return kd_step, kd_step_cached


def make_fl_round_step(cfg: ModelConfig, lr: float = 0.05, *, mesh=None,
                       client_axes=()):
    """One Fed-RAC communication round: the rank's client replicas of a
    cluster model train locally (``vmap`` over the client axis), the
    n_i-weighted FedAvg sum runs over the local clients and then over the
    data axes, and every client takes the aggregate (JAX's round as one
    rank's program; ``weights`` arrive whole)."""
    from repro_torch.core.client import local_update

    def round_step(stack, batches, weights):
        def upd(p, b):
            return local_update(lambda pp, bb: registry.loss_fn(cfg, pp, bb),
                                p, b, lr)
        new_stack, losses = torch.func.vmap(upd)(stack, batches)
        C = tree_leaves(new_stack)[0].shape[0]
        w = weights
        if mesh is not None and client_axes:
            w = sharding.local_block(mesh, weights,
                                     {a: 0 for a in client_axes})
        w = w.to(torch.float32)
        agg = tree_map(lambda x: _sum_over(
            mesh, torch.tensordot(w, x.to(torch.float32), dims=([0], [0])),
            client_axes if mesh is not None else ()).to(x.dtype),
            new_stack)
        stack = tree_map(lambda a: a.expand(C, *a.shape), agg)
        loss = _sum_over(mesh, losses.sum(),
                         client_axes if mesh is not None else ())
        return stack, loss / weights.shape[0]

    return round_step


def fl_client_config(cfg: ModelConfig) -> ModelConfig:
    """Edge-client-sized cluster model of the same family (~30M params)."""
    kw = dict(name=cfg.name + "-flclient", n_layers=2 * cfg.period,
              d_model=512, n_heads=8, n_kv_heads=min(8, cfg.n_kv_heads),
              head_dim=64, vocab_size=min(cfg.vocab_size, 32768),
              scan_unroll=True, remat=False)
    if cfg.d_ff:
        kw["d_ff"] = 2048
    if cfg.n_experts:
        kw.update(n_experts=8, experts_per_tok=min(2, cfg.experts_per_tok),
                  moe_impl="dense")
    if cfg.mrope_sections:
        kw["mrope_sections"] = (8, 12, 12)
    c = cfg.replace(**kw)
    c.validate()
    return c


# ------------------------------------------------------------ lowering
@dataclass
class Lowered:
    """One rank's program and its inputs: ``fn(*args)``, each argument a
    pytree of global meta tensors (``launch.specs``) with a pytree of
    ``Spec`` s of the same structure.  ``mesh`` is the mesh the program
    was built for (None: one device)."""
    fn: object
    args: tuple
    arg_specs: tuple
    mesh: object
    opt_args: tuple = ()       # indices of optimizer-state arguments

    def local_args(self):
        """The rank's blocks of the arguments, as meta tensors."""
        def loc(x, s):
            if self.mesh is None:
                return x
            return specs.meta(sharding.local_shape(x.shape, s, self.mesh),
                              x.dtype)
        return tuple(_zip_map(loc, a, s)
                     for a, s in zip(self.args, self.arg_specs))

    def materialize(self, device, seed: int = 0, vocab: int = 2):
        """Real inputs for this rank on ``device``: every global argument
        drawn there from ``seed`` (floats ~ N(0, 0.02²) in their dtype,
        integers below ``vocab``, the optimizer state zero), then this
        rank's block sliced out, so ranks that hold one leaf whole hold
        the same bits."""
        device = torch.device(device)
        g = torch.Generator(device=device).manual_seed(seed)

        def draw(i, x, s):
            kw = dict(dtype=x.dtype, device=device)
            if i in self.opt_args:
                full = torch.zeros(x.shape, **kw)
            elif x.dtype.is_floating_point:
                full = torch.randn(x.shape, generator=g, **kw).mul_(0.02)
            else:
                full = torch.randint(0, vocab, x.shape, generator=g, **kw)
            if self.mesh is None:
                return full
            # a copy of the block, so the whole leaf is freed (a
            # contiguous view would keep it)
            return sharding.local_block(self.mesh, full, sharding.spec_dims(
                s)).clone(memory_format=torch.contiguous_format)

        return tuple(_zip_map(lambda x, s, i=i: draw(i, x, s), a, sp)
                     for i, (a, sp) in enumerate(zip(self.args,
                                                     self.arg_specs)))

    def analyze(self) -> dict:
        """Run the program on fake tensors of the rank's block shapes:
        {"flops", "bytes", "collectives" (the record), "memory"}."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.utils.flop_counter import FlopCounterMode
        with FakeTensorMode():
            args = tuple(tree_map(lambda x: torch.empty(x.shape,
                                                        dtype=x.dtype), a)
                         for a in self.local_args())
            arg_leaves = [x for a in args for x in tree_leaves(a)]
            arg_bytes = _unique_bytes(arg_leaves)
            mt = MemTracker()
            mt.track_external(*arg_leaves)
            with hlo_analysis.record_collectives() as rec, \
                    FlopCounterMode(display=False) as fc, \
                    hlo_analysis.BytesAccessed() as ba, mt:
                out = self.fn(*args)
            peak = sum(d.get("Total", 0) for d in
                       mt.get_tracker_snapshot("peak").values())
            out_leaves = [x for x in tree_leaves(out)
                          if isinstance(x, torch.Tensor)]
            arg_st = {_storage(x) for x in arg_leaves}
            mem = {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": sum(_nbytes(x)
                                               for x in out_leaves),
                   "temp_size_in_bytes": max(int(peak) - arg_bytes, 0),
                   "generated_code_size_in_bytes": 0,
                   "alias_size_in_bytes": sum(
                       _nbytes(x) for x in out_leaves
                       if _storage(x) in arg_st)}
        return {"flops": float(fc.get_total_flops()),
                "bytes": float(ba.total), "collectives": list(rec),
                "memory": mem}


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _storage(x):
    return x.untyped_storage()._cdata


def _unique_bytes(leaves) -> int:
    seen, total = set(), 0
    for x in leaves:
        k = _storage(x)
        if k not in seen:
            seen.add(k)
            total += x.untyped_storage().nbytes()
    return total


def _zip_map_path(fn, tree, specs_tree, path=()):
    """``fn(path, leaf, spec)`` over a pytree and its spec pytree."""
    if isinstance(tree, dict):
        return {k: _zip_map_path(fn, v, specs_tree[k], path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map_path(fn, v, specs_tree[i], path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, specs_tree)


def _zip_map(fn, tree, specs_tree):
    return _zip_map_path(lambda p, x, s: fn(x, s), tree, specs_tree)


def _replicated(tree):
    return tree_map(lambda x: P(*([None] * x.dim())), tree)


def _opt_shape(p_shape):
    return {"m": tree_map(lambda x: specs.meta(x.shape, torch.float32),
                          p_shape),
            "v": tree_map(lambda x: specs.meta(x.shape, torch.float32),
                          p_shape),
            "t": specs.meta((), torch.int32)}


def _lead_axes(spec) -> tuple:
    e = spec[0] if spec else None
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _cache_seq_axes(c_spec) -> dict:
    """{"k" / "xk": the axes the sequence dim (2) of those cache leaves
    splits along}, from the cache's specs."""
    out = {}

    def visit(path, s):
        name = sharding._leaf_name(path)
        if name in ("k", "xk") and s is not None and len(s) == 5 and s[2]:
            out[name] = sharding._entry_axes(s[2])

    sharding.map_specs(visit, c_spec)
    return out


def _shape_of(shape):
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def lower_fl_round(cfg: ModelConfig, mesh, *, clients: int = 256,
                   local_batch: int = 4, seq: int = 512, steps: int = 1):
    """(Lowered, fl client config) of one client-parallel FL round."""
    fcfg = fl_client_config(cfg)
    p1 = specs.params_shape(fcfg)
    stack = tree_map(lambda l: specs.meta((clients,) + tuple(l.shape),
                                          l.dtype), p1)
    dp = tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))
    lead = lambda x: P(dp, *([None] * (x.dim() - 1)))      # noqa: E731
    batches = {"tokens": specs.meta((clients, steps, local_batch, seq),
                                    torch.int32)}
    if fcfg.frontend:
        batches["embeds"] = specs.meta(
            (clients, steps, local_batch, 8, fcfg.d_model),
            torch_dtype(fcfg.dtype))
    weights = specs.meta((clients,), torch.float32)
    client_axes = tuple(a for a in dp if axis_size(mesh, a) > 1)
    step = make_fl_round_step(fcfg, mesh=mesh, client_axes=client_axes)
    low = Lowered(step, (stack, batches, weights),
                  (tree_map(lead, stack), tree_map(lead, batches), P(None)),
                  mesh)
    return low, fcfg


def prefill_out_spec(cfg: ModelConfig, shape, mesh, dp):
    """Prefill logit out-spec: the batch axis splits along ``dp`` only
    when global_batch divides it, and the vocab axis along `model` only
    when padded_vocab divides; the two guards compose."""
    sizes = sharding._shape(mesh)
    vocab_ok = cfg.padded_vocab % sizes.get("model", 1) == 0
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    batch_ok = shape.global_batch % dp_total == 0
    return P(dp if batch_ok else None, "model" if vocab_ok else None)


def lower_one(cfg: ModelConfig, shape_name, mesh, *, lr: float = 1e-4,
              kd: bool = False, kd_chunk: int = 0, pos: int | None = None):
    """Returns (Lowered, meta).  ``shape_name`` names an ``INPUT_SHAPES``
    entry or is an ``InputShape``; ``mesh`` a DeviceMesh (None: one
    device); ``pos`` a decode's position (default the last slot of rank
    0's slice of the sequence).  Raises ``NotPorted`` for what the module
    docstring lists."""
    shape = _shape_of(shape_name)
    m = 1 if mesh is None else axis_size(mesh, "model")
    if cfg.family == "encdec" and shape.kind != "decode" and (
            cfg.n_heads % m or cfg.n_kv_heads % m):
        raise NotPorted("the enc-dec model's tensor-parallel forward needs "
                        "its head counts to divide the model axis")
    p_shape = specs.params_shape(cfg)
    one = mesh is None
    p_spec = (_replicated(p_shape) if one
              else sharding.param_specs(cfg, p_shape, mesh))
    if shape.kind == "decode":
        token, _, cache = specs.decode_inputs(cfg, shape)
        c_spec = (_replicated(cache) if one else sharding.cache_specs(
            cfg, cache, mesh, shard_seq=shape.global_batch == 1))
        t_spec = (_replicated(token) if one
                  else sharding.batch_specs(cfg, {"t": token}, mesh)["t"])
        kw = {}
        if not one and cfg.shard_mode == "fsdp":
            # the token's batch splits over axes the cache's does not:
            # those rows are gathered (every cache leaf's dim 1 is batch)
            c_lead = sharding._entry_axes(_spec_leaves(c_spec)[0][1])
            kw = dict(p_spec=p_spec, tp_spec=sharding.param_specs(
                cfg.replace(shard_mode="tp"), p_shape, mesh),
                token_axes=tuple(a for a in _lead_axes(t_spec)
                                 if a not in c_lead))
        seq = None if one else _cache_seq_axes(c_spec)
        step = make_serve_step(cfg, mesh=mesh, seq_axes=seq, **kw)
        if pos is None:
            # the last slot of rank 0's slice of the sequence (the whole
            # cache where it does not split): the rank that holds pos
            # writes the new K/V, so rank 0's program is the largest
            n_seq = 1
            for a in (seq or {}).get("k", ()):
                n_seq *= axis_size(mesh, a)
            pos = shape.seq_len // n_seq - 1
        return (Lowered(lambda p, c, t: step(p, c, t, pos),
                        (p_shape, cache, token), (p_spec, c_spec, t_spec),
                        mesh), {"kind": "decode", "pos": pos})
    batch = specs.train_inputs(cfg, shape)
    b_spec = (_replicated(batch) if one
              else sharding.batch_specs(cfg, batch, mesh))
    b_axes = () if one else tuple(
        a for a in _lead_axes(b_spec["tokens"]) if axis_size(mesh, a) > 1)

    if kd:
        from repro_torch.core.scaling import compress_config
        if shape.kind != "train":
            raise ValueError("KD dry-run uses a train shape")
        cfg_s = compress_config(cfg, 0.5, 1).replace(
            remat=cfg.remat, scan_unroll=cfg.scan_unroll,
            shard_mode=cfg.shard_mode)
        s_shape = specs.params_shape(cfg_s)
        s_spec = (_replicated(s_shape) if one
                  else sharding.param_specs(cfg_s, s_shape, mesh))
        o_spec = {"m": s_spec, "v": s_spec, "t": P()}
        step, step_cached = make_kd_train_step(
            cfg, cfg_s, lr, chunk=max(kd_chunk, 0), mesh=mesh,
            s_spec=s_spec, batch_axes=b_axes, t_spec=p_spec)
        if kd_chunk == -1:                      # cached-teacher variant
            tl = specs.meta((shape.global_batch, shape.seq_len,
                             cfg.padded_vocab), torch_dtype(cfg.dtype))
            vocab_ok = one or cfg.padded_vocab % axis_size(mesh, "model") == 0
            tl_spec = P(b_spec["tokens"][0], None,
                        "model" if vocab_ok else None)
            return (Lowered(step_cached,
                            (tl, s_shape, _opt_shape(s_shape), batch),
                            (tl_spec, s_spec, o_spec, b_spec), mesh,
                            opt_args=(2,)),
                    {"kind": "kd_cached"})
        return (Lowered(step, (p_shape, s_shape, _opt_shape(s_shape), batch),
                        (p_spec, s_spec, o_spec, b_spec), mesh,
                        opt_args=(2,)), {"kind": "kd"})

    if shape.kind == "train":
        o_spec = {"m": p_spec, "v": p_spec, "t": P()}
        step, _ = make_train_step(cfg, lr, mesh=mesh, p_spec=p_spec,
                                  batch_axes=b_axes)
        return (Lowered(step, (p_shape, _opt_shape(p_shape), batch),
                        (p_spec, o_spec, b_spec), mesh, opt_args=(1,)),
                {"kind": "train"})

    step = make_prefill_step(cfg, mesh=mesh, p_spec=p_spec)
    return (Lowered(step, (p_shape, batch), (p_spec, b_spec), mesh),
            {"kind": "prefill"})


# ------------------------------------------------------------ analysis
def _depth_cfg(cfg: ModelConfig, n_sb: int) -> ModelConfig:
    if cfg.family == "encdec":
        return cfg.replace(n_layers=n_sb, n_enc_layers=n_sb,
                           name=f"{cfg.name}@d{n_sb}")
    return cfg.replace(n_layers=n_sb * cfg.period, name=f"{cfg.name}@d{n_sb}")


def seq_lengths(cfg: ModelConfig, shape) -> tuple | None:
    """The two sequence lengths a program is traced at and extrapolated
    from, or None where it is traced at its own length."""
    if (shape.kind == "decode"
            or _loop_steps(cfg, shape.seq_len) <= MAX_LOOP_STEPS):
        return None
    return SEQ_EXTRAPOLATE


def _measure(cfg: ModelConfig, shape_name, mesh, *, seq=None, **kw):
    """(flops, bytes_accessed, collective_total, coll_detail, analysis).
    ``seq`` (L1, L2): trace the program at those sequence lengths and
    extrapolate FLOPs, bytes, collective bytes and counts, outputs and
    temporaries linearly to the shape's (each grows with the sequence by
    a fixed amount a token, a per-token loop's steps alike); the argument
    bytes are the rank's blocks' at the shape's own length."""
    if seq is None:
        low, _ = lower_one(cfg, shape_name, mesh, **kw)
        a = low.analyze()
        coll = hlo_analysis.collective_bytes(a["collectives"])
        return (a["flops"], a["bytes"], float(coll["total"]), coll, a)
    shape = _shape_of(shape_name)
    (L1, L2), L = seq, shape.seq_len
    cut = [_measure(cfg, dataclasses.replace(shape, seq_len=n), mesh, **kw)
           for n in (L1, L2)]

    def line(x1, x2):
        return x1 + (x2 - x1) * (L - L1) / (L2 - L1)

    (f1, b1, c1, d1, a1), (f2, b2, c2, d2, a2) = cut
    coll = {"bytes": {k: line(d1["bytes"][k], d2["bytes"][k])
                      for k in d1["bytes"]},
            "counts": {k: round(line(d1["counts"][k], d2["counts"][k]))
                       for k in d1["counts"]},
            "total": line(c1, c2)}
    low, _ = lower_one(cfg, shape, mesh, **kw)
    mem = {k: line(a1["memory"][k], a2["memory"][k])
           for k in a1["memory"]}
    mem["argument_size_in_bytes"] = sum(
        _nbytes(x) for a in low.local_args() for x in tree_leaves(a))
    a = {"flops": line(f1, f2), "bytes": line(b1, b2), "memory": mem,
         "collectives": None, "seq_extrapolated": [L1, L2]}
    return (a["flops"], a["bytes"], float(coll["total"]), coll, a)


def _chips(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


def analyze(cfg: ModelConfig, shape_name, mesh, **lower_kw) -> dict:
    """The program at full depth (memory truth) and at depths of 1 and 2
    superblocks, extrapolated as JAX's ``analyze`` does:
    corrected = f(1) + (n_sb-1)·(f(2)-f(1)).  The port's eager trace
    counts every layer, so for a stack of like superblocks the
    extrapolation equals the full count; the roofline takes
    max(corrected, analytic) as JAX's does."""
    chips = _chips(mesh)
    shape = _shape_of(shape_name)
    n_sb = (cfg.n_layers if cfg.family == "encdec" else cfg.n_superblocks)
    seq = seq_lengths(cfg, shape)

    f_full, b_full, c_full, coll_full, a_full = _measure(
        cfg, shape_name, mesh, seq=seq, **lower_kw)
    u1 = _depth_cfg(cfg, 1).replace(scan_unroll=True)
    u2 = _depth_cfg(cfg, 2).replace(scan_unroll=True)
    f1, b1, c1, _, _ = _measure(u1, shape_name, mesh, seq=seq, **lower_kw)
    f2, b2, c2, _, _ = _measure(u2, shape_name, mesh, seq=seq, **lower_kw)
    extrap = lambda x1, x2, xf: max(x1 + (n_sb - 1) * (x2 - x1), x2, xf, 0.0)  # noqa: E731
    flops, bytes_acc, coll_b = (extrap(f1, f2, f_full), extrap(b1, b2, b_full),
                                extrap(c1, c2, c_full))
    depth_meas = {"d1": [f1, b1, c1], "d2": [f2, b2, c2]}

    analytic = scaling_analytic(cfg, shape, chips)
    roof = hlo_analysis.Roofline(
        flops_per_device=max(flops, analytic["flops_per_device"]),
        bytes_per_device=bytes_acc,
        collective_bytes_per_device=coll_b,
        chips=chips, model_flops_total=analytic["model_flops_total"])
    mem = dict(a_full["memory"])
    mem["params_total_bytes"] = param_count(cfg) * (
        2 if cfg.dtype == "bfloat16" else 4)
    mem["params_bytes_per_chip"] = mem["params_total_bytes"] / chips
    hbm = mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"]
    mem["hbm_per_chip_est"] = hbm
    mem["fits_80g"] = bool(hbm < HBM_BYTES)
    names = mesh_shape(mesh)
    extra = {"seq_extrapolated": list(seq)} if seq else {}
    return {**extra,
        "arch": cfg.name, "shape": shape.name, "chips": chips,
        "mesh": "x".join(str(names[a]) for a in names),
        "kind": shape.kind, "remat": cfg.remat, "moe_shard": cfg.moe_shard,
        "hlo_raw": {"flops": f_full, "bytes": b_full, "collective": c_full},
        "hlo_depth": depth_meas,
        "hlo_corrected": {"flops": flops, "bytes": bytes_acc,
                          "collective": coll_b},
        "analytic": analytic,
        "collectives": coll_full,
        "memory": mem,
        "roofline": roof.as_dict(),
        "params": param_count(cfg),
        "active_params": active_param_count(cfg),
    }


def scaling_analytic(cfg: ModelConfig, shape, chips: int) -> dict:
    from repro_torch.core.scaling import analytic_step_flops
    total = analytic_step_flops(cfg, shape.kind, shape.global_batch,
                                shape.seq_len, remat=cfg.remat)
    if shape.kind == "train":
        mf = 6.0 * active_param_count(cfg) * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        mf = 2.0 * active_param_count(cfg) * shape.global_batch * shape.seq_len
    else:
        mf = 2.0 * active_param_count(cfg) * shape.global_batch
    return {"flops_total": total, "flops_per_device": total / chips,
            "model_flops_total": mf}


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            *, force: bool = False, variant: str = "",
            **cfg_overrides) -> dict:
    mesh_tag = _mesh_tag(multi_pod)
    tag = f"{arch}_{shape_name}_{mesh_tag}" + (f"_{variant}" if variant else "")
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    # production default: rematerialize superblocks in training
    if INPUT_SHAPES[shape_name].kind == "train" and "remat" not in cfg_overrides:
        cfg = cfg.replace(remat=True)
    ok, why = specs.applicable(cfg, shape_name)
    os.makedirs(out_dir, exist_ok=True)
    if not ok:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": why}
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        return res
    lower_kw = {}
    for k in ("kd", "kd_chunk"):
        if k in cfg_overrides:
            lower_kw[k] = cfg_overrides.pop(k)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            res = analyze(cfg, shape_name, mesh, **lower_kw)
        res.update(wall_s=round(time.time() - t0, 1), variant=variant)
    except NotPorted as e:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": f"not ported: {e}"}
    except Exception:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "error": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def fl_round_analysis(arch: str, mesh, *, clients: int = 256,
                      local_batch: int = 4, seq: int = 512,
                      steps: int = 1) -> dict:
    """The FL round's analysis on ``mesh`` (``run_fl``'s body)."""
    low, fcfg = lower_fl_round(get_config(arch), mesh, clients=clients,
                               local_batch=local_batch, seq=seq, steps=steps)
    a = low.analyze()
    coll = hlo_analysis.collective_bytes(a["collectives"])
    chips = _chips(mesh)
    n_p = param_count(fcfg)
    analytic = 6.0 * n_p * clients * local_batch * seq * steps
    roof = hlo_analysis.Roofline(
        flops_per_device=max(a["flops"], analytic / chips),
        bytes_per_device=a["bytes"],
        collective_bytes_per_device=float(coll["total"]),
        chips=chips, model_flops_total=analytic)
    return {"arch": arch, "shape": "fl_round", "kind": "fl_round",
            "client_params": n_p, "clients": clients, "collectives": coll,
            "roofline": roof.as_dict()}


def run_fl(arch: str, multi_pod: bool, out_dir: str,
           force: bool = False) -> dict:
    """Dry-run one Fed-RAC FL round (client-parallel) on the production
    mesh."""
    mesh_tag = _mesh_tag(multi_pod)
    path = os.path.join(out_dir, f"{arch}_fl-round_{mesh_tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            res = fl_round_analysis(arch, mesh)
        res.update(mesh=mesh_tag, wall_s=round(time.time() - t0, 1))
    except Exception:
        res = {"arch": arch, "shape": "fl_round", "mesh": mesh_tag,
               "error": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--moe-shard", choices=["tp", "ep"])
    ap.add_argument("--moe-chunk", type=int, default=0)
    ap.add_argument("--mlstm-chunk", action="store_true")
    ap.add_argument("--attn-blocked", action="store_true")
    ap.add_argument("--shard-mode", choices=["tp", "fsdp"])
    ap.add_argument("--cache-shard", choices=["hd", "seq", "batch"])
    ap.add_argument("--kd", action="store_true",
                    help="analyse the master-slave KD train step")
    ap.add_argument("--fl", action="store_true",
                    help="analyse one client-parallel Fed-RAC FL round")
    ap.add_argument("--kd-chunk", type=int, default=0)
    ap.add_argument("--kd-cached", action="store_true",
                    help="teacher logits as input (paper's broadcast schedule)")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    overrides = {}
    if args.moe_shard:
        overrides["moe_shard"] = args.moe_shard
    if args.moe_chunk:
        overrides["moe_chunk_groups"] = args.moe_chunk
    if args.mlstm_chunk:
        overrides["mlstm_impl"] = "chunk"
    if args.attn_blocked:
        overrides["attn_impl"] = "blocked"
    if args.shard_mode:
        overrides["shard_mode"] = args.shard_mode
    if args.cache_shard:
        overrides["cache_shard"] = args.cache_shard
    if args.kd:
        overrides["kd"] = True
        if args.kd_cached:
            overrides["kd_chunk"] = -1
        elif args.kd_chunk:
            overrides["kd_chunk"] = args.kd_chunk
    if args.remat:
        overrides["remat"] = True
    if args.no_remat:
        overrides["remat"] = False

    if args.fl:
        res = run_fl(args.arch, args.multi_pod, args.out, force=args.force)
        status = "ERROR" if "error" in res else "OK"
        dom = res.get("roofline", {}).get("dominant", "-")
        print(f"{args.arch:26s} fl_round     "
              f"{'2x16x16' if args.multi_pod else '16x16':8s} {status:6s} "
              f"dom={dom}", flush=True)
        if status == "ERROR":
            print(res["error"].splitlines()[-1])
        return

    combos = []
    if args.all:
        for arch in list_archs():
            for shape in INPUT_SHAPES:
                for mp in (False, True):
                    combos.append((arch, shape, mp))
    else:
        combos = [(args.arch, args.shape, args.multi_pod)]

    for arch, shape, mp in combos:
        t0 = time.time()
        res = run_one(arch, shape, mp, args.out, force=args.force,
                      variant=args.variant, **dict(overrides))
        status = ("SKIP" if "skipped" in res
                  else "ERROR" if "error" in res else "OK")
        dom = res.get("roofline", {}).get("dominant", "-")
        print(f"{arch:26s} {shape:12s} {'2x16x16' if mp else '16x16':8s} "
              f"{status:6s} dom={dom:10s} {time.time() - t0:6.1f}s", flush=True)
        if status == "ERROR":
            print(res["error"].splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
