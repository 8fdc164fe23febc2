"""LM pretraining driver, a torch counterpart of ``repro.launch.train``.

One process, one device: the model's parameters, gradients and optimizer
state live on ``--device`` (``cuda`` by default; without a card it raises,
``--device cpu`` runs on the CPU).  A step takes the gradient of
``registry.loss_fn`` with ``torch.autograd.grad``, clips it by its global
norm and applies the optimizer's in-place update (``optim.optimizers``)
at the schedule's learning rate (``optim.schedules``); ``remat=True``
configurations recompute each superblock in the backward pass.  Weights
are drawn from a ``torch.Generator`` on the device seeded by ``--seed``,
batches are the synthetic LM corpus's seeded windows, and ``--ckpt-dir``
writes the final parameters (bf16 for the full configurations) in the
checkpoint format the JAX package reads.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --steps 100 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.core.server import resolve_device
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import lm_batches, make_lm_corpus
from repro_torch.launch.mesh import host_mesh_shape
from repro_torch.models import registry
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import optimizers, schedules


def build_step(cfg, opt, sched, grad_clip=1.0):
    """``train_step(params, opt_state, batch, step)`` -> (params,
    opt_state, ce): one AdamW (or ``opt``) step.  ``params`` must be leaf
    tensors that require grad; they and ``opt_state`` are updated in place
    and returned."""
    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        loss, ce = registry.loss_fn(cfg, params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        grads = optimizers.clip_by_global_norm(grads, grad_clip)
        lr = sched(step).to(leaves[0].device)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, ce.detach()
    return train_step


def init_train_params(cfg, seed: int, device):
    """The model's parameters drawn on ``device`` from a generator seeded
    with ``seed``, as leaf tensors that require grad."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = registry.init_params(cfg, gen)
    for x in tree_leaves(params):
        x.requires_grad_(True)
    return params


def lm_batch(cfg, tokens: np.ndarray, device) -> dict:
    """A (B, S) token window as the model's batch (a frontend config gets
    its zero embeddings stub, as the JAX driver gives it)."""
    batch = {"tokens": torch.as_tensor(tokens).to(device)}
    if cfg.frontend:
        batch["embeds"] = torch.zeros(
            (tokens.shape[0], 8, cfg.d_model), dtype=torch_dtype(cfg.dtype),
            device=device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--optimizer", default="adamw",
                    choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = host_mesh_shape(1, 1)
    params = init_train_params(cfg, args.seed, device)
    opt = optimizers.get(args.optimizer)
    opt_state = opt.init(params)
    sched = schedules.get(args.schedule, args.lr, args.steps,
                          warmup=max(1, args.steps // 10))
    step_fn = build_step(cfg, opt, sched)

    corpus = make_lm_corpus(cfg.vocab_size, 200_000, seed=args.seed)
    n_params = registry.param_count(params)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"vocab={cfg.vocab_size} mesh={mesh}", flush=True)

    t0 = time.time()
    losses = []
    for step in range(args.steps):
        toks = lm_batches(corpus, args.batch, args.seq, 1,
                          seed=args.seed + step)[0]
        params, opt_state, ce = step_fn(params, opt_state,
                                        lm_batch(cfg, toks, device), step)
        losses.append(float(ce))
        if (step + 1) % args.log_every == 0:
            rate = args.batch * args.seq * args.log_every / (time.time() - t0)
            ce_mean = np.mean(losses[-args.log_every:])
            print(f"step {step+1:5d}  ce={ce_mean:.4f}  tok/s={rate:,.0f}",
                  flush=True)
            t0 = time.time()
    if args.ckpt_dir:
        path = checkpoint.save_step(args.ckpt_dir, args.steps,
                                    {"params": params})
        print("saved", path)
    print(f"final ce: first10={np.mean(losses[:10]):.4f} "
          f"last10={np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
