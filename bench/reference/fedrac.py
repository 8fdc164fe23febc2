"""One Fed-RAC ``train()`` call recomputed plainly: Procedure 1 and 2 on
the participants' resource rows, then each cluster from the master down,
member by member: the round's batch indices, ``steps_per_round`` SGD
steps from the cluster's parameters (CE, or KD against the master's
logits of the same batch), the FedAvg of the members' parameters weighted
by their admitted data sizes, and an evaluation of the round's average.
Slaves take as teacher the master this call trained, or ``teacher``
where given: the check hands in the program's own trained master, so
that a slave is judged on its own training and not on the master's
(judged by itself at level 0), whose last rounds part fp32 runs by
their order of summation alone.

``num`` and ``fault`` act at ``at_levels`` (every level where None), for
the control and the checks that must fail: ``num`` is the precision of
products and convolutions, ``fault`` plants a defect: ``"half_batch"``
leaves out half of every batch (the mean over the rest), ``"frozen"``
returns every step's parameters unchanged.  ``levels`` limits the
clusters computed (every one where None)."""
from __future__ import annotations

import importlib

import numpy as np
import torch

from bench.reference import procedures
from bench.reference.numerics import FP32


def model_module(kind: str):
    return importlib.import_module(f"bench.reference.{kind}")


def federation_layout(fed, cfg, fl, seed, model):
    """Procedure 1 and 2 on the federation: (members, n_eff)."""
    V, shards = fed["resources"], fed["shards"]
    parts = [procedures.Participant(i, *map(float, V[i]),
                                    n_data=len(next(iter(s.values()))))
             for i, s in enumerate(shards)]
    labels = procedures.procedure1(V, seed, fl["compact_to"])
    m = len(np.unique(labels))
    sizes = [model.sizes(cfg, l) for l in range(m)]
    return procedures.procedure2(parts, sizes, batch=fl["local_batch"],
                                 eta=fl["lr"])


def _gather(shard, idx, device):
    return {k: torch.as_tensor(v[idx]).to(device) for k, v in shard.items()}


def train_call(kind, cfg, fed, fl, seed, device, num=FP32, fault=None,
               classes=None, teacher=None, at_levels=None, levels=None):
    """Every cluster's initial and final parameters (CPU), per-round member
    losses (rounds, members) and per-round evaluations, with the layout:
    {"members", "n_eff", "levels": {level: {...}}}."""
    model = model_module(kind)
    members, n_eff = federation_layout(fed, cfg, fl, seed, model)
    test = {k: torch.as_tensor(v).to(device) for k, v in fed["test"].items()}
    steps, B, lr = fl["steps_per_round"], fl["local_batch"], fl["lr"]
    out = {"members": members, "n_eff": n_eff, "levels": {}}
    given = teacher is not None
    if given:
        teacher = {k: v.to(device) for k, v in teacher.items()}
    for level in sorted(members):
        pids = members[level]
        if not pids or (levels is not None and level not in levels):
            continue
        here = at_levels is None or level in at_levels
        lnum, lfault = (num, fault) if here else (FP32, None)
        p0 = model.init(cfg, level, seed)
        p = {k: v.to(device) for k, v in p0.items()}
        kd = fl["use_kd"] and level > 0
        balanced = fl["class_balanced"] and level == 0
        w = torch.tensor([n_eff[q] for q in pids], dtype=torch.float32,
                         device=device)
        w = w / w.sum()
        lens = [len(next(iter(fed["shards"][q].values()))) for q in pids]
        labels = [fed["shards"][q]["y"] for q in pids] if balanced else None
        losses, evals = [], []
        with lnum.scope():
            for r in range(fl["rounds"]):
                idx = procedures.draw_indices(seed, r, steps, B, lens,
                                              labels, classes)
                avg, round_losses = None, []
                for i, q in enumerate(pids):
                    mp = dict(p)
                    step_losses = []
                    for s in range(steps):
                        batch = _gather(fed["shards"][q], idx[i, s], device)
                        if lfault == "half_batch":
                            batch = {k: v[:B // 2] for k, v in batch.items()}
                        t = (model.teacher_logits(cfg, teacher, batch, lnum)
                             if kd else None)
                        leaf = {k: v.detach().requires_grad_(True)
                                for k, v in mp.items()}
                        loss = model.step_loss(cfg, level, leaf, batch, t, fl,
                                               lnum)
                        grads = torch.autograd.grad(loss, list(leaf.values()))
                        if lfault != "frozen":
                            mp = {k: v.detach() - lr * g
                                  for (k, v), g in zip(leaf.items(), grads)}
                        step_losses.append(float(loss.detach()))
                    round_losses.append(float(np.mean(step_losses)))
                    avg = ({k: w[i] * v for k, v in mp.items()} if avg is None
                           else {k: avg[k] + w[i] * v for k, v in mp.items()})
                    del mp
                p = avg
                losses.append(round_losses)
                evals.append(model.evaluate(cfg, level, p, test, lnum))
        out["levels"][level] = {
            "init": p0, "final": {k: v.cpu() for k, v in p.items()},
            "losses": np.asarray(losses), "evals": evals}
        if level == 0 and not given:
            teacher = p
    return out
