"""How ``correct`` is decided: what the last ``train()`` call of the window
produced, against the plain reference's recomputation of that call.

The reference recomputes every cluster from the benchmark's own inputs;
a slave cluster under KD distils from the program's trained master (the
teacher it had), so that each slave is judged on its own training, and
the master, judged at level 0, is not judged twice.

Numbers compared (each against the cell file's ``limits``); those of the
clusters trained without a teacher (the master; every cluster with KD
off) carry no prefix, those of the KD clusters the prefix ``kd_``:

- ``layout``: participants whose cluster or admitted data size differs
  from the reference's Procedure 1 and 2 (exact: limit 0);
- ``first_round_gap``: the largest relative gap of a member's first-round
  loss: its first steps from the drawn parameters (and, under KD, the
  master's logits), before the training's own sensitivity has grown the
  gaps of sound fp32 runs.  ``first_round_median`` is the same median
  over the members;
- ``loss_gap``: the largest relative gap of a member's per-round loss,
  over the clusters, rounds and members;
- ``change_gap``: by the worst leaf, the gap between the program's and the
  reference's norm of a leaf's change over the call (final minus initial
  parameters), over the reference's norm of that leaf's change or of the
  median leaf's, whichever is larger; leaves that the reference moves by
  under a thousandth of the median leaf are left out (their change is
  rounding alone);
- ``change_median``: the same gap of the median leaf, the largest over
  the clusters: steady where the worst leaf is not;
- ``eval_gap``: the largest gap of a per-round evaluation, in test
  samples for an accuracy, relative for a loss.

A cell's file names the numbers it compares (``limits``); the others are
printed as readings.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NOUGHT_SHARE = 1e-3


def program_outputs(eng, result, units_are_accuracy: bool) -> dict:
    from bench.program import flat_params
    members = {l: list(m) for l, m in eng.assignment.members.items() if m}
    losses = {}
    for level, t in eng.block_losses:
        losses.setdefault(level, []).append(t.detach().cpu().numpy())
    return {
        "members": members,
        "n_eff": {int(k): int(v) for k, v in eng.assignment.n_eff.items()},
        "losses": {l: np.concatenate(v, 0) for l, v in losses.items()},
        "evals": {l: list(result.history[l]) for l in members},
        "final": {l: {k: v.detach().to("cpu", copy=True)
                      for k, v in flat_params(eng.cluster_params[l]).items()}
                  for l in members},
        "accuracy": units_are_accuracy}


def numbers(prog: dict, ref: dict, n_test: int, kd: bool) -> dict:
    out = {}
    where_p = {q: (l, prog["n_eff"].get(q)) for l, m in prog["members"].items()
               for q in m}
    where_r = {q: (l, ref["n_eff"][q]) for l, m in ref["members"].items()
               for q in m}
    out["layout"] = float(sum(where_p.get(q) != v for q, v in where_r.items())
                          + len(set(where_p) - set(where_r)))
    if out["layout"]:
        return out
    groups = {}
    for level, r in ref["levels"].items():
        lp = prog["losses"].get(level)
        lr = r["losses"]
        if lp is None or lp.shape != lr.shape:
            return out
        g = groups.setdefault("kd_" if kd and level > 0 else "", {
            "first": [], "loss_gap": 0.0, "change_gap": 0.0,
            "change_median": 0.0, "eval_gap": 0.0})
        rel = np.abs(lp - lr) / np.abs(lr)
        g["loss_gap"] = max(g["loss_gap"], float(np.max(rel)))
        g["first"].extend(rel[0].tolist())
        dr, dp = {}, {}
        for k, p0 in r["init"].items():
            dr[k] = float(torch.linalg.vector_norm(r["final"][k] - p0))
            dp[k] = float(torch.linalg.vector_norm(
                prog["final"][level][k] - p0))
        med = float(np.median(list(dr.values())))
        gaps = [abs(dp[k] - dr[k]) / max(dr[k], med) for k in dr
                if dr[k] >= NOUGHT_SHARE * med]
        g["change_gap"] = max(g["change_gap"], max(gaps))
        g["change_median"] = max(g["change_median"], float(np.median(gaps)))
        ep, er = np.asarray(prog["evals"][level]), np.asarray(r["evals"])
        e = (np.abs(ep - er) * n_test if prog["accuracy"]
             else np.abs(ep - er) / np.abs(er))
        g["eval_gap"] = max(g["eval_gap"], float(np.max(e)))
    for prefix, g in groups.items():
        first = g.pop("first")
        out[prefix + "first_round_gap"] = float(np.max(first))
        out[prefix + "first_round_median"] = float(np.median(first))
        out.update({prefix + k: v for k, v in g.items()})
    return out


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit; a number the run could not produce fails."""
    checks = {k: {"value": values.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
