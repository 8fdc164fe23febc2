"""Participant assignment to clusters — Procedure 2 (§IV-B3).

Each participant is tried against clusters from the highest (master) down.
Case 1 (empty cluster): only the precision check q_o ≤ δ applies (err ≡ 0 for
a single participant).  Case 2: both q_o ≤ δ and err ≤ θ.  If the participant
cannot run M_f within the cluster's MAR, τ_i and n_i are reduced; if precision
would break, it demotes to the next cluster.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import cost_model, rounds
from repro_torch.core.clustering import nearest_centroid
from repro_torch.core.resources import Participant


@dataclass
class ClusterSpec:
    level: int                    # 0 = master
    model_bytes: float
    flops_per_sample: float
    E: int                        # local epochs E_f
    R: int                        # communication rounds R_f (Eq. 7)
    delta: float                  # precision threshold δ_f
    theta: float                  # error threshold θ_f
    mar: float                    # MAR time budget T_f for this cluster
    batch_size: int = 32


@dataclass
class Assignment:
    members: dict = field(default_factory=dict)     # level -> [pid]
    n_eff: dict = field(default_factory=dict)       # pid -> adjusted n_i
    tau: dict = field(default_factory=dict)         # pid -> adjusted τ_i
    demotions: int = 0
    diagnostics: list = field(default_factory=list)


def _tau(E: int, n: int, B: int) -> int:
    return max(1, (E * n) // B)


def _try_place(p: Participant, c: ClusterSpec,
               consts: rounds.ConvergenceConstants, eta: float,
               n_cur: list, tau_cur: list, diagnostics: list):
    """Procedure 2's per-cluster check (Case 1/2 + τ/n reduction).
    Returns the admitted n_i, or None (→ demote to the next cluster)."""
    if not cost_model.can_accommodate(p, c.model_bytes):
        diagnostics.append((p.pid, c.level, "memory"))
        return None
    n_i = p.n_data
    for _ in range(16):
        t = cost_model.round_time(p, c.flops_per_sample, c.model_bytes,
                                  c.E, n_i)
        if t > c.mar:
            n_i = max(1, int(n_i * 0.8))
            continue
        taus = tau_cur + [_tau(c.E, n_i, c.batch_size)]
        ns = np.array(n_cur + [n_i], dtype=np.float64)
        eps = ns / ns.sum()
        q = rounds.precision_bound(eps, c.E, c.R, consts)
        if q > c.delta:
            n_i = max(1, int(n_i * 0.8))
            if n_i == 1:
                return None
            continue
        if len(ns) > 1:
            err = rounds.optimization_error(eps, taus, eta, c.R, consts)
            if err > c.theta:
                return None                  # heterogeneity too high: demote
        return n_i
    return None


def assign(parts: list[Participant], clusters: list[ClusterSpec],
           consts: rounds.ConvergenceConstants,
           eta: float = 0.01) -> Assignment:
    out = Assignment(members={c.level: [] for c in clusters})
    n_cur = {c.level: [] for c in clusters}          # current members' n_i
    tau_cur = {c.level: [] for c in clusters}

    for p in parts:
        placed = False
        for c in clusters:
            n_i = _try_place(p, c, consts, eta, n_cur[c.level],
                             tau_cur[c.level], out.diagnostics)
            if n_i is not None:
                out.members[c.level].append(p.pid)
                out.n_eff[p.pid] = n_i
                out.tau[p.pid] = _tau(c.E, n_i, c.batch_size)
                n_cur[c.level].append(n_i)
                tau_cur[c.level].append(out.tau[p.pid])
                placed = True
                break
            out.demotions += 1
        if not placed:
            # last resort: smallest cluster with minimum data (paper §IV-A:
            # "sets batch-size and local epochs to continue the training")
            c = clusters[-1]
            out.members[c.level].append(p.pid)
            out.n_eff[p.pid] = max(1, p.n_data // 4)
            out.tau[p.pid] = _tau(c.E, out.n_eff[p.pid], c.batch_size)
            out.diagnostics.append((p.pid, c.level, "forced"))
    return out


def reassign(p: Participant, current: Assignment,
             clusters: list[ClusterSpec],
             consts: rounds.ConvergenceConstants,
             eta: float = 0.01) -> tuple[int | None, int]:
    """§IV-A dynamic resources: a participant whose (s, r, a) changed is
    re-evaluated against every cluster top-down and upgraded / downgraded
    in place.  Returns (old_level, new_level)."""
    old_level = None
    for lvl, mem in current.members.items():
        if p.pid in mem:
            old_level = lvl
            mem.remove(p.pid)
            break
    for c in clusters:
        n_cur = [current.n_eff[q] for q in current.members[c.level]]
        tau_cur = [current.tau[q] for q in current.members[c.level]]
        n_i = _try_place(p, c, consts, eta, n_cur, tau_cur,
                         current.diagnostics)
        if n_i is not None:
            current.members[c.level].append(p.pid)
            current.n_eff[p.pid] = n_i
            current.tau[p.pid] = _tau(c.E, n_i, c.batch_size)
            return old_level, c.level
    # smallest cluster with reduced data, as in assign()
    c = clusters[-1]
    current.members[c.level].append(p.pid)
    current.n_eff[p.pid] = max(1, p.n_data // 4)
    current.tau[p.pid] = _tau(c.E, current.n_eff[p.pid], c.batch_size)
    current.diagnostics.append((p.pid, c.level, "forced-dynamic"))
    return old_level, c.level


def reassign_by_centroids(V: np.ndarray, clustering,
                          level_of_cluster: np.ndarray | None = None
                          ) -> np.ndarray:
    """Procedure 2 at fleet scale: re-place participants by ONE argmin over
    the setup-time centroids of ``clustering`` (a
    ``FleetClusteringResult``), whose frozen (lo, span, λ) map raw resource
    rows into the centroids' coordinates.  ``level_of_cluster`` maps a
    centroid index to a cluster level (identity when omitted).  Returns
    one level per row of ``V``."""
    V = np.atleast_2d(np.asarray(V, np.float64))
    Xw = ((V - clustering.lo) / clustering.span) * np.sqrt(clustering.lam)
    lab = nearest_centroid(Xw, clustering.centroids)
    if level_of_cluster is not None:
        lab = np.asarray(level_of_cluster)[lab]
    return lab


def build_cluster_specs(model_family_sizes: list[tuple[float, float]],
                        consts: rounds.ConvergenceConstants,
                        *, E: int = 5, q_target: float = 0.05,
                        delta: float | None = None, theta: float = 50.0,
                        mar: float = 600.0, kappa: float = 0.7,
                        batch_size: int = 32,
                        expected_F: int = 8) -> list["ClusterSpec"]:
    """Convenience: one spec per cluster level from (bytes, flops/sample).

    R_f comes from Eq. 7 with B evaluated at a uniform expected membership, so
    the Eq. 6 precision at (E, R_f) lands at ≈ q_target by construction; the
    default threshold δ = 1.25·q_target then admits participants unless their
    addition worsens B, and the real gates are memory / MAR / err (Eq. 8) —
    exactly Procedure 2's resource-driven stratification.
    MAR per level follows T_{f-1} = κ T_f (§IV-C).
    """
    m = len(model_family_sizes)
    eps_u = np.full(expected_F, 1.0 / expected_F)
    B = rounds.b_constant(eps_u, E, consts)
    R = rounds.communication_rounds(q_target, E, consts, B=B)
    delta = 1.25 * q_target if delta is None else delta
    specs = []
    for lvl, (mb, fl) in enumerate(model_family_sizes):
        specs.append(ClusterSpec(
            level=lvl, model_bytes=mb, flops_per_sample=fl, E=E, R=R,
            delta=delta, theta=theta, mar=mar * (kappa ** (m - 1 - lvl)),
            batch_size=batch_size))
    return specs
