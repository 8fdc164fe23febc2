"""Communication rounds and optimization error per cluster (§IV-B, Eq. 6-8).

Derived under Assumptions 1-4 (L-smooth, μ-strongly-convex, bounded gradient
variance σ², bounded gradient norm G²) from the FedAvg convergence bound
[Li et al., ICLR'20], and Assumption 5 (h1, h2) from the objective-
inconsistency analysis [Wang et al., NeurIPS'20].
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ConvergenceConstants:
    L: float = 1.5          # smoothness
    mu: float = 0.7         # strong convexity
    sigma: float = 1.0      # grad variance bound σ_f
    G: float = 1.0          # grad norm bound G_f
    h1: float = 1.0         # Assumption 5
    h2: float = 0.5
    w_dist_sq: float = 0.0064   # E||w_1 - w*||^2  (Example 3: 0.08^2)


def b_constant(eps_weights, E: int, c: ConvergenceConstants) -> float:
    """B = Σ ε_j² σ² + 8(E-1)² G²  (below Eq. 6)."""
    eps = np.asarray(eps_weights, dtype=np.float64)
    return float(np.sum(eps ** 2) * c.sigma ** 2 + 8 * (E - 1) ** 2 * c.G ** 2)


def beta(E: int, c: ConvergenceConstants) -> float:
    return max(8 * c.L / c.mu, float(E))


def precision_bound(eps_weights, E: int, R: int, c: ConvergenceConstants,
                    B: float | None = None) -> float:
    """Eq. 6 RHS: upper bound on E[L(w^R)] - L*  with T_f = R·E total local steps."""
    B = b_constant(eps_weights, E, c) if B is None else B
    bt = beta(E, c)
    T = R * E
    return (c.L / (2 * c.mu ** 2)) / (bt + T - 1) * (4 * B + c.mu ** 2 * bt * c.w_dist_sq)


def communication_rounds(q_o: float, E: int, c: ConvergenceConstants,
                         B: float = 1.0) -> int:
    """Eq. 7: rounds R_f needed for target precision q_o at E local epochs."""
    bt = beta(E, c)
    R = (1.0 / E) * ((c.L / (2 * c.mu ** 2 * q_o)) *
                     (4 * B + c.mu ** 2 * bt * c.w_dist_sq) + 1 - bt)
    return max(1, math.ceil(R))


def optimization_error(eps_weights, taus, eta: float, R: int,
                       c: ConvergenceConstants, loss_gap: float = 1.0) -> float:
    """Eq. 8 upper bound on min_t E||∇L̄(w̄^t)||² for FedAvg-style accumulation
    (o_j = 1^{τ_j}, so ||o||₁=τ, ||o||₂²=τ, o_last=1).

    A single participant (F=1) has zero heterogeneity error by definition
    (§IV-B3 Case 1) — the h2 (dissimilarity) term vanishes.
    """
    eps = np.asarray(eps_weights, dtype=np.float64)
    taus = np.asarray(taus, dtype=np.float64)
    F = len(eps)
    if F <= 1:
        return 0.0
    tau_e = float(np.mean(taus))
    b1 = loss_gap
    b2 = F * tau_e * float(np.sum(eps ** 2 / taus))
    b3 = float(np.sum(eps * (taus - 1.0)))
    b4 = float(np.max(taus * (taus - 1.0)))
    return (4 * b1 / (eta * tau_e * R)
            + 4 * eta * c.L * c.sigma ** 2 * b2 / F
            + 6 * eta ** 2 * c.L ** 2 * c.sigma ** 2 * b3
            + 12 * eta ** 2 * c.L ** 2 * c.h2 ** 2 * b4)


def example3_constants() -> ConvergenceConstants:
    """Paper Example 3: μ=0.7, L=1.5, B=1, E||w1-w*||=0.08, E_f=20 → R_f=6
    (with q_o = 0.05, the upper end of the paper's L* ∈ [0.01,0.05])."""
    return ConvergenceConstants(L=1.5, mu=0.7, w_dist_sq=0.08 ** 2)
