"""Training/communication-time cost model (§III-B1, Eq. 2; §IV-C Eq. 9/10).

T_i = T_i^a · E + T_i^c with
  T_i^a  = flops_per_sample · n_i / (s_i · GFLOPS_PER_GHZ · 1e9)
  T_i^c  = model_bytes · 8 / (r_i · 1e6)          [r_i in Mbps]

On one accelerator the heterogeneity is *simulated* through these terms;
the clustering/assignment math consumes only T_i, so it is unchanged from
the paper.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.resources import Participant

GFLOPS_PER_GHZ = 8.0      # effective flops per cycle (SIMD MAC units)
EFFICIENCY = 0.3          # achieved fraction of peak on an edge device


def train_time(p: Participant, flops_per_sample: float, E: int,
               n_i: int | None = None) -> float:
    n = p.n_data if n_i is None else n_i
    return flops_per_sample * n * E / (p.s * GFLOPS_PER_GHZ * 1e9 * EFFICIENCY)


def comm_time(p: Participant, model_bytes: float) -> float:
    return model_bytes * 8.0 / (p.r * 1e6)


def round_time(p: Participant, flops_per_sample: float, model_bytes: float,
               E: int, n_i: int | None = None,
               compute_slowdown: float = 1.0) -> float:
    """T_i = T_i^a E + T_i^c.  ``compute_slowdown`` multiplies T_i^a for
    transient device conditions (simulated straggler spikes)."""
    return (train_time(p, flops_per_sample, E, n_i) * compute_slowdown
            + comm_time(p, model_bytes))


def train_time_vec(s: np.ndarray, flops_per_sample, E, n,
                   compute_slowdown=1.0) -> np.ndarray:
    """Vectorized T_i^a · E over participant arrays; every argument
    broadcasts, constants identical to ``train_time``."""
    return (flops_per_sample * n * E * compute_slowdown
            / (s * GFLOPS_PER_GHZ * 1e9 * EFFICIENCY))


def comm_time_vec(r: np.ndarray, model_bytes) -> np.ndarray:
    return model_bytes * 8.0 / (r * 1e6)


def round_bytes(model_bytes: float, *, download: bool = True,
                upload: bool = True) -> float:
    """Per-participant traffic in one round: WPM down + WPM up (§III-B).
    A deadline-dropped participant still burned its download."""
    return model_bytes * (float(download) + float(upload))


def total_time_sync(times: np.ndarray, rounds: int) -> float:
    """Eq. 2: per-round time is the straggler's; total = R · max_i T_i."""
    return float(rounds * np.max(times))


def mar_parallel(T_m: float, kappa: float, m: int) -> float:
    """Eq. 9: master then slaves in parallel: (κ^{m-1} + 1) · T_m.
    (m=1: no slave phase — just the master's time.)"""
    if m <= 1:
        return T_m
    return (kappa ** (m - 1) + 1.0) * T_m


def mar_sequential(T_m: float, kappa: float, m: int) -> float:
    """Eq. 10: fully sequential cluster training: Σ_{i=0}^{m-1} κ^i · T_m."""
    return T_m * (1.0 - kappa ** m) / (1.0 - kappa)


def can_accommodate(p: Participant, model_bytes: float,
                    mem_overhead: float = 3.0) -> bool:
    """Memory check: params + grads + optimizer state must fit a_i (GB)."""
    return p.a * 1e9 >= model_bytes * mem_overhead
