"""Resource-aware clustering: k-means, Dunn index and Procedure 1.

The Lloyd loop runs in torch in float32 over all restarts at once, as the
JAX package runs it in float32 (x64 off); the k-means++ seeding stays numpy
float64.  Both are needed for Procedure 1 to land on the paper's anchors
(Table I k=3, Table IV k=4/5) at the seeds the tests pin.  The fleet-scale,
DBSCAN and OPTICS paths of the JAX package are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.resources import similarity_matrix, unit_normalize


# ------------------------------------------------------------------ k-means
def _lloyd(X: torch.Tensor, centers: torch.Tensor, iters: int = 50):
    """Lloyd iterations from (restarts, k, d) initial centers, all restarts
    at once.  Returns (labels, centers, inertia) per restart."""
    k = centers.shape[1]
    for _ in range(iters):
        d = torch.linalg.vector_norm(X[None, :, None] - centers[:, None],
                                     dim=-1)                  # (R, n, k)
        oh = F.one_hot(torch.argmin(d, dim=2), k).to(X.dtype)
        cnt = oh.sum(1)                                       # (R, k)
        new = (oh.transpose(1, 2) @ X) / torch.clamp(cnt, min=1)[..., None]
        centers = torch.where(cnt[..., None] > 0, new, centers)
    d = torch.linalg.vector_norm(X[None, :, None] - centers[:, None], dim=-1)
    lab = torch.argmin(d, dim=2)
    inertia = torch.sum(torch.min(d, dim=2).values ** 2, dim=1)
    return lab, centers, inertia


def _kmeanspp_init(X: np.ndarray, k: int, rng) -> np.ndarray:
    """Seeded k-means++ seeding (D² sampling) on the host."""
    n = len(X)
    centers = [X[rng.integers(n)]]
    for _ in range(k - 1):
        d2 = np.min([((X - c) ** 2).sum(1) for c in centers], axis=0)
        total = d2.sum()
        pick = rng.choice(n, p=d2 / total) if total > 0 else rng.integers(n)
        centers.append(X[pick])
    return np.stack(centers)


def kmeans(X: np.ndarray, k: int, seed: int = 0, restarts: int = 8):
    """Multi-restart Lloyd's with k-means++ seeding; returns (labels,
    centers) of the restart with the least inertia (the first on ties)."""
    Xn = np.asarray(X, np.float64)
    rng = np.random.default_rng(seed)
    inits = np.stack([_kmeanspp_init(Xn, k, rng) for _ in range(restarts)])
    labs, cents, inert = _lloyd(torch.as_tensor(Xn, dtype=torch.float32),
                                torch.as_tensor(inits, dtype=torch.float32))
    best = int(torch.argmin(inert))
    return labs[best].numpy(), cents[best].numpy()


# ------------------------------------------------------------------ Dunn
def dunn_index(S: np.ndarray, labels: np.ndarray) -> float:
    """Eq. 5: min over cluster pairs of dist(Cf,Cg) / max_f dia(Cf), with
    dist the least inter-cluster distance (Eq. 3) and dia the centroid
    diameter (Eq. 4): twice the RMS distance of members to their mean,
    recovered from pairwise distances as sum_ij d_ij² / (2 n)."""
    ks = np.unique(labels)
    if len(ks) < 2:
        return 0.0
    dia = 0.0
    for f in ks:
        m = labels == f
        n = int(m.sum())
        if n >= 2:
            sq = float((S[np.ix_(m, m)] ** 2).sum())
            dia = max(dia, 2.0 * math.sqrt(sq / (2.0 * n * n)))
    if dia == 0.0:
        return 0.0
    dmin = np.inf
    for i, f in enumerate(ks):
        for g in ks[i + 1:]:
            mf, mg = labels == f, labels == g
            dmin = min(dmin, float(S[np.ix_(mf, mg)].min()))
    return float(dmin / dia)


@dataclass
class ClusteringResult:
    k: int
    labels: np.ndarray
    di_values: dict          # k -> Dunn index
    normalized: np.ndarray   # the normalized resource matrix used


def optimal_clusters(V: np.ndarray, lam=(1 / 3, 1 / 3, 1 / 3), *,
                     normalize: bool = True, seed: int = 0,
                     k_max: int | None = None,
                     restarts: int = 8) -> ClusteringResult:
    """Procedure 1: sweep k = 2..floor(sqrt(N)) with k-means, pick the
    argmax Dunn index (exact ties go to fewer clusters)."""
    N = V.shape[0]
    Vb = unit_normalize(V) if normalize else V.astype(np.float64)
    # k-means works on sqrt(λ)-scaled coordinates, where Euclidean distance
    # equals the λ-weighted similarity S_ij
    Xw = Vb * np.sqrt(np.asarray(lam))
    S = similarity_matrix(Vb, lam)
    k_max = k_max or int(math.floor(math.sqrt(N)))
    di, labs = {}, {}
    for k in range(2, k_max + 1):
        lab, _ = kmeans(Xw, k, seed=seed, restarts=restarts)
        di[k] = dunn_index(S, lab)
        labs[k] = lab
    best = min(di, key=lambda k: (-di[k], k))
    return ClusteringResult(best, labs[best], di, Vb)


def order_clusters_by_resources(V: np.ndarray, labels: np.ndarray,
                                lam=None) -> np.ndarray:
    """Relabel clusters so C_0 has the HIGHEST mean resources under the λ
    weighting (master first, §IV-A2); ``lam=None`` weighs axes equally."""
    ks = np.unique(labels)
    lam_a = (np.full(V.shape[1], 1.0 / V.shape[1]) if lam is None
             else np.asarray(lam, np.float64))
    score = np.array([(V[labels == f] * lam_a).sum(axis=1).mean()
                      for f in ks])
    order = ks[np.argsort(-score)]
    remap = {int(old): new for new, old in enumerate(order)}
    return np.array([remap[int(l)] for l in labels])
