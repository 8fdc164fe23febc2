"""Resource-aware clustering: k-means, Dunn index and Procedure 1, its
fleet-scale form, and the DBSCAN / OPTICS alternatives of the paper's
Table II.

The Lloyd loop runs in torch in float32 over all restarts at once, as the
JAX package runs it in float32 (x64 off); the k-means++ seeding stays numpy
float64.  Both are needed for Procedure 1 to land on the paper's anchors
(Table I k=3, Table IV k=4/5) at the seeds the tests pin.  The loop runs on
the CPU unless the caller names a ``device``.  Everything else (Dunn
indices, the fleet path's nearest-centroid labels and sampled Dunn, DBSCAN
and OPTICS) is one-shot server-side setup in numpy float64, the JAX
package's arithmetic, so the same inputs give the same labels.
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


def kmeans(X: np.ndarray, k: int, seed: int = 0, restarts: int = 8,
           device=None):
    """Multi-restart Lloyd's with k-means++ seeding; returns (labels,
    centers) of the restart with the least inertia (the first on ties).
    The Lloyd loop runs on ``device`` (the CPU when None)."""
    Xn = np.asarray(X, np.float64)
    rng = np.random.default_rng(seed)
    inits = np.stack([_kmeanspp_init(Xn, k, rng) for _ in range(restarts)])
    labs, cents, inert = _lloyd(
        torch.as_tensor(Xn, dtype=torch.float32, device=device),
        torch.as_tensor(inits, dtype=torch.float32, device=device))
    best = int(torch.argmin(inert))
    return labs[best].cpu().numpy(), cents[best].cpu().numpy()


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


def nearest_centroid(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Labels by one argmin over centroids: the squared-norm expansion (a
    matrix product and two rank-1 broadcasts), never an (n, k, d) array."""
    X = np.asarray(X, np.float64)
    C = np.asarray(centers, np.float64)
    d2 = ((X * X).sum(1)[:, None] + (C * C).sum(1)[None, :]
          - 2.0 * (X @ C.T))
    return np.argmin(d2, axis=1)


def sampled_dunn_index(X: np.ndarray, labels: np.ndarray, *,
                       sample: int = 1024, seed: int = 0) -> float:
    """Eq. 5 estimated from coordinates: the fleet-scale Dunn path.

    On the sqrt(λ)-scaled coordinates Euclidean distance is the λ-weighted
    similarity, so the n x n matrix is never built.  Diameters are exact
    in O(n d): Eq. 4's centroid form is 2 sqrt(sum_i ||x_i - c||² / n).
    The inter-cluster minimum (Eq. 3) comes from at most ``sample``
    uniformly drawn members per cluster, so the estimate can only miss the
    true minimum: sampled Dunn >= exact Dunn, equal when every cluster fits
    in ``sample``."""
    X = np.asarray(X, np.float64)
    labels = np.asarray(labels)
    ks = np.unique(labels)
    if len(ks) < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    dia = 0.0
    picks = []
    for f in ks:
        idx = np.flatnonzero(labels == f)
        if len(idx) >= 2:
            c = X[idx].mean(axis=0)
            dia = max(dia, 2.0 * math.sqrt(
                float(((X[idx] - c) ** 2).sum(1).mean())))
        picks.append(idx if len(idx) <= sample
                     else rng.choice(idx, size=sample, replace=False))
    if dia == 0.0:
        return 0.0
    dmin2 = np.inf
    for i in range(len(ks)):
        A = X[picks[i]]
        aa = (A * A).sum(1)
        for j in range(i + 1, len(ks)):
            B = X[picks[j]]
            d2 = aa[:, None] + (B * B).sum(1)[None, :] - 2.0 * (A @ B.T)
            dmin2 = min(dmin2, max(float(d2.min()), 0.0))
    return float(math.sqrt(dmin2) / dia)


@dataclass
class ClusteringResult:
    k: int
    labels: np.ndarray
    di_values: dict          # k -> Dunn index
    normalized: np.ndarray   # the normalized resource matrix used


@dataclass
class FleetClusteringResult:
    """Procedure 1 at fleet scale, with the centroids and the frozen
    normalization (lo, span) so that a drifted participant is re-placed by
    one ``nearest_centroid`` call in the same coordinates
    (``core.assignment.reassign_by_centroids``)."""
    k: int
    labels: np.ndarray       # (n,) int
    centroids: np.ndarray    # (k, 3) in sqrt(λ)-scaled normalized coords
    di_values: dict          # k -> sampled Dunn index
    lo: np.ndarray           # (3,) per-column normalization offset
    span: np.ndarray         # (3,) per-column normalization scale
    lam: np.ndarray          # (3,) λ weights


def fleet_optimal_clusters(V: np.ndarray, lam=(1 / 3, 1 / 3, 1 / 3), *,
                           seed: int = 0, k_cap: int = 8,
                           train_sample: int = 4096,
                           dunn_sample: int = 1024,
                           restarts: int = 8,
                           device=None) -> FleetClusteringResult:
    """Procedure 1 for 10⁴–10⁶ participants, with no O(n²) array and no
    full-fleet Lloyd: k-means fits on at most ``train_sample`` uniformly
    drawn rows (on ``device``), every row takes the label of its nearest
    centroid, and each k is scored by ``sampled_dunn_index``.  The sweep
    stops at ``k_cap``.  With both samples >= n this is the exact
    ``optimal_clusters`` path (same seeding, restarts and tie-break)."""
    V = np.asarray(V, np.float64)
    N = len(V)
    lam_a = np.asarray(lam, np.float64)
    lo, hi = V.min(axis=0), V.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    Xw = ((V - lo) / span) * np.sqrt(lam_a)
    k_max = min(k_cap, int(math.floor(math.sqrt(N))))
    if k_max < 2:
        return FleetClusteringResult(1, np.zeros(N, np.int64),
                                     Xw.mean(0, keepdims=True),
                                     {}, lo, span, lam_a)
    rng = np.random.default_rng(seed)
    Xfit = (Xw if N <= train_sample
            else Xw[rng.choice(N, train_sample, replace=False)])
    di, labs, cents = {}, {}, {}
    for k in range(2, k_max + 1):
        _, centers = kmeans(Xfit, k, seed=seed, restarts=restarts,
                            device=device)
        lab = nearest_centroid(Xw, centers)
        di[k] = sampled_dunn_index(Xw, lab, sample=dunn_sample, seed=seed)
        labs[k] = lab
        cents[k] = centers
    best = min(di, key=lambda k: (-di[k], k))
    return FleetClusteringResult(best, labs[best], cents[best], di,
                                 lo, span, lam_a)


def optimal_clusters(V: np.ndarray, lam=(1 / 3, 1 / 3, 1 / 3), *,
                     normalize: bool = True, seed: int = 0,
                     k_max: int | None = None, method: str = "kmeans",
                     restarts: int = 8) -> ClusteringResult:
    """Procedure 1: sweep k = 2..floor(sqrt(N)) with ``method`` (kmeans,
    dbscan or optics), pick the argmax Dunn index; a k that DBSCAN cannot
    reach scores 0.  Exact ties go to fewer clusters: Procedure 1 prefers
    the coarsest partition that attains the optimum."""
    N = V.shape[0]
    Vb = unit_normalize(V) if normalize else V.astype(np.float64)
    # k-means works on sqrt(λ)-scaled coordinates, where Euclidean distance
    # equals the λ-weighted similarity S_ij
    Xw = Vb * np.sqrt(np.asarray(lam))
    S = similarity_matrix(Vb, lam)
    k_max = k_max or int(math.floor(math.sqrt(N)))
    di, labs = {}, {}
    for k in range(2, k_max + 1):
        if method == "kmeans":
            lab, _ = kmeans(Xw, k, seed=seed, restarts=restarts)
        elif method == "dbscan":
            lab = dbscan_at_k(Xw, k)
        elif method == "optics":
            lab = optics_at_k(Xw, k)
        else:
            raise ValueError(method)
        di[k] = dunn_index(S, lab) if lab is not None else 0.0
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


# ------------------------------------------------------------------ DBSCAN
def dbscan(X: np.ndarray, eps: float, min_pts: int = 3) -> np.ndarray:
    """Labels of density-connected groups at radius ``eps``; noise points
    then join their nearest clustered point (every participant trains)."""
    n = len(X)
    D = np.linalg.norm(X[:, None] - X[None], axis=-1)
    labels = np.full(n, -1)
    cid = 0
    for i in range(n):
        if labels[i] != -1:
            continue
        nbrs = np.where(D[i] <= eps)[0]
        if len(nbrs) < min_pts:
            continue
        labels[i] = cid
        stack = list(nbrs)
        while stack:
            j = stack.pop()
            if labels[j] == -1:
                labels[j] = cid
                nb2 = np.where(D[j] <= eps)[0]
                if len(nb2) >= min_pts:
                    stack.extend([q for q in nb2 if labels[q] == -1])
        cid += 1
    if cid > 0:
        for i in np.where(labels == -1)[0]:
            labels[i] = labels[np.argmin(np.where(labels >= 0, D[i], np.inf))]
    return labels


def dbscan_at_k(X: np.ndarray, k: int, min_pts: int = 3):
    """Binary search of eps for exactly k clusters (how Table II evaluates
    DBSCAN at each k); None if no eps of the search reaches k."""
    lo, hi = 1e-4, float(np.linalg.norm(X.max(0) - X.min(0))) + 1e-3
    best = None
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lab = dbscan(X, mid, min_pts)
        kk = len(np.unique(lab))
        if kk == k:
            best = lab
            break
        if kk < k:      # too few clusters: shrink eps
            hi = mid
        else:
            lo = mid
    return best


# ------------------------------------------------------------------ OPTICS
def optics_order(X: np.ndarray, min_pts: int = 3):
    """OPTICS visiting order and reachability distances."""
    n = len(X)
    D = np.linalg.norm(X[:, None] - X[None], axis=-1)
    core = np.sort(D, axis=1)[:, min_pts - 1]
    reach = np.full(n, np.inf)
    seen = np.zeros(n, bool)
    order = []
    for start in range(n):
        if seen[start]:
            continue
        seeds = {start: np.inf}
        while seeds:
            i = min(seeds, key=seeds.get)
            del seeds[i]
            if seen[i]:
                continue
            seen[i] = True
            order.append(i)
            for j in range(n):
                if seen[j]:
                    continue
                nr = max(core[i], D[i, j])
                if nr < reach[j]:
                    reach[j] = nr
                    seeds[j] = nr
    return np.array(order), reach


def optics_at_k(X: np.ndarray, k: int, min_pts: int = 3):
    """Cut the OPTICS reachability plot at its k-1 highest peaks."""
    order, reach = optics_order(X, min_pts)
    r = reach[order]
    r[0] = 0.0
    if k <= 1:
        return np.zeros(len(X), int)
    cut_positions = np.sort(np.argsort(-r[1:])[:k - 1] + 1)
    labels = np.zeros(len(X), int)
    cid = 0
    pos = 0
    for c in list(cut_positions) + [len(X)]:
        labels[order[pos:c]] = cid
        cid += 1
        pos = c
    return np.clip(labels, 0, k - 1)
