"""A frozen copy of Fed-RAC's host arithmetic: Procedure 1 (k-means over
the lambda-weighted resource rows, the Dunn index, resource ordering,
compaction), Procedure 2 (the cost model and the convergence bounds that
place each participant), and the dispatch path's batch-index draws.

It follows the paper (arXiv:2306.04207, Sec. IV) as the port implements
it, so the same inputs give the same memberships, admitted data sizes and
sample indices; it shares no code with the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

LAMBDA = (0.4, 0.4, 0.2)            # FastDeepIoT-derived weighting
GFLOPS_PER_GHZ, EFFICIENCY = 8.0, 0.3
# Assumptions 1-5 constants (L, mu, sigma, G, h1, h2, E||w1 - w*||^2)
L_SMOOTH, MU, SIGMA, G_BOUND, H2, W_DIST_SQ = 1.5, 0.7, 1.0, 1.0, 0.5, 0.0064


@dataclass
class Participant:
    pid: int
    s: float
    r: float
    a: float
    n_data: int


# ------------------------------------------------------------ Procedure 1
def unit_normalize(V):
    lo, hi = V.min(axis=0), V.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    return (V - lo) / span


def similarity(Vb, lam):
    """S_ij: the lambda-weighted Euclidean distance, summed over the
    columns in the order (0, 2, 1)."""
    lam = np.asarray(lam, np.float64)
    acc = None
    for d in (0, 2, 1):
        diff = Vb[:, d, None] - Vb[None, :, d]
        term = diff * diff * lam[d]
        acc = term if acc is None else acc + term
    return np.sqrt(acc)


def _kmeanspp(X, k, rng):
    n = len(X)
    centers = [X[rng.integers(n)]]
    for _ in range(k - 1):
        d2 = np.min([((X - c) ** 2).sum(1) for c in centers], axis=0)
        total = d2.sum()
        pick = rng.choice(n, p=d2 / total) if total > 0 else rng.integers(n)
        centers.append(X[pick])
    return np.stack(centers)


def kmeans(X, k, seed, restarts=8, iters=50):
    """k-means++ seeding in float64, then every restart's Lloyd loop in
    float32; the restart of least inertia (the first on ties)."""
    rng = np.random.default_rng(seed)
    inits = np.stack([_kmeanspp(X, k, rng) for _ in range(restarts)])
    Xt = torch.as_tensor(X, dtype=torch.float32)
    cents = torch.as_tensor(inits, dtype=torch.float32)
    for _ in range(iters):
        d = torch.linalg.vector_norm(Xt[None, :, None] - cents[:, None],
                                     dim=-1)
        oh = torch.nn.functional.one_hot(torch.argmin(d, dim=2), k).float()
        cnt = oh.sum(1)
        new = (oh.transpose(1, 2) @ Xt) / torch.clamp(cnt, min=1)[..., None]
        cents = torch.where(cnt[..., None] > 0, new, cents)
    d = torch.linalg.vector_norm(Xt[None, :, None] - cents[:, None], dim=-1)
    lab = torch.argmin(d, dim=2)
    inertia = torch.sum(torch.min(d, dim=2).values ** 2, dim=1)
    return lab[int(torch.argmin(inertia))].numpy()


def dunn(S, labels):
    """Eq. 5: least inter-cluster distance over the largest centroid
    diameter (twice the RMS member-to-mean distance)."""
    ks = np.unique(labels)
    if len(ks) < 2:
        return 0.0
    dia = 0.0
    for f in ks:
        m = labels == f
        n = int(m.sum())
        if n >= 2:
            dia = max(dia, 2.0 * math.sqrt(
                float((S[np.ix_(m, m)] ** 2).sum()) / (2.0 * n * n)))
    if dia == 0.0:
        return 0.0
    dmin = np.inf
    for i, f in enumerate(ks):
        for g in ks[i + 1:]:
            dmin = min(dmin, float(S[np.ix_(labels == f, labels == g)].min()))
    return float(dmin / dia)


def procedure1(V, seed, compact_to, lam=LAMBDA):
    """Cluster labels, 0 the highest-resource (master) cluster."""
    Vb = unit_normalize(np.asarray(V, np.float64))
    Xw = Vb * np.sqrt(np.asarray(lam))
    S = similarity(Vb, lam)
    di, labs = {}, {}
    for k in range(2, int(math.floor(math.sqrt(len(V)))) + 1):
        labs[k] = kmeans(Xw, k, seed)
        di[k] = dunn(S, labs[k])
    labels = labs[min(di, key=lambda k: (-di[k], k))]
    # order by mean lambda-weighted resources, highest first
    ks = np.unique(labels)
    score = [(Vb[labels == f] * np.asarray(lam)).sum(1).mean() for f in ks]
    order = ks[np.argsort(-np.asarray(score))]
    labels = np.array([int(np.flatnonzero(order == l)[0]) for l in labels])
    # compaction: merge the closest adjacent pair until compact_to remain
    k = len(np.unique(labels))
    while compact_to is not None and k > compact_to:
        ks = np.unique(labels)
        cents = np.stack([Vb[labels == f].mean(0) for f in ks])
        j = int(np.argmin(np.linalg.norm(cents[1:] - cents[:-1], axis=1)))
        labels[labels == ks[j + 1]] = ks[j]
        remap = {int(o): i for i, o in enumerate(np.unique(labels))}
        labels = np.array([remap[int(l)] for l in labels])
        k -= 1
    return labels


# ------------------------------------------------------------ Procedure 2
def round_time(p, flops, nbytes, E, n):
    return (flops * n * E / (p.s * GFLOPS_PER_GHZ * 1e9 * EFFICIENCY)
            + nbytes * 8.0 / (p.r * 1e6))


def _b_constant(eps, E):
    return float(np.sum(np.asarray(eps) ** 2) * SIGMA ** 2
                 + 8 * (E - 1) ** 2 * G_BOUND ** 2)


def _beta(E):
    return max(8 * L_SMOOTH / MU, float(E))


def precision_bound(eps, E, R):
    """Eq. 6."""
    B, bt = _b_constant(eps, E), _beta(E)
    return ((L_SMOOTH / (2 * MU ** 2)) / (bt + R * E - 1)
            * (4 * B + MU ** 2 * bt * W_DIST_SQ))


def rounds_for(q_o, E, B):
    """Eq. 7."""
    bt = _beta(E)
    R = (1.0 / E) * ((L_SMOOTH / (2 * MU ** 2 * q_o))
                     * (4 * B + MU ** 2 * bt * W_DIST_SQ) + 1 - bt)
    return max(1, math.ceil(R))


def optimization_error(eps, taus, eta, R):
    """Eq. 8 (o_j all ones); zero for a single participant."""
    eps, taus = np.asarray(eps, np.float64), np.asarray(taus, np.float64)
    F = len(eps)
    if F <= 1:
        return 0.0
    tau_e = float(np.mean(taus))
    b2 = F * tau_e * float(np.sum(eps ** 2 / taus))
    b3 = float(np.sum(eps * (taus - 1.0)))
    b4 = float(np.max(taus * (taus - 1.0)))
    return (4.0 / (eta * tau_e * R) + 4 * eta * L_SMOOTH * SIGMA ** 2 * b2 / F
            + 6 * eta ** 2 * L_SMOOTH ** 2 * SIGMA ** 2 * b3
            + 12 * eta ** 2 * L_SMOOTH ** 2 * H2 ** 2 * b4)


def procedure2(parts, sizes, *, E=2, q_target=0.05,
               theta=100.0, kappa=0.7, batch=16, eta=0.05, expected_F=8):
    """Place each participant top-down (memory, MAR, Eq. 6 precision,
    Eq. 8 error), shrinking its data by 0.8 at a time.  ``sizes``: per
    level (model bytes, FLOPs per sample).  Returns (members: level ->
    [pid], n_eff: pid -> admitted samples)."""
    m = len(sizes)
    t_master = np.array([round_time(p, sizes[0][1], sizes[0][0], E, p.n_data)
                         for p in parts])
    mar = float(np.percentile(t_master, 40)) / kappa ** (m - 1)
    R = rounds_for(q_target, E, _b_constant(np.full(expected_F,
                                                    1.0 / expected_F), E))
    delta = 1.25 * q_target
    members = {l: [] for l in range(m)}
    n_eff, taus_of, ns_of = {}, {l: [] for l in range(m)}, \
        {l: [] for l in range(m)}

    def tau(n):
        return max(1, (E * n) // batch)

    def try_place(p, level):
        nbytes, flops = sizes[level]
        if p.a * 1e9 < nbytes * 3.0:
            return None
        t_mar = mar * kappa ** (m - 1 - level)
        n_i = p.n_data
        for _ in range(16):
            if round_time(p, flops, nbytes, E, n_i) > t_mar:
                n_i = max(1, int(n_i * 0.8))
                continue
            ns = np.array(ns_of[level] + [n_i], np.float64)
            eps = ns / ns.sum()
            if precision_bound(eps, E, R) > delta:
                n_i = max(1, int(n_i * 0.8))
                if n_i == 1:
                    return None
                continue
            if len(ns) > 1 and optimization_error(
                    eps, taus_of[level] + [tau(n_i)], eta, R) > theta:
                return None
            return n_i
        return None

    for p in parts:
        for level in range(m):
            n_i = try_place(p, level)
            if n_i is not None:
                ns_of[level].append(n_i)
                taus_of[level].append(tau(n_i))
                break
        else:
            # forced into the last cluster with a quarter of its data; it
            # does not enter the later members' bounds
            level, n_i = m - 1, max(1, p.n_data // 4)
        members[level].append(p.pid)
        n_eff[p.pid] = n_i
    return members, n_eff


# ------------------------------------------------------------ index draws
_MASK64 = (1 << 64) - 1


def _mix(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _uniform(seed, r, slot, shape):
    """float64 uniforms of one (seed, absolute round, member slot): a CPU
    torch generator seeded by three splitmix64 rounds."""
    h = _mix(int(seed) & _MASK64)
    h = _mix(h ^ (int(r) & _MASK64))
    h = _mix(h ^ (int(slot) & _MASK64))
    g = torch.Generator().manual_seed(h >> 1)
    return torch.rand(shape, generator=g, dtype=torch.float64).numpy()


def draw_indices(seed, r, steps, batch, shard_lens, labels=None,
                 classes=None):
    """(members, steps, batch) sample indices of round ``r``, member i in
    slot i.  Uniform over each shard, or, with ``labels`` (one array per
    member), class-balanced: batch slots go round-robin over the classes
    the member holds, ascending, and each draws uniformly in its class."""
    out = np.empty((len(shard_lens), steps, batch), np.int64)
    for i, n in enumerate(shard_lens):
        u = _uniform(seed, r, i, (steps, batch))
        if labels is None:
            n = max(int(n), 1)
            out[i] = np.minimum(np.floor(u * n), n - 1)
            continue
        y = np.asarray(labels[i])
        cols = [np.flatnonzero(y == c) for c in range(classes)]
        present = [c for c in range(classes) if len(cols[c])]
        cls = [present[j % len(present)] for j in range(batch)]
        cnt = np.array([len(cols[c]) for c in cls])
        inst = np.minimum(np.floor(u * cnt), cnt - 1).astype(np.int64)
        out[i] = np.array([[cols[cls[j]][inst[s, j]] for j in range(batch)]
                           for s in range(steps)])
    return out
