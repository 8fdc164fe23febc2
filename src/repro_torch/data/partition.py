"""Federated data partitioner: iid and Dirichlet non-iid splits."""
from __future__ import annotations

import numpy as np


def iid_partition(n_items: int, n_clients: int, seed: int = 0,
                  sizes=None) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_items)
    if sizes is None:
        return [np.sort(a) for a in np.array_split(idx, n_clients)]
    sizes = np.asarray(sizes)
    assert sizes.sum() <= n_items
    out, pos = [], 0
    for s in sizes:
        out.append(np.sort(idx[pos:pos + s]))
        pos += s
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 8) -> list[np.ndarray]:
    """Label-skew non-iid: per-class Dirichlet proportions across clients."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    shares = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            shares[cl].append(part)
    out = [np.sort(np.concatenate(s)) if s else np.array([], int) for s in shares]
    # ensure every client can form a batch
    pool = np.concatenate(out)
    rng.shuffle(pool)
    for i, o in enumerate(out):
        if len(o) < min_per_client:
            extra = pool[: min_per_client - len(o)]
            out[i] = np.sort(np.concatenate([o, extra]))
    return out


def partition_sizes(parts: list[np.ndarray]) -> np.ndarray:
    return np.array([len(p) for p in parts])
