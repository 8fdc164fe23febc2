"""Cluster compaction (§IV-A2): merge the k Dunn-optimal clusters into m < k
so every cluster has enough participants, avoiding both the over-compression
of deep cluster levels and the straggler effect.

Merging policy: clusters are ordered by descending resources; we repeatedly
merge the *most similar adjacent pair* (smallest centroid distance) — the
merged cluster adopts the LOWER level's model (its weakest member must still
accommodate it).
"""
from __future__ import annotations

import numpy as np


def compact(labels: np.ndarray, V: np.ndarray, m: int) -> np.ndarray:
    """labels: resource-ordered cluster ids (0 = highest resources).
    Returns new labels in 0..m-1, still resource-ordered."""
    labels = labels.copy()
    k = len(np.unique(labels))
    assert m <= k, (m, k)
    while k > m:
        ks = np.unique(labels)
        cents = np.stack([V[labels == f].mean(axis=0) for f in ks])
        # adjacent pairs in resource order
        dists = np.linalg.norm(cents[1:] - cents[:-1], axis=1)
        j = int(np.argmin(dists))              # merge ks[j] and ks[j+1]
        labels[labels == ks[j + 1]] = ks[j]
        # re-densify labels to 0..k-2 preserving order
        ks2 = np.unique(labels)
        remap = {int(old): i for i, old in enumerate(ks2)}
        labels = np.array([remap[int(l)] for l in labels])
        k -= 1
    return labels
