"""Offline synthetic datasets, a numpy copy of ``repro.data.synthetic``.

``make_classification`` draws class-prototype images plus noise: separable
enough for the paper's CNN to learn, hard enough that accuracy curves have
the two-phase shape of Fig. 2.  Stand-ins: synth-mnist, synth-har,
synth-cifar, synth-shl (shapes in ``SPECS``).  The arrays are bit-identical
to the JAX package's for the same seed, which the host batch stream of the
one-round path depends on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    name: str
    x: np.ndarray        # (N, H, W, C) float32
    y: np.ndarray        # (N,) int32
    classes: int

    def __len__(self):
        return len(self.x)


SPECS = {
    "synth-mnist": ((14, 14, 1), 10),
    "synth-har":   ((9, 16, 1), 6),
    "synth-cifar": ((16, 16, 3), 10),
    "synth-shl":   ((8, 16, 1), 8),
}


def make_classification(name: str, n: int, seed: int = 0,
                        noise: float = 0.35) -> Dataset:
    shape, classes = SPECS[name]
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (classes,) + shape).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = protos[y] + rng.normal(0, noise, (n,) + shape).astype(np.float32)
    # mild per-sample distortions so the task is not trivially nearest-proto
    gains = rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(np.float32)
    return Dataset(name, x * gains, y, classes)


def train_test_split(ds: Dataset, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    cut = int(len(ds) * (1 - test_frac))
    tr, te = idx[:cut], idx[cut:]
    return (Dataset(ds.name, ds.x[tr], ds.y[tr], ds.classes),
            Dataset(ds.name, ds.x[te], ds.y[te], ds.classes))
