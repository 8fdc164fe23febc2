"""Batch sampling, incl. the class-balanced resampling/reweighting of §IV-C
(the master cluster samples ~equal instances per class each round so that
KD does not bias slaves toward the master's frequent classes)."""
from __future__ import annotations

import numpy as np


def sample_batches(x: np.ndarray, y: np.ndarray, batch: int, steps: int,
                   seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), (steps, batch))
    return {"x": x[idx], "y": y[idx]}


def class_balanced_batches(x: np.ndarray, y: np.ndarray, batch: int,
                           steps: int, classes: int, seed: int = 0):
    """Each batch draws ⌈batch/classes⌉ per present class (resampling scheme)."""
    rng = np.random.default_rng(seed)
    by_class = [np.where(y == c)[0] for c in range(classes)]
    present = [c for c in range(classes) if len(by_class[c])]
    per = -(-batch // len(present))
    rows = []
    for _ in range(steps):
        picks = []
        for c in present:
            picks.append(rng.choice(by_class[c], per, replace=True))
        row = np.concatenate(picks)[:batch]
        rng.shuffle(row)
        rows.append(row)
    idx = np.stack(rows)
    return {"x": x[idx], "y": y[idx]}


def leave_one_out(x: np.ndarray, y: np.ndarray, leave_class: int):
    """Drop one class from training (the paper's leave-one-out metric)."""
    keep = y != leave_class
    return x[keep], y[keep]
