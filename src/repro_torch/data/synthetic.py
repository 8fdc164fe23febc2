"""Offline synthetic datasets, a numpy copy of ``repro.data.synthetic``.

``make_classification`` draws class-prototype images plus noise: separable
enough for the paper's CNN to learn, hard enough that accuracy curves have
the two-phase shape of Fig. 2.  Stand-ins: synth-mnist, synth-har,
synth-cifar, synth-shl (shapes in ``SPECS``).  ``make_lm_corpus`` is an
order-2 Markov token stream with per-state emissions, so next-token loss is
learnable by small LMs; ``lm_batches`` cuts windows out of it.  The arrays
are bit-identical to the JAX package's for the same seed, which the host
batch stream of the one-round path depends on.
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


def make_lm_corpus(vocab: int, length: int, seed: int = 0,
                   n_states: int = 8) -> np.ndarray:
    """Markov chain over vocab with low-entropy per-state emissions.

    The JAX package draws token i by ``rng.choice(vocab, p=emit[s])`` and
    the next state by ``rng.choice(n_states, p=trans[s])``, alternately.
    Each such call takes one ``rng.random()`` and searches the row's
    normalized cumulative sum; here the 2 * length uniforms are drawn at
    once and the searches batched per state, which gives the same tokens
    without a search of a vocabulary-wide row per token."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(n_states) * 0.3, size=n_states)
    emit = rng.dirichlet(np.ones(vocab) * 0.05, size=n_states)

    def cdf(p):
        c = p.cumsum()
        c /= c[-1]
        return c

    u = rng.random(2 * length)
    u_tok, u_state = u[0::2], u[1::2]
    nxt = np.stack([cdf(trans[s]).searchsorted(u_state, side="right")
                    for s in range(n_states)]).tolist()
    states = np.empty(length, np.int64)
    s = 0
    for i in range(length):
        states[i] = s
        s = nxt[s][i]
    toks = np.empty(length, np.int32)
    for s in range(n_states):
        at = np.flatnonzero(states == s)
        toks[at] = cdf(emit[s]).searchsorted(u_tok[at], side="right")
    return toks


def lm_batches(tokens: np.ndarray, batch: int, seq: int, steps: int,
               seed: int = 0) -> np.ndarray:
    """(steps, batch, seq) windows of ``tokens`` at seeded start offsets."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(tokens) - seq - 1, (steps, batch))
    return np.stack([[tokens[s:s + seq] for s in row] for row in starts])
