"""The one traffic generator: a federation from a traffic file and
``--seed``.

What decides the work is fixed by the file (``layout_seed``): the
participants' resource rows, every shard's size and labels, the test
set's size and labels, the windows' offsets.  ``--seed`` draws the data
itself (the images' class prototypes, noise and gains; the token corpus),
so every seed gives the cell the same members, capacities and batches of
the same shapes.

``data`` is ``"images"`` (class prototypes plus noise and a gain, the
repository's synth-* stand-ins at a dataset's own shape and sample
counts, split across participants by a Dirichlet label skew)
or ``"tokens"`` (an order-2 Markov corpus cut into one chunk per
participant, each holding windows of it).  The arithmetic follows the
program's generators (``data/synthetic.py``, ``data/partition.py``;
here the images are drawn in fp32), kept here so that a later change
there does not move the benchmark.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def resource_rows(traffic: dict) -> np.ndarray:
    with open(TRAFFIC_DIR / traffic["resources"]) as f:
        rows = [[float(x) for x in r] for r in list(csv.reader(f))[1:]]
    V = np.asarray(rows, np.float64)
    if traffic["pick"] is not None:
        V = V[np.random.default_rng(traffic["layout_seed"]).integers(
            0, len(V), traffic["pick"])]
    return V


def dirichlet_partition(labels, n_clients, alpha, rng, min_per_client):
    """Per class, Dirichlet(alpha) shares across clients; a client below
    ``min_per_client`` samples is topped up from a shuffled pool."""
    shares = [[] for _ in range(n_clients)]
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            shares[cl].append(part)
    out = [np.sort(np.concatenate(s)) if s else np.array([], int)
           for s in shares]
    pool = np.concatenate(out)
    rng.shuffle(pool)
    for i, o in enumerate(out):
        if len(o) < min_per_client:
            out[i] = np.sort(np.concatenate([o, pool[:min_per_client
                                                     - len(o)]]))
    return out


def images(traffic: dict, cfg: dict, seed: int) -> dict:
    n_part = len(resource_rows(traffic))
    hw, ch, classes = cfg["image_hw"], cfg["in_channels"], cfg["classes"]
    n_train, N = traffic["train_samples"], (traffic["train_samples"]
                                            + traffic["test_samples"])
    layout = np.random.default_rng(traffic["layout_seed"])
    y = layout.integers(0, classes, N).astype(np.int32)
    perm = layout.permutation(N)
    tr, te = perm[:n_train], perm[n_train:]
    idx = dirichlet_partition(y[tr], n_part, traffic["dirichlet_alpha"],
                              layout, traffic["min_per_client"])
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((classes, hw, hw, ch), np.float32)
    x = protos[y]
    x += rng.standard_normal((N, hw, hw, ch), np.float32) * np.float32(
        traffic["noise"])
    lo, hi = traffic["gain_range"]
    x *= rng.uniform(lo, hi, (N, 1, 1, 1)).astype(np.float32)
    xt, yt = x[tr], y[tr]
    return {"shards": [{"x": xt[p], "y": yt[p]} for p in idx],
            "test": {"x": x[te], "y": y[te]}, "n_test": len(te)}


def markov_corpus(vocab: int, length: int, n_states: int, rng):
    """Order-2 Markov tokens: a Dirichlet(0.3) state transition and a
    Dirichlet(0.05) emission per state over the vocabulary; token i is
    drawn from state i's emission, state i+1 from its transition."""
    trans = rng.dirichlet(np.ones(n_states) * 0.3, size=n_states)
    emit = rng.dirichlet(np.ones(vocab) * 0.05, size=n_states)

    def cdf(p):
        c = p.cumsum()
        return c / c[-1]

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


def windows(tokens, count: int, seq: int, offset_seed: int):
    """(count, seq) windows of ``tokens`` at seeded start offsets."""
    starts = np.random.default_rng(offset_seed).integers(
        0, len(tokens) - seq - 1, count)
    return np.stack([tokens[s:s + seq] for s in starts])


def tokens(traffic: dict, cfg: dict, seed: int) -> dict:
    n_part = len(resource_rows(traffic))
    corpus = markov_corpus(cfg["vocab_size"], traffic["corpus_tokens"],
                           traffic["markov_states"],
                           np.random.default_rng(seed))
    seq, w = traffic["seq"], traffic["windows_per_member"]
    shards = [{"tokens": windows(ch, w, seq, i)}
              for i, ch in enumerate(np.array_split(corpus, n_part))]
    test = {"tokens": windows(corpus, traffic["test_windows"], seq,
                              traffic["test_window_seed"])}
    return {"shards": shards, "test": test,
            "n_test": traffic["test_windows"]}


def generate(traffic: dict, cfg: dict, seed: int) -> dict:
    """{"resources": (n, 3) rows, "shards": one dict of arrays per
    participant, "test": a dict of arrays, "n_test"}."""
    make = {"images": images, "tokens": tokens}[traffic["data"]]
    fed = make(traffic, cfg, seed)
    fed["resources"] = resource_rows(traffic)
    return fed
