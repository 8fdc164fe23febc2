"""Port parity of Procedure 1's other forms: the Table II clustering
methods (k-means, DBSCAN, OPTICS) and the fleet-scale path
(``fleet_optimal_clusters``, ``sampled_dunn_index``,
``reassign_by_centroids``).

All of it is host numpy float64 in both packages, except the Lloyd loop
inside k-means (fp32: XLA in JAX, torch in the port).  So labels, k and
Dunn indices must be exactly equal; centroids agree at rtol 1e-5 /
atol 1e-6.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import clustering as JC
from repro.core import resources as JR
from repro.core.assignment import reassign_by_centroids as j_reassign
from repro.sim import sample_profiles

from repro_torch.core import clustering as TC
from repro_torch.core.assignment import reassign_by_centroids
from repro_torch.core.resources import (LAMBDA_EQUAL, LAMBDA_PAPER,
                                        TABLE_III, similarity_matrix,
                                        unit_normalize)


# ------------------------------------------------------------ Table II
@pytest.mark.parametrize("lam", [LAMBDA_EQUAL, LAMBDA_PAPER],
                         ids=["equal", "paper"])
@pytest.mark.parametrize("method", ["kmeans", "dbscan", "optics"])
def test_optimal_clusters_method_matches_jax(method, lam):
    j = JC.optimal_clusters(JR.TABLE_III, lam, seed=3, method=method)
    t = TC.optimal_clusters(TABLE_III, lam, seed=3, method=method)
    assert t.k == j.k
    assert t.di_values == j.di_values
    assert np.array_equal(t.labels, j.labels)
    assert np.array_equal(t.normalized, j.normalized)


def test_table_ii_sweep_matches_jax():
    """The Table II computation (``benchmarks/bench_tables.py``): DI at
    k = 2..6 on Table III under the paper's λ for single-restart k-means
    (seed 3), DBSCAN and OPTICS; DBSCAN cannot reach some k, and then both
    packages return None."""
    Vb = unit_normalize(TABLE_III)
    X = Vb * np.sqrt(np.asarray(LAMBDA_PAPER))
    S = similarity_matrix(Vb, LAMBDA_PAPER)
    unreached = []
    for k in range(2, 7):
        lj, _ = JC.kmeans(X, k, seed=3, restarts=1)
        lt, _ = TC.kmeans(X, k, seed=3, restarts=1)
        assert np.array_equal(lt, lj)
        assert TC.dunn_index(S, lt) == JC.dunn_index(S, lj)
        for name in ("dbscan_at_k", "optics_at_k"):
            lj, lt = getattr(JC, name)(X, k), getattr(TC, name)(X, k)
            if lj is None:
                assert lt is None
                unreached.append((name, k))
                continue
            assert np.array_equal(lt, lj)
            assert len(np.unique(lt)) == k
            assert TC.dunn_index(S, lt) == JC.dunn_index(S, lj)
    assert ("dbscan_at_k", 5) in unreached
    assert all(name == "dbscan_at_k" for name, _ in unreached)


def test_dbscan_and_optics_primitives_match_jax():
    X = unit_normalize(TABLE_III) * np.sqrt(np.asarray(LAMBDA_PAPER))
    for eps in (0.05, 0.1, 0.2):
        assert np.array_equal(TC.dbscan(X, eps), JC.dbscan(X, eps))
    (ot, rt), (oj, rj) = TC.optics_order(X), JC.optics_order(X)
    assert np.array_equal(ot, oj) and np.array_equal(rt, rj)
    with pytest.raises(ValueError):
        TC.optimal_clusters(TABLE_III, LAMBDA_PAPER, method="spectral")


# ------------------------------------------------------------ fleet path
@pytest.fixture(scope="module")
def fleet_results():
    """fleet_optimal_clusters of both packages at n = 1500 (every row fits
    the fit sample) and n = 20,000 (a 4096-row fit sample, 1024-row Dunn
    samples), on the CPU."""
    out = {}
    for n, seed in ((1500, 3), (20_000, 1)):
        V = sample_profiles(n, seed=seed)
        out[n] = (V, JC.fleet_optimal_clusters(V, LAMBDA_PAPER, seed=0),
                  TC.fleet_optimal_clusters(V, LAMBDA_PAPER, seed=0,
                                            device="cpu"))
    return out


@pytest.mark.parametrize("n", [1500, 20_000])
def test_fleet_optimal_clusters_matches_jax(fleet_results, n):
    V, j, t = fleet_results[n]
    assert t.k == j.k and 2 <= t.k <= 8
    assert np.array_equal(t.labels, j.labels)
    assert t.di_values == j.di_values
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5,
                               atol=1e-6)
    for f in ("lo", "span", "lam"):
        assert np.array_equal(getattr(t, f), getattr(j, f))
    assert set(np.unique(t.labels)) == set(range(t.k))


def test_reassign_by_centroids_reproduces_labels(fleet_results):
    V, j, t = fleet_results[20_000]
    again = reassign_by_centroids(V, t)
    assert np.array_equal(again, t.labels)
    assert np.array_equal(again, j_reassign(V, j))
    # a level map relabels, and one row comes back as one level
    lvl = np.arange(t.k)[::-1]
    assert np.array_equal(reassign_by_centroids(V, t, lvl), lvl[t.labels])
    assert reassign_by_centroids(V[7], t).shape == (1,)


def test_fleet_procedure1_reduces_to_exact_on_tables():
    """With every row in both samples the fleet path is the exact one: the
    paper's Table I k=3 and Table III's k under both λ."""
    for table, lam, cap in ((JR.TABLE_I, LAMBDA_EQUAL, 3),
                            (TABLE_III, LAMBDA_EQUAL, 6),
                            (TABLE_III, LAMBDA_PAPER, 6)):
        exact = TC.optimal_clusters(table, lam, seed=0)
        fleet = TC.fleet_optimal_clusters(table, lam, seed=0, k_cap=cap,
                                          device="cpu")
        assert fleet.k == exact.k
        assert np.array_equal(fleet.labels, exact.labels)
        for k in fleet.di_values:
            assert fleet.di_values[k] == pytest.approx(exact.di_values[k],
                                                       abs=1e-9)
    tiny = TC.fleet_optimal_clusters(TABLE_III[:3], device="cpu")
    assert tiny.k == 1 and tiny.di_values == {} and (tiny.labels == 0).all()


def test_kmeans_device_keyword_keeps_the_cpu_result():
    X = unit_normalize(TABLE_III) * np.sqrt(np.asarray(LAMBDA_PAPER))
    a = TC.kmeans(X, 4, seed=3)
    b = TC.kmeans(X, 4, seed=3, device=torch.device("cpu"))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# ------------------------------------------------------------ sampled Dunn
def _sampled_vs_exact(seed, k, sample):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(60, 3))
    labels = rng.integers(0, k, size=60)
    if len(np.unique(labels)) < 2:
        return
    S = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    exact = TC.dunn_index(S, labels)
    sampled = TC.sampled_dunn_index(X, labels, sample=sample, seed=seed)
    assert sampled >= exact - 1e-9
    assert sampled == JC.sampled_dunn_index(X, labels, sample=sample,
                                            seed=seed)
    full = TC.sampled_dunn_index(X, labels, sample=60, seed=seed)
    assert full == pytest.approx(exact, rel=1e-9, abs=1e-12)


@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(2, 30))
@settings(max_examples=20, deadline=None)
def test_sampled_dunn_bounds_exact_dunn(seed, k, sample):
    """Subsampling the inter-cluster minimum can only miss the true
    minimum, so sampled Dunn >= exact Dunn, equal once every cluster fits
    in the sample; and it is JAX's value exactly."""
    _sampled_vs_exact(seed, k, sample)


@pytest.mark.parametrize("seed,k,sample",
                         [(0, 3, 4), (1, 2, 2), (7, 4, 10), (123, 5, 25),
                          (42, 2, 3), (9, 3, 60)])
def test_sampled_dunn_bounds_exact_dunn_seeded(seed, k, sample):
    _sampled_vs_exact(seed, k, sample)
