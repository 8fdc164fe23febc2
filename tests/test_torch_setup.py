"""Port parity, host side: data, Procedure 1 and ``FedRAC.setup``.

The numpy copies must give bit-identical arrays (the one-round path's host
batch stream depends on them), and Procedure 1 and 2 must land on the same
clusters and assignment as the JAX package on the same inputs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import clustering as j_clustering
from repro.core import server as j_srv
from repro.core.families import cnn_family as j_cnn_family
from repro.core.resources import (LAMBDA_EQUAL, LAMBDA_PAPER, TABLE_I,
                                  TABLE_III)
from repro.data import device_sampler as j_ds
from repro.data import partition as j_part
from repro.data import sampler as j_sampler
from repro.data import synthetic as j_syn

from repro_torch.core import clustering as t_clustering
from repro_torch.core import server as t_srv
from repro_torch.core.families import cnn_family as t_cnn_family
from repro_torch.core.resources import participants_from_matrix
from repro_torch.data import device_sampler as t_ds
from repro_torch.data import partition as t_part
from repro_torch.data import sampler as t_sampler
from repro_torch.data import synthetic as t_syn

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("name", sorted(j_syn.SPECS))
def test_synthetic_and_split_bit_identical(name):
    a = j_syn.make_classification(name, 300, seed=5)
    b = t_syn.make_classification(name, 300, seed=5)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    for ja, tb in zip(j_syn.train_test_split(a, seed=2),
                      t_syn.train_test_split(b, seed=2)):
        np.testing.assert_array_equal(ja.x, tb.x)
        np.testing.assert_array_equal(ja.y, tb.y)


def test_partitions_bit_identical():
    y = j_syn.make_classification("synth-mnist", 500, seed=1).y
    for a, b in zip(j_part.dirichlet_partition(y, 12, alpha=0.7, seed=4),
                    t_part.dirichlet_partition(y, 12, alpha=0.7, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j_part.iid_partition(500, 7, seed=2),
                    t_part.iid_partition(500, 7, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_samplers_bit_identical():
    ds = j_syn.make_classification("synth-mnist", 200, seed=3)
    a = j_sampler.class_balanced_batches(ds.x, ds.y, 16, 4, 10, seed=9)
    b = t_sampler.class_balanced_batches(ds.x, ds.y, 16, 4, 10, seed=9)
    c = j_sampler.sample_batches(ds.x, ds.y, 16, 4, seed=9)
    d = t_sampler.sample_batches(ds.x, ds.y, 16, 4, seed=9)
    for k in ("x", "y"):
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(c[k], d[k])


def test_class_table_identical():
    y = np.array([0, 2, 2, 5, 0, 2, 9, 9, 9, 9], np.int32)
    for m in (None, 2, 8):
        ja, jc = j_ds.build_class_table(y, 10, m)
        ta, tc = t_ds.build_class_table(y, 10, m)
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jc, tc)


@pytest.mark.parametrize("table", ["I", "III"])
@pytest.mark.parametrize("lam", [LAMBDA_EQUAL, LAMBDA_PAPER])
@pytest.mark.parametrize("seed", [0, 3])
def test_optimal_clusters_same_k_labels_di(table, lam, seed):
    V = TABLE_I if table == "I" else TABLE_III
    a = j_clustering.optimal_clusters(V, lam, seed=seed)
    b = t_clustering.optimal_clusters(V, lam, seed=seed)
    assert a.k == b.k
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.di_values.keys() == b.di_values.keys()
    for k in a.di_values:
        assert a.di_values[k] == pytest.approx(b.di_values[k], rel=1e-12)
    np.testing.assert_array_equal(
        j_clustering.order_clusters_by_resources(a.normalized, a.labels, lam),
        t_clustering.order_clusters_by_resources(b.normalized, b.labels, lam))


def test_paper_anchor_table_i_k3():
    assert t_clustering.optimal_clusters(TABLE_I, LAMBDA_EQUAL, seed=0).k == 3


def _fleet(n, seed):
    ds = j_syn.make_classification("synth-mnist", 600, seed=seed)
    train, _ = j_syn.train_test_split(ds)
    idx = j_part.dirichlet_partition(train.y, n, alpha=1.0, seed=seed)
    V = TABLE_III
    if n != 40:
        V = TABLE_III[np.random.default_rng(seed).integers(0, 40, n)]
    n_data = [len(p) for p in idx]
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    return V, n_data, cd


@pytest.mark.parametrize("n,seed,compact_to", [(12, 3, 4), (40, 3, 4),
                                               (40, 0, None)])
def test_setup_same_clusters_and_assignment(n, seed, compact_to):
    from repro.core.resources import participants_from_matrix as j_pfm
    V, n_data, cd = _fleet(n, seed)
    kw = dict(compact_to=compact_to, seed=seed)
    a = j_srv.FedRAC(j_pfm(V, n_data=n_data), cd,
                     j_cnn_family(base_width=0.125), j_srv.FLConfig(**kw),
                     classes=10).setup()
    b = t_srv.FedRAC(participants_from_matrix(V, n_data=n_data), cd,
                     t_cnn_family(base_width=0.125), t_srv.FLConfig(**kw),
                     classes=10, device="cpu").setup()
    assert (a.k_optimal, a.m) == (b.k_optimal, b.m)
    assert a.di_values == pytest.approx(b.di_values, rel=1e-12)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.mar == pytest.approx(b.mar, rel=1e-12)
    assert a.assignment.members == b.assignment.members
    assert a.assignment.n_eff == b.assignment.n_eff
    assert a.assignment.tau == b.assignment.tau
    assert a.assignment.demotions == b.assignment.demotions


def test_update_resources_same_move():
    from repro.core.resources import participants_from_matrix as j_pfm
    V, n_data, cd = _fleet(12, 3)
    a = j_srv.FedRAC(j_pfm(V, n_data=n_data), cd,
                     j_cnn_family(base_width=0.125),
                     j_srv.FLConfig(compact_to=4, seed=3), classes=10).setup()
    b = t_srv.FedRAC(participants_from_matrix(V, n_data=n_data), cd,
                     t_cnn_family(base_width=0.125),
                     t_srv.FLConfig(compact_to=4, seed=3), classes=10,
                     device="cpu").setup()
    for pid, kw in ((0, dict(s=0.5, r=1.0)), (5, dict(s=3.2, r=60.0, a=8))):
        assert a.update_resources(pid, **kw) == b.update_resources(pid, **kw)
    assert a.assignment.members == b.assignment.members


def test_family_sizes_match():
    a, b = j_cnn_family(base_width=0.125), t_cnn_family(base_width=0.125)
    for level in range(3):
        assert a.model_bytes(level) == b.model_bytes(level)
        assert a.flops_per_sample(level) == b.flops_per_sample(level)
    assert torch.get_default_dtype() == torch.float32
