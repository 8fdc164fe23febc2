"""The public functions the port took last from the JAX package, each held
to JAX's on the same numpy inputs:

* ``kernels.fedagg.ops.aggregate_plane`` and ``aggregate_tree`` at widths
  that are not multiples of 4 (the port pads its kernel's columns; JAX's
  kernel runs in interpret mode on the CPU), at rtol 1e-6 / atol 1e-6:
  both sum the same fp32 products, maybe in another order;
* ``models.cnn.loss_fn`` (mean CE and accuracy) on JAX's parameters, at
  rtol 2e-4 / atol 1e-5, the accuracy exactly;
* ``core.rounds.example3_constants``, ``data.sampler.leave_one_out`` and
  ``data.partition.partition_sizes``, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import rounds as j_rounds
from repro.data import partition as j_partition
from repro.data import sampler as j_sampler
from repro.kernels.fedagg import ops as j_fedagg
from repro.models import cnn as j_cnn
from repro_torch import interop
from repro_torch.core import rounds
from repro_torch.data import partition, sampler
from repro_torch.kernels.fedagg import ops as fedagg
from repro_torch.models import cnn

jax.config.update("jax_platform_name", "cpu")


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("C,D", [(3, 30), (5, 7), (1, 13)])
def test_aggregate_plane_any_width_equals_jax(C, D):
    rng = np.random.default_rng(C * 100 + D)
    plane = rng.standard_normal((C, D)).astype(np.float32)
    w = rng.random(C).astype(np.float32)
    want = j_fedagg.aggregate_plane(jnp.asarray(plane), jnp.asarray(w),
                                    interpret=True)
    got = fedagg.aggregate_plane(torch.tensor(plane), torch.tensor(w))
    assert got.shape == (D,) and got.dtype == torch.float32
    _close(got, want, 1e-6, 1e-6)


def test_aggregate_tree_equals_jax():
    rng = np.random.default_rng(7)
    C = 4
    stack = {"w": rng.standard_normal((C, 3, 3)).astype(np.float32),
             "b": rng.standard_normal((C, 5)).astype(np.float32),
             "h": [rng.standard_normal((C, 2, 1)).astype(np.float32)]}
    w = rng.random(C).astype(np.float32)
    want = j_fedagg.aggregate_tree(jax.tree.map(jnp.asarray, stack),
                                   jnp.asarray(w), interpret=True)
    got = fedagg.aggregate_tree(interop.params_from_numpy(stack),
                                torch.tensor(w))
    assert got["w"].shape == (3, 3) and got["h"][0].shape == (2, 1)
    for a, b in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor),
                    jax.tree.leaves(want)):
        _close(a, b, 1e-6, 1e-6)


def test_cnn_loss_fn_equals_jax():
    key = jax.random.PRNGKey(0)
    pj = j_cnn.init_params(key, in_channels=1, classes=10, alpha=1.0,
                           level=0, base_width=0.125)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 14, 14, 1)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    lj, aj = j_cnn.loss_fn(pj, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    lt, at = cnn.loss_fn(pt, {"x": torch.tensor(x), "y": torch.tensor(y)})
    _close(lt, lj, 2e-4, 1e-5)
    assert float(at) == float(aj)


def test_example3_constants_equal_jax():
    assert (dataclasses.asdict(rounds.example3_constants())
            == dataclasses.asdict(j_rounds.example3_constants()))


def test_leave_one_out_and_partition_sizes_equal_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = rng.integers(0, 4, 40)
    for c in range(4):
        for a, b in zip(sampler.leave_one_out(x, y, c),
                        j_sampler.leave_one_out(x, y, c)):
            assert np.array_equal(a, b)
    parts = np.array_split(rng.permutation(40), [3, 11, 30])
    assert np.array_equal(partition.partition_sizes(parts),
                          j_partition.partition_sizes(parts))
