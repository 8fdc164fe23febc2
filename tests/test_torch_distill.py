"""Port parity: the KD loss and the distill kernel's plain version.

``repro_torch.core.distill`` against ``repro.core.distill`` (with and
without ``valid_mask``), and the distill route on CPU tensors against the
JAX kernel run in interpret mode at the sweep shapes of
``tests/test_distill.py``, with that file's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as j_distill
from repro.kernels.distill import ops as j_ops

from repro_torch.core import distill as t_distill
from repro_torch.kernels.distill import ops as t_ops
from repro_torch.kernels.distill import ref as t_ref

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5


def _logits(seed, shape, scale=3.0, V=None):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=shape) * scale).astype(np.float32)
    t = (rng.normal(size=shape) * scale).astype(np.float32)
    y = rng.integers(0, V or shape[-1], shape[:-1]).astype(np.int32)
    return s, t, y


@pytest.mark.parametrize("T,alpha", [(1.0, 0.5), (2.0, 0.3), (4.0, 0.0),
                                     (2.0, 1.0)])
def test_kd_loss_plain_route_matches_jax(T, alpha):
    s, t, y = _logits(0, (8, 50))
    a = j_distill.kd_loss(jnp.asarray(s), jnp.asarray(y), jnp.asarray(t),
                          T=T, alpha=alpha)
    b = t_distill.kd_loss(torch.tensor(s), torch.tensor(y), torch.tensor(t),
                          T=T, alpha=alpha)
    np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np.asarray(j_distill.kl_teacher_student(jnp.asarray(t),
                                                jnp.asarray(s), T)),
        t_distill.kl_teacher_student(torch.tensor(t), torch.tensor(s),
                                     T).numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np.asarray(j_distill.ce_loss(jnp.asarray(s), jnp.asarray(y))),
        t_distill.ce_loss(torch.tensor(s), torch.tensor(y)).numpy(),
        rtol=RTOL, atol=ATOL)


def test_kd_loss_valid_mask_matches_jax():
    s, t, y = _logits(1, (4, 32), V=24)
    s[:, 24:] = 100.0                       # padded vocab must not count
    mask = np.arange(32) < 24
    a = j_distill.kd_loss(jnp.asarray(s), jnp.asarray(y), jnp.asarray(t),
                          valid_mask=jnp.asarray(mask))
    b = t_distill.kd_loss(torch.tensor(s), torch.tensor(y), torch.tensor(t),
                          valid_mask=torch.tensor(mask))
    np.testing.assert_allclose(float(a), float(b), rtol=RTOL, atol=ATOL)
    c = t_distill.kd_loss(torch.tensor(s[:, :24]), torch.tensor(y),
                          torch.tensor(t[:, :24]))
    np.testing.assert_allclose(float(b), float(c), rtol=1e-5)


@pytest.mark.parametrize("N,V,T,alpha", [
    (8, 512, 1.0, 0.5), (16, 1000, 2.0, 0.3), (4, 2048, 4.0, 0.0),
    (128, 512, 2.0, 0.3), (8, 7000, 3.0, 0.7),
])
def test_kernel_route_matches_jax_kernel_sweep(N, V, T, alpha):
    """The JAX kernel in interpret mode against the port's kernel route on
    CPU tensors (its plain version); tolerance of tests/test_distill.py."""
    s, t, y = _logits(N + V, (N, V))
    want = float(j_ops.kd_loss(jnp.asarray(s), jnp.asarray(y),
                               jnp.asarray(t), T=T, alpha=alpha,
                               interpret=True))
    got = float(t_distill.kd_loss(torch.tensor(s), torch.tensor(y),
                                  torch.tensor(t), T=T, alpha=alpha,
                                  use_kernel=True))
    assert abs(got - want) < 1e-3 * max(1.0, abs(want))


def test_kernel_route_bf16_and_3d_logits():
    s, t, y = _logits(2, (16, 512))
    sb = torch.tensor(s).to(torch.bfloat16)
    tb = torch.tensor(t).to(torch.bfloat16)
    want = float(j_ops.kd_loss(jnp.asarray(s).astype(jnp.bfloat16),
                               jnp.asarray(y),
                               jnp.asarray(t).astype(jnp.bfloat16),
                               interpret=True))
    got = float(t_ops.kd_loss(sb, torch.tensor(y), tb))
    assert abs(got - want) < 5e-2 * max(1.0, abs(want))
    s3, t3, y3 = _logits(3, (2, 6, 300), scale=2.0)
    a = float(j_distill.kd_loss(jnp.asarray(s3), jnp.asarray(y3),
                                jnp.asarray(t3)))
    b = float(t_distill.kd_loss(torch.tensor(s3), torch.tensor(y3).long(),
                                torch.tensor(t3), use_kernel=True))
    assert abs(a - b) < 2e-3 * max(1.0, abs(a))


def test_plain_version_rows_match_jax_ref():
    from repro.kernels.distill import ref as j_ref
    s, t, y = _logits(4, (12, 77))
    np.testing.assert_allclose(
        np.asarray(j_ref.kd_loss_rows(jnp.asarray(s), jnp.asarray(t),
                                      jnp.asarray(y), T=3.0, alpha=0.2)),
        t_ref.kd_loss_rows(torch.tensor(s), torch.tensor(t),
                           torch.tensor(y), T=3.0, alpha=0.2).numpy(),
        rtol=RTOL, atol=ATOL)


def test_kernel_route_is_forward_only_and_maskless():
    s, t, y = _logits(5, (4, 10))
    st = torch.tensor(s, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        t_distill.kd_loss(st, torch.tensor(y), torch.tensor(t),
                          use_kernel=True)
    with torch.no_grad():
        t_distill.kd_loss(st, torch.tensor(y), torch.tensor(t),
                          use_kernel=True)
    with pytest.raises(ValueError, match="valid_mask"):
        t_distill.kd_loss(torch.tensor(s), torch.tensor(y), torch.tensor(t),
                          valid_mask=torch.ones(10, dtype=torch.bool),
                          use_kernel=True)
    # the plain route is differentiable
    t_distill.kd_loss(st, torch.tensor(y), torch.tensor(t)).backward()
    assert torch.isfinite(st.grad).all()


def test_kernel_route_on_cpu_launches_nothing_and_refuses_other_devices():
    before = t_ops.kd_loss_rows.launches
    s, t, y = _logits(6, (8, 10))
    t_ops.kd_loss(torch.tensor(s), torch.tensor(y), torch.tensor(t))
    assert t_ops.kd_loss_rows.launches == before
    with pytest.raises(ValueError):
        t_ops.kd_loss_rows(torch.tensor(s).to("meta"),
                           torch.tensor(t).to("meta"),
                           torch.tensor(y).to("meta"))
