"""The tensor-parallel plane's dtype rule on a bf16 model (ROADMAP C8):
``TPPlaneSpec.to_params`` casts every leaf to its template dtype, as
JAX's does (``src/repro/core/plane.py:146``).

* JAX's ``make_tp_plane_spec(..., msize=2)``, built on the CPU with no
  mesh for a bf16 smoke LM, against the port's on the same parameters:
  ``to_plane`` equal, and ``to_params`` gives the same leaf dtypes and
  the same bits; ``local_params`` gives bf16 leaves too.
* A bf16 federation on a 1x2 gloo world with the TP forward: every member
  step's loss sees bf16 leaves, the trained models are bf16, and their
  losses are finite.

No tolerance: dtypes and bits are equal or not.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_mesh_common import run_world
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_bf16_common import bf16_config, bf16_rank

from repro.configs import get_config as j_get_config
from repro.core import families as j_families
from repro.core.plane import make_tp_plane_spec as j_make_tp_plane_spec
from repro_torch import interop
from repro_torch.core import families
from repro_torch.core.plane import make_tp_plane_spec
from repro_torch.core.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("level", [0, 1])
def test_tp_to_params_casts_to_template_dtypes_as_jax(level):
    jcfg = j_get_config("olmo-1b", smoke=True).replace(dtype="bfloat16")
    fam_j = j_families.lm_family(jcfg, 0.5)
    fam = families.lm_family(bf16_config(), 0.5)
    pj = fam_j.init(jax.random.PRNGKey(3), level)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    assert {str(x.dtype) for x in tree_leaves(pt)} == {"torch.bfloat16"}
    spec_j = j_make_tp_plane_spec(pj, fam_j.param_specs(level, pj, 2,
                                                        "model"), msize=2)
    spec = make_tp_plane_spec(pt, fam.param_specs(level, pt, 2, "model"),
                              msize=2)
    plane_j = np.asarray(spec_j.to_plane(pj))
    plane = spec.to_plane(pt)
    assert np.array_equal(plane.numpy(), plane_j)
    # an fp32 plane that does not round to bf16: the cast is exercised
    moved = plane + 1e-3 * torch.arange(plane.numel()) / plane.numel()
    back_j = jax.tree.leaves(spec_j.to_params(jax.numpy.asarray(
        moved.numpy())))
    back = tree_leaves(spec.to_params(moved))
    assert [str(x.dtype).removeprefix("torch.") for x in back] == [
        np.dtype(x.dtype).name for x in back_j]
    for a, b in zip(back, back_j):
        assert np.array_equal(_f32(a.float()), _f32(b))
    chunk = moved.reshape(2, spec.d_loc)[1]
    assert {x.dtype for x in tree_leaves(spec.local_params(chunk))} == {
        torch.bfloat16}


def test_tp_member_step_sees_bf16_leaves(tmp_path):
    for seen, trained, finite in run_world(bf16_rank, tmp_path, world=2):
        assert seen == ["torch.bfloat16"]
        assert trained == ["torch.bfloat16"]
        assert finite
