"""The port's tensor-parallel layout rules against the JAX package's, on the
CPU and without a mesh: ``launch.sharding.tp_specs`` for all ten
``ARCHS`` (smoke variants) at model-axis sizes 2 and 4, the three
families' ``param_specs``, and ``core.plane.TPPlaneSpec``: ``to_plane``
byte-equal to JAX's (leaves demoted by ``tp_specs`` or by
``make_tp_plane_spec`` included), ``to_params`` its inverse, and
``local_params`` / ``local_to_chunk`` equal to slicing the whole leaves.

JAX's specs are PartitionSpecs; the port's are ``{axis: dim}`` (``{}`` for
a whole leaf), so JAX's are converted (``_as_port``) before comparing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.core import families as j_families
from repro.core.plane import make_tp_plane_spec as j_make_tp_plane_spec
from repro.launch.sharding import tp_specs as j_tp_specs
from repro.models import registry as j_registry

from repro_torch import interop
from repro_torch.configs import get_config, list_archs
from repro_torch.core import families
from repro_torch.core.plane import make_tp_plane_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.launch.sharding import tp_specs
from repro_torch.models import registry

jax.config.update("jax_platform_name", "cpu")
AXIS = "model"


def _spec_list(template, specs) -> list:
    """A spec tree's per-leaf specs in ``template``'s leaf order."""
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in _spec_list(template[k], specs[k])]
    if isinstance(template, (list, tuple)):
        return [x for t, s in zip(template, specs)
                for x in _spec_list(t, s)]
    return [specs]


def _as_port(pspec) -> dict:
    """A JAX PartitionSpec -> the port's {axis: dim} form."""
    for i, s in enumerate(pspec):
        if AXIS in (s if isinstance(s, tuple) else (s,)):
            return {AXIS: i}
    return {}


def _jax_spec_list(specs) -> list:
    return [_as_port(p) for p in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("msize", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_tp_specs_equal_jax(arch, msize):
    cfg = get_config(arch, smoke=True)
    jcfg = j_get_config(arch, smoke=True)
    pt = registry.init_params(cfg, torch.Generator().manual_seed(0))
    pj = jax.eval_shape(lambda: j_registry.init_params(
        jcfg, jax.random.PRNGKey(0)))
    want = _jax_spec_list(j_tp_specs(jcfg, pj, msize))
    got = _spec_list(pt, tp_specs(cfg, pt, msize))
    assert got == want
    assert any(got)                       # the rules split something


SMALL_LM = dict(name="tp-lm", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=100,
                rope_theta=1e4, qk_norm=True)
# name -> (port family, JAX family, model-axis size).  base_width 0.1
# gives the CNN widths 13, 6, 13, 26, 51, whose odd leaves the family's
# rules split and make_tp_plane_spec demotes at 2
CASES = {
    "cnn": (lambda: families.cnn_family(base_width=0.125),
            lambda: j_families.cnn_family(base_width=0.125), 2),
    "cnn-demoted": (lambda: families.cnn_family(base_width=0.1),
                    lambda: j_families.cnn_family(base_width=0.1), 2),
    "mlp": (families.mlp_family, j_families.mlp_family, 4),
    "lm": (lambda: families.lm_family(_cfg(SMALL_LM)),
           lambda: j_families.lm_family(_jcfg(SMALL_LM)), 4),
    # 3 divides none of the small LM's widths nor its 256 padded vocabulary
    # rows: tp_specs demotes every leaf
    "lm-demoted": (lambda: families.lm_family(_cfg(SMALL_LM)),
                   lambda: j_families.lm_family(_jcfg(SMALL_LM)), 3),
}


def _cfg(d):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**d)


def _jcfg(d):
    from repro.configs.base import ModelConfig
    return ModelConfig(**d)


def _both(case, level=0):
    """(port family, JAX family, msize, JAX params, the same params in the
    port)."""
    mk, mk_j, msize = CASES[case]
    fam, fam_j = mk(), mk_j()
    pj = fam_j.init(jax.random.PRNGKey(7), level)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    return fam, fam_j, msize, pj, pt


@pytest.mark.parametrize("case", list(CASES))
def test_family_param_specs_equal_jax(case):
    fam, fam_j, msize, pj, pt = _both(case)
    assert (_spec_list(pt, fam.param_specs(0, pt, msize, AXIS))
            == _jax_spec_list(fam_j.param_specs(0, pj, msize, AXIS)))


def _plane_specs(case):
    fam, fam_j, msize, pj, pt = _both(case)
    spec = make_tp_plane_spec(pt, fam.param_specs(0, pt, msize, AXIS),
                              msize=msize, axis=AXIS)
    spec_j = j_make_tp_plane_spec(pj, fam_j.param_specs(0, pj, msize, AXIS),
                                  msize=msize, axis=AXIS)
    return spec, spec_j, pj, pt


@pytest.mark.parametrize("case", list(CASES))
def test_tp_plane_is_jax_byte_for_byte(case):
    spec, spec_j, pj, pt = _plane_specs(case)
    assert (spec.d, spec.d_pad, spec.d_loc, spec.msize) == \
        (spec_j.d, spec_j.d_pad, spec_j.d_loc, spec_j.msize)
    assert [r[2] for r in spec.recs] == [r[2] for r in spec_j.recs]
    assert (_spec_list(pt, spec.leaf_specs())
            == _jax_spec_list(spec_j.leaf_specs()))
    got = spec.to_plane(pt).numpy()
    want = np.asarray(spec_j.to_plane(pj))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    if case.endswith("demoted"):
        assert any(r[2] is None for r in spec.recs)


@pytest.mark.parametrize("case", list(CASES))
def test_to_params_inverts_to_plane(case):
    spec, spec_j, pj, pt = _plane_specs(case)
    plane = spec.to_plane(pt)
    back = spec.to_params(plane)
    for a, b in zip(tree_leaves(back), tree_leaves(pt)):
        assert torch.equal(a, b)
    # JAX's unravel of the same plane gives the same leaves
    for a, b in zip(tree_leaves(back),
                    jax.tree.leaves(spec_j.to_params(jnp.asarray(plane)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
def test_local_params_slice_the_whole_leaves(case):
    """Each rank's chunk holds its slice of every split leaf and every
    whole leaf, also with a member axis in front; ``local_to_chunk``
    gives the chunk back exactly."""
    spec, _, _, pt = _plane_specs(case)
    one = spec.to_plane(pt)
    plane = torch.stack([one, -0.5 * one])
    whole = spec.to_params(plane)
    m, d_loc = spec.msize, spec.d_loc
    for r in range(m):
        chunk = plane[:, r * d_loc:(r + 1) * d_loc]
        loc = spec.local_params(chunk)
        for a, b, (shape, _, k, _, _) in zip(tree_leaves(loc),
                                             tree_leaves(whole), spec.recs):
            if k is not None:
                n = shape[k] // m
                b = b.narrow(1 + k, r * n, n)
            assert torch.equal(a, b)
        assert torch.equal(spec.local_to_chunk(loc), chunk)
