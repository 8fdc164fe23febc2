"""Port parity for the tensor-parallel member forward (``tp_forward=True``
on a 2D mesh): the meshes 1x2 (two replicas side by side; this file),
2x2 and 1x4 (``test_torch_tp_forward_2x2.py`` and ``_1x4.py``), each in a
spawn of 4 gloo ranks of its own (``_torch_tp_common``, the tests in
``_torch_tp_forward_suite``).

* Megatron's four operations (``models.tp``) and the max over the ranks,
  under ``vmap(grad)`` over members, against the unsharded gradients.
* The dispatch path for the MLP, the CNN and a small dense LM (GQA with
  qk-norm on the flash route; at a model axis of 4 its ``wk`` split cuts
  through a head), each with "sync" (``train()``: FedAvg, then the slave
  under a fixed KD teacher) and "buffered" (a banked block per level, the
  slave on a per-round teacher stack), and a CNN whose odd widths demote
  leaves on 1x2.  Every run of a family held to JAX here starts from
  JAX's parameter draw and takes JAX's batch-index draws (the others from
  the port's own, recorded from the unsharded run).  Each mesh run is held at rtol 2e-4 / atol
  1e-5 to the port's unsharded engine, and that engine to JAX's
  single-device path (``JAX_RUNS``, the sync run in the 2x2 file and the
  buffered one in the 1x4 file; the LM's JAX side on its plain
  ``jnp`` attention, the port's on the flash route's plain version);
  accuracy curves within one test sample.
* Every whole (replicated) leaf's copies in a TP plane are bit-equal
  across the chunks; fedagg runs on each rank's (C/n, d_loc) block as
  often as the unsharded engine runs it; no plane column is gathered over
  ``model`` inside a block (only the block's outputs at its end).
* The small LM with remat=True, and with query groups that straddle the
  ranks (2) or query heads that do not split (4): each rank's member
  gradients under the TP forward equal its chunk of the unsharded ones.
* Every arch's FL family takes JAX's tensor-parallel specs (the same
  split per leaf, at model-axis sizes 2 and 4), and a granite-moe engine
  builds on 1x2 both with the TP forward and with ``tp_forward=False``.
"""
import jax
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import families as j_families

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_forward_suite import suite
from repro_torch.configs import get_config, list_archs
from repro_torch.core.families import lm_family
from test_torch_tp_specs import _jax_spec_list, _spec_list

globals().update(suite(meshes=("1x2",), moe=True))


@pytest.mark.parametrize("msize", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_lm_family_specs_equal_jax(arch, msize):
    """``lm_family(...).param_specs`` refuses no arch and gives JAX's
    family's specs leaf by leaf, at both levels of the smoke config."""
    fam = lm_family(get_config(arch, smoke=True), 0.5)
    fam_j = j_families.lm_family(j_get_config(arch, smoke=True), 0.5)
    for level in (0, 1):
        pt = fam.init(torch.Generator().manual_seed(0), level)
        pj = jax.eval_shape(lambda: fam_j.init(jax.random.PRNGKey(0), level))
        got = _spec_list(pt, fam.param_specs(level, pt, msize, "model"))
        want = _jax_spec_list(fam_j.param_specs(level, pj, msize, "model"))
        assert got == want and any(got)
