"""granite-moe's dispatch runs on 2x2 and 1x4, and its unsharded banked
block against JAX's, of the tests of the tensor-parallel member forward
(``tests/test_torch_tp_families.py``'s docstring describes them, and
holds its runs on 1x2), in a rank world of their own.  Tolerance rtol
2e-4 / atol 1e-5 in fp32.
"""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_families_suite import suite

globals().update(suite(families=("granite",), meshes=("2x2", "1x4"),
                       jax_runs=(("granite", "buffered"),)))
