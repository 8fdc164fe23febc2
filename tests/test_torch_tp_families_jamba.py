"""jamba's dispatch runs on 1x2 and its unsharded banked block against
JAX's, of the tests of the tensor-parallel member forward
(``tests/test_torch_tp_families.py``'s docstring describes them; its
member gradients are in ``_grads``), in a rank world of their own.
Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_families_suite import suite

globals().update(suite(families=("jamba",),
                       jax_runs=(("jamba", "buffered"),)))
