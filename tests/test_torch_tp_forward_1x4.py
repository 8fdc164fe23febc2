"""The tensor-parallel member forward's runs on the 1x4 mesh, and the
unsharded LM's buffered run against JAX's, of the tests of
``tests/test_torch_tp_forward.py`` (whose docstring describes them), in a
rank world of their own.  Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_forward_suite import suite

globals().update(suite(meshes=("1x4",), jax_runs=(('lm', 'buffered'),)))
