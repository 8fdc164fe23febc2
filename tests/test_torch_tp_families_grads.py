"""granite-moe's member-gradient cases (dense and capacity dispatch,
``moe_shard`` "tp" and "ep", levels 0 and 1) and jamba's, of the tests of
the tensor-parallel member forward (``tests/test_torch_tp_families.py``'s
docstring describes them), in a rank world of their own.  Tolerance rtol
2e-4 / atol 1e-5 in fp32.
"""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_families_suite import suite

globals().update(suite(grad_cases=(
    ("granite", 0), ("granite-cap", 0), ("granite-ep", 0),
    ("granite-ep-cap", 0), ("granite-ep", 1), ("granite-ep-cap", 1),
    ("jamba", 0))))
