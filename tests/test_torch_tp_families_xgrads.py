"""The member-gradient cases of xlstm-350m (its scan and chunkwise
routes, and with 2 heads) and of seamless-m4t-medium's FL build, of the
tests of the tensor-parallel member forward
(``tests/test_torch_tp_families.py``'s docstring describes them), in a
rank world of their own.  Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_families_suite import suite

globals().update(suite(grad_cases=(("xlstm", 0), ("xlstm-chunk", 0),
                                   ("xlstm-h2", 0), ("seamless", 0))))
