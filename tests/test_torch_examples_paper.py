"""The port's paper driver on the CPU (``examples/torch_fedrac_cnn_full.py``):
Fed-RAC then FedAvg, FedProx, Oort and HeteroFL, with its rounds cut to one
and 600 samples.  Its Fed-RAC set-up agrees with the JAX example's on
``k_optimal``, the Dunn indices and the assignment; every baseline returns
finite CPU parameters and a one-round curve.
"""
import numpy as np
import torch

from _torch_examples_common import assert_same_setup, jax_engine, load_example
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.core.tree import tree_leaves


def test_cnn_full_setup_matches_jax_and_runs(capsys):
    ex = load_example("torch_fedrac_cnn_full")
    argv = ["--samples", "600", "--rounds", "1", "--device", "cpu"]
    out = ex.main(argv)
    printed = capsys.readouterr().out
    eng, res = out["Fed-RAC"]
    assert_same_setup(jax_engine(600, 3, 3, 1, input_hw=14), eng)
    assert list(out) == ["Fed-RAC", *ex.BASELINES]
    for name in ex.BASELINES:
        params, hist = out[name]
        assert len(hist) == 1 and 0.0 <= hist[0] <= 1.0
        assert all(bool(torch.isfinite(x).all()) and x.device.type == "cpu"
                   for x in tree_leaves(params))
        assert f"{name}: final=" in printed
    assert np.isfinite(res.global_acc)
