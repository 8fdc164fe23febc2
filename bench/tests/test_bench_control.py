"""The control at a size a CPU test can hold: the plain reference in
TF32 (emulated here, the card's own precision on the chip) put in the
program's place has to come out as not correct against the cell's
limits, and so does each planted fault; the fp32 reference against
itself is correct."""
import pytest

from bench import check
from bench.control import readings
from bench.tests import small

SEEDS = (3, 2 ** 31 + 41)


@pytest.mark.parametrize("make", [small.cnn_cell, small.lm_cell])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_and_faults_fail(make, seed):
    cell = make()
    got = readings(cell, seed, "cpu")
    if cell["traffic"]["fl"]["use_kd"]:
        # confined to the KD clusters, each has to fail as well
        assert {"tf32_slaves", "half_batch_slaves"} <= set(got)
    for variant, nums in got.items():
        ok, checks = check.judge(nums, cell["limits"])
        assert not ok, (variant, checks)


def test_reference_against_itself_is_correct():
    from bench import traffic
    from bench.control import as_program
    from bench.reference import fedrac
    from bench.reference.numerics import FP32
    import torch
    cell = small.cnn_cell()
    cfg, fl = cell["config"], cell["traffic"]["fl"]
    fed = traffic.generate(cell["traffic"], cfg, 7)
    ref = fedrac.train_call("cnn", cfg, fed, fl, 7, torch.device("cpu"),
                            FP32, classes=10)
    nums = check.numbers(as_program(ref, True), ref, fed["n_test"],
                         fl["use_kd"])
    assert check.judge(nums, cell["limits"])[0]
    assert nums["loss_gap"] == 0.0 and nums["change_gap"] == 0.0
