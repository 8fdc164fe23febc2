"""``bench/counts.py`` against hand counts on tiny configurations, the
CNN's forward count against PyTorch's FLOP counter on the plain
reference, and each kind's count of its cell's call equal to what the
benchmark printed before the kinds owned their counts."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import counts, manifest, program
from bench.kinds import lm as lm_kind
from bench.reference import cnn as ref_cnn
from bench.reference.numerics import FP32

CNN = {"base_filters": [8, 4, 8, 16, 32], "base_width": 1.0, "alpha": 0.5,
       "classes": 10, "in_channels": 1, "image_hw": 4}
LM = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
      "head_dim": 4, "d_ff": 16, "vocab_size": 20, "alpha": 0.5}


def test_cnn_by_hand():
    # 4x4: 2*9*1*8*16, 2*9*8*4*16; pool to 2x2: 2*9*4*8*4, 2*9*8*16*4;
    # pool to 1x1: 2*9*16*32; head 2*32*10
    assert counts.cnn_layer_flops(CNN, 0) == [2304, 9216, 2304, 9216, 9216,
                                              640]
    assert counts.cnn_forward(CNN, 0) == 32896
    assert counts.cnn_train(CNN, 0) == 3 * 32896 - 2304
    assert counts.cnn_widths(CNN, 1) == [4, 4, 4, 8, 16]


@pytest.mark.parametrize("level", [0, 1])
def test_cnn_forward_matches_flop_counter(level):
    p = ref_cnn.init(CNN, level, seed=0)
    x = torch.randn(3, 4, 4, 1)
    with FlopCounterMode(display=False) as fc:
        ref_cnn.logits(CNN, level, p, x, FP32)
    assert fc.get_total_flops() == 3 * counts.cnn_forward(CNN, level)


def test_lm_by_hand():
    # blocks: 2*8*8 (wq, wo) + 2*8*8 (wk, wv) + 3*8*16 = 640
    assert counts.lm_block_params(LM, 0) == 640
    # S = 4: 10 causal pairs; 2*640*4 + 4*10*4*2 + 2*8*20*3
    assert counts.lm_forward(LM, 0, 4, 3) == 5120 + 320 + 960
    assert counts.lm_train(LM, 0, 4, 1) == 3 * (5120 + 320 + 320)
    # d_ff 16 * 0.5 = 8 rounds to the least multiple of 16
    assert counts.lm_d_ff(LM, 1) == 16
    assert counts.lm_d_ff({"d_ff": 8192, "alpha": 0.5}, 1) == 4096


def test_flops_per_call_by_hand():
    traffic = {"seq": 4, "fl": {"rounds": 2, "steps_per_round": 3,
                                "local_batch": 5, "use_kd": True}}
    # master: 2 members * 30 sequences * train(CE at 3 positions) + 2
    # evaluations of 7 windows; slave: 1 member * 30 * (train at 1
    # position + the master's forward at 1 position) + 2 * 7 evaluations
    want = (2 * 30 * counts.lm_train(LM, 0, 4, 3)
            + 2 * 7 * counts.lm_forward(LM, 0, 4, 3)
            + 30 * (counts.lm_train(LM, 1, 4, 1)
                    + counts.lm_forward(LM, 0, 4, 1))
            + 2 * 7 * counts.lm_forward(LM, 1, 4, 3))
    got = lm_kind.flops_per_call(LM, traffic, {0: 2, 1: 1, 2: 0}, 7)
    assert got == want


# model_flops_per_call of the two cells' layouts as the benchmark printed
# it before each kind owned its count: the same bits
CELL_FLOPS = [("cnn.paper40_kd", {0: 39, 1: 1}, 54704672768000.0),
              ("olmo1b.fl14_kd", {0: 6, 1: 8}, 270876675145728.0)]


@pytest.mark.parametrize("name,members,want", CELL_FLOPS)
def test_each_kind_counts_its_cell_as_before(name, members, want):
    cell = manifest.cell(name)
    cfg, traffic = cell["config"], cell["traffic"]
    n_test = traffic.get("test_samples", traffic.get("test_windows"))
    got = program.kind_module(cfg).flops_per_call(cfg, traffic, members,
                                                  n_test)
    assert got == want


def test_kernel_work_and_bound():
    assert counts.attn_pairs(4, True, 0) == 10
    assert counts.attn_pairs(4, False, 0) == 16
    assert counts.attn_pairs(5, True, 2) == 9
    assert counts.fedagg_work(8, 128) == ((8 * 128 + 8 + 128) * 4,
                                          2 * 8 * 128)
    nbytes, ops = counts.flash_work(6, 2, 4, 8, 4, True, 0)
    assert (nbytes, ops) == ((12 + 4) * 4 * 8 * 4, 4 * 10 * 8 * 6)
    ms, by = counts.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = counts.bound_ms(1.0, 495e9)
    assert by == "operations" and ms == pytest.approx(1.0)
