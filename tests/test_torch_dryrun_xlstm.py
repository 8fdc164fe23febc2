"""The compile analysis's sequence extrapolation (``launch.dryrun``): a
program whose per-token Python loop is too long to trace (xlstm-350m at
``train_4k`` and ``prefill_32k``) is traced at two short sequence lengths
and extrapolated along the sequence (the recurrent loops step by
``unbind``, so every count is affine in the sequence).  At smoke size
in a fake world of 2 ranks (mesh 1x2), the line fitted on 32 and 64
tokens of the train step (16 and 32 of prefill) gives, at 128 (64), the
direct trace's FLOPs, bytes accessed and collective bytes within 1e-6
relative, its temporaries within 1 %, and its argument bytes exactly; and
``analyze`` marks the row so extrapolated.  The four traces run in
spawned processes side by side (``_torch_dryrun_common.xlstm_measure``).
"""
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import pytest

from _torch_dryrun_common import xlstm_measure
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun

CASES = (("train", (32, 64, 128)), ("prefill", (16, 32, 64)))


@pytest.fixture(scope="module")
def measured():
    """{(kind, extrapolated): xlstm_measure's result}, the four traces
    in spawned processes side by side."""
    with ProcessPoolExecutor(4, mp_context=get_context("spawn")) as pool:
        futs = {(kind, ex): pool.submit(xlstm_measure, kind, lengths, ex)
                for kind, lengths in CASES for ex in (True, False)}
        return {k: f.result() for k, f in futs.items()}


@pytest.mark.parametrize("kind,lengths", CASES)
def test_sequence_extrapolation_matches_a_direct_trace(measured, kind,
                                                       lengths):
    f, b, c, counts, mem, seq = measured[kind, True]
    f0, b0, c0, counts0, mem0, _ = measured[kind, False]
    assert c0 > 0
    assert f == pytest.approx(f0, rel=1e-6)
    assert b == pytest.approx(b0, rel=1e-6)
    assert c == pytest.approx(c0, rel=1e-6)
    assert counts == counts0
    assert seq == list(lengths[:2])
    assert mem["argument_size_in_bytes"] == mem0["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] == pytest.approx(
        mem0["temp_size_in_bytes"], rel=0.01)


def test_long_xlstm_rows_are_extrapolated():
    cfg = get_config("xlstm-350m")
    for name in ("train_4k", "prefill_32k"):
        assert dryrun.seq_lengths(cfg, INPUT_SHAPES[name]) == \
            dryrun.SEQ_EXTRAPOLATE
        assert dryrun._loop_steps(cfg, dryrun.SEQ_EXTRAPOLATE[1]) <= \
            dryrun.MAX_LOOP_STEPS
    assert dryrun.seq_lengths(cfg, INPUT_SHAPES["decode_32k"]) is None
    assert dryrun.seq_lengths(get_config("olmo-1b"),
                              INPUT_SHAPES["train_4k"]) is None
