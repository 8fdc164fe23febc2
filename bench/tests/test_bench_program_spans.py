"""The readers of the program's own spans: on the small cells with
``--trace 1`` on the CPU each reports a value, the padded-row share is
the layout's, the host draw is part of ``init_params_ms``; on hand-made
events the arithmetic, and None where a program records no such span.
The stand-alone probe of the program's ranges runs on a small cell, and no
range name holds what the roofline readers match kernel names by."""
import json
from types import SimpleNamespace

import pytest

from bench import manifest, port_spans, probe_port_ranges
from bench.tests import small
from bench.tests.test_bench_run import load_run

NEW = ("init_draw_ms", "dispatch_host_ms", "padded_row_share")


@pytest.fixture(scope="module")
def run():
    return load_run()


def block(members, capacity, R):
    return {"name": "block_exec", "dur": 1000.0,
            "args": {"level": 0, "R": R, "capacity": capacity,
                     "members": members}}


@pytest.mark.parametrize("make,suffix", [(small.cnn_cell, "cnn"),
                                         (small.lm_cell, "lm")])
def test_traced_small_cell_reports_each(run, capsys, make, suffix):
    cell = make()
    out = run.run_cell(cell, 2 ** 31 + 41, 0.2, True, device="cpu")
    assert out["correct"] is True
    got = out["metrics"]
    for name in NEW:
        assert f"{name}.{suffix}" in got
    head = json.loads(capsys.readouterr().out.splitlines()[0])
    lay = head["layout"].values()
    want = 100.0 * sum(v["capacity"] - v["members"] for v in lay) / sum(
        v["capacity"] for v in lay)
    assert got[f"padded_row_share.{suffix}"]["value"] == pytest.approx(
        want, abs=1e-9)
    draw = got[f"init_draw_ms.{suffix}"]["value"]
    assert 0 < draw <= got[f"init_params_ms.{suffix}"]["value"]
    assert got[f"dispatch_host_ms.{suffix}"]["value"] > 0


def test_padded_row_share_of_the_cells_layouts():
    # cnn.paper40_kd: 39 of 64 and 1 of 1; olmo1b.fl14_kd: 6 of 8, 8 of 8;
    # four rounds a block
    cnn = SimpleNamespace(port_events=[block(39, 64, 4), block(1, 1, 4)])
    lm = SimpleNamespace(port_events=[block(6, 8, 4), block(8, 8, 4)])
    assert port_spans.padded_row_share(cnn) == pytest.approx(100 * 100 / 260)
    assert port_spans.padded_row_share(lm) == 12.5


def test_per_call_ms_is_the_total_over_the_timed_calls():
    ev = [{"name": "init_params.draw", "dur": d} for d in (1000, 3000, 2000)]
    run = SimpleNamespace(port_events=ev, calls={3, 5})
    assert port_spans.per_call_ms(run, "init_params.draw") == 3.0


def test_a_program_without_the_spans_reads_none():
    # the block span without its member count, and no draw or prepare span
    ev = [{"name": "block_exec", "dur": 5.0,
           "args": {"level": 0, "R": 4, "capacity": 64}}]
    run = SimpleNamespace(port_events=ev, calls={1})
    for name in NEW:
        for suffix in ("cnn", "lm"):
            assert manifest.reader(f"{name}.{suffix}").read(run) is None


def test_probe_of_the_program_ranges_on_a_small_cell():
    out = probe_port_ranges.probe(small.cnn_cell(), 2 ** 31 + 43, 1, "cpu")
    assert len(out["call_s"]["clean"]) == len(out["call_s"]["traced"]) == 1
    assert out["host_spans_per_call"]["member_update"] >= 1
    prof = out["profile"]
    ranges = set(prof["ranges"])
    assert {"port.cluster", "port.init_params.draw", "port.dispatch.prepare",
            "port.block_exec", "port.teacher_forward",
            "port.member_update"} <= ranges
    # bench/readers.roofline matches kernel names by these substrings
    assert not any("fedagg" in n or "flash_" in n for n in ranges)
    # no device on the CPU: nothing is busy, no kernel is counted, and the
    # one gap is the window, named by a range that covers most of it
    assert prof["busy_s"] == 0 and prof["n_kernels"] == 0
    (name, gap_s), = prof["gaps_top"]
    assert name in ranges and gap_s == pytest.approx(prof["window_s"])
