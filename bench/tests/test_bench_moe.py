"""The MoE kind on the CPU: the plain Granite reference against the program
(its draws, logits, load-balancing term and sizes, then a small
granite-shaped cell end to end through ``run.run_cell``: dropless
routing, the four µP multipliers, KD on), the kind's model FLOPs and
grouped GEMM work by hand, and the two MoE readers on a stand-in run."""
import copy
from types import SimpleNamespace

import pytest
import torch

from bench import counts, manifest, program
from bench.kinds import moe as moe_kind
from bench.reference import moe as ref_moe
from bench.reference.numerics import FP32
from bench.tests.small import FL_SMALL
from bench.tests.test_bench_run import load_run

CELL = "granite_moe.fl14_kd"


def moe_cell(E=32, K=8):
    """The cell at a small width, granite's expert count and top-k, the
    multipliers and KD as the file has them.  Its two change limits are
    this size's: a member here moves each RMSNorm scale (which starts at
    1, where fp32's step is 1.2e-7) by about 1e-5 a step over 64 of them
    in place of 1,024, so the scales' change norms carry about a
    hundredth of rounding each, 2.5e-4 as a worst-leaf gap; the full
    cell's 14 sound seeds read under 1e-4."""
    cell = copy.deepcopy(manifest.cell(CELL))
    cell["limits"].update(change_gap=1e-3, kd_change_median=3e-5)
    cell["config"].update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          d_ff=32, vocab_size=512, n_experts=E,
                          experts_per_tok=K)
    cell["traffic"].update(pick=6, corpus_tokens=3000, seq=32,
                           windows_per_member=8, test_windows=4)
    cell["traffic"]["fl"].update(FL_SMALL, local_batch=2)
    return cell


def test_the_file_is_what_runs():
    """The file's model keys build the program's config: the published
    widths, dropless routing and the four multipliers."""
    cfg = manifest.cell(CELL)["config"]
    mc = moe_kind.model_config(cfg)
    assert (mc.d_model, mc.n_heads, mc.n_kv_heads, mc.head_dim, mc.d_ff,
            mc.n_experts, mc.experts_per_tok, mc.vocab_size,
            mc.padded_vocab) == (1024, 16, 8, 64, 512, 32, 8, 49155, 49408)
    assert (mc.embed_scale, mc.attn_scale, mc.softmax_scale,
            mc.residual_scale, mc.logit_scale) == (12.0, 0.015625, 0.015625,
                                                   0.22, 1 / 6)
    assert mc.moe_impl == "dropless" and mc.n_layers == 4
    assert mc.family == "moe" and mc.tie_embeddings
    assert cfg["published"]["n_layers"] == 24


@pytest.mark.parametrize("level", [0, 1])
def test_sizes_equal_the_programs_at_full_width(level):
    """Procedure 2 sizes the clusters by these: the reference's count of
    the parameters equals the FL family's, so the layouts agree."""
    from repro_torch.core.scaling import compress_config, param_count
    cfg = manifest.cell(CELL)["config"]
    c = compress_config(moe_kind.model_config(cfg), cfg["alpha"], level)
    assert ref_moe.sizes(cfg, level)[0] == 4.0 * param_count(c)
    assert (ref_moe.n_experts(cfg, level), counts.lm_d_ff(cfg, level)) == \
        (c.n_experts, c.d_ff) == ((32, 512), (16, 256))[level]


def test_logits_and_aux_equal_the_programs():
    from repro_torch.core.scaling import compress_config
    from repro_torch.models import transformer
    cfg = moe_cell()["config"]
    mc = moe_kind.model_config(cfg).replace(attn_impl="jnp")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 16))
    for level in (0, 1):
        c = compress_config(mc, cfg["alpha"], level)
        prog = transformer.init_params(
            c, torch.Generator().manual_seed(4 + level))
        r = ref_moe.init(cfg, level, 4)
        p = program.flat_params(prog)
        assert p.keys() == r.keys()
        assert all(torch.equal(p[k], r[k]) for k in r)
        want, want_aux = transformer.forward(c, prog, tokens)
        got, aux = ref_moe.logits_at(cfg, r, tokens, slice(None), FP32)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=1e-6)


def test_check_refuses_what_it_does_not_cover():
    cfg = manifest.cell(CELL)["config"]
    ref_moe.check(cfg)
    for bad in ({"moe_impl": "capacity"}, {"norm_type": "layernorm"},
                {"qk_norm": True}, {"attn_scale": 0.0}):
        with pytest.raises(ValueError):
            ref_moe.check(dict(cfg, **bad))


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_granite_cell_end_to_end(trace):
    run = load_run()
    cell = moe_cell()
    out = run.run_cell(cell, 2 ** 31 + 61, 0.2, trace, device="cpu")
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["layout"]["value"] == 0
    # the losses and evaluations agree far inside the limits here
    assert all(c["value"] < 1e-5 for k, c in out["checks"].items()
               if "change" not in k)
    assert {"kd_first_round_gap", "first_round_gap"} <= set(out["checks"])
    if trace:
        # no kernels on the CPU: the device readings read nothing
        got = set(out["metrics"])
        assert {"mfu.moe", "block_ms.moe", "init_draw_ms.moe",
                "padded_row_share.moe", "evaluate_ms.moe",
                "init_params_ms.moe", "dispatch_host_ms.moe"} <= got
        assert not {"moe_ms.moe", "grouped_gemm_roofline.moe"} & got


# ------------------------------------------------------------- by hand
SMALL = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 20, "n_experts": 4,
         "experts_per_tok": 2, "alpha": 0.5}


def test_flops_by_hand():
    # level 0: per token 2*8*8 (wq, wo) + 2*8*4 (wk, wv) + 8*4 (router) +
    # 2*3*8*16 (two routed experts of 4) = 128 + 64 + 32 + 768 = 992;
    # S = 4: 10 causal pairs, 4*10*4*2 = 320 a layer; head 2*8*20*3
    assert moe_kind.moe_forward(SMALL, 0, 4, 3) == \
        2 * (2 * 992 * 4 + 320) + 960
    # level 1: 2 experts of 16 (16 * 0.5 rounds up to 16), router 8*2
    assert moe_kind.n_experts(SMALL, 1) == 2
    assert moe_kind.moe_forward(SMALL, 1, 4, 1) == \
        2 * (2 * (128 + 64 + 16 + 768) * 4 + 320) + 2 * 8 * 20
    traffic = {"seq": 4, "fl": {"rounds": 2, "steps_per_round": 3,
                                "local_batch": 5, "use_kd": True}}
    want = (2 * 30 * 3 * moe_kind.moe_forward(SMALL, 0, 4, 3)
            + 2 * 7 * moe_kind.moe_forward(SMALL, 0, 4, 3)
            + 30 * (3 * moe_kind.moe_forward(SMALL, 1, 4, 1)
                    + moe_kind.moe_forward(SMALL, 0, 4, 1))
            + 2 * 7 * moe_kind.moe_forward(SMALL, 1, 4, 3))
    assert moe_kind.flops_per_call(SMALL, traffic, {0: 2, 1: 1}, 7) == want


def test_the_cells_model_flops_count_eight_experts():
    """At the cell's widths a token's expert work is 8 * 3 * 1024 * 512 * 2
    a layer, a quarter of what all 32 would need."""
    cfg = manifest.cell(CELL)["config"]
    all_32 = dict(cfg, experts_per_tok=32)
    one = moe_kind.moe_forward(cfg, 0, 1, 0)
    assert moe_kind.moe_forward(all_32, 0, 1, 0) - one == \
        4 * 2 * 24 * 3 * 1024 * 512


def test_grouped_gemm_work_by_hand():
    traffic = {"seq": 4, "fl": {"rounds": 2, "steps_per_round": 3,
                                "local_batch": 5, "use_kd": True}}
    work = moe_kind.grouped_gemm_launches(SMALL, traffic, {0: 3, 1: 2}, 7)
    L, d = 2, 8
    # launches: each level 9 a layer and step (6 steps), 3 a layer and
    # round for its evaluation, and the slave 3 more for its teacher
    assert sum(n for n, _, _ in work) == (
        2 * (9 * 6 * L + 3 * 2 * L) + 3 * 2 * L)
    by = {}
    for n, b, o in work:
        by.setdefault(o, []).append((n, b))
    # the master's step: M = 3 members * 5 * 4 tokens * 2 = 120 rows in
    # 3 * 4 groups of d 8 -> f 16
    M, G, f = 120, 12, 16
    ops = 2 * M * d * f
    gate = 4 * (M * d + G * d * f + M * f) + 8 * (G + 1)
    down = 4 * (M * f + G * f * d + M * d) + 8 * (G + 1)
    wg = 4 * (M * d + M * f + G * d * f) + 8 * (G + 1)
    assert sorted(by[ops]) == sorted([(2 * 6 * L, gate), (6 * L, down),
                                      (2 * 6 * L, down), (6 * L, gate),
                                      (2 * 6 * L, wg), (6 * L, wg)])
    # the slave's teacher: 2 members * 3 steps * 5 * 4 tokens * 2 = 240
    # rows of the master's 4 experts, each round
    Mt = 240
    teacher = [(n, b) for n, b, o in work if o == 2 * Mt * d * 16]
    assert sorted(teacher) == sorted([
        (2 * 2 * L, 4 * (Mt * d + 4 * d * 16 + Mt * 16) + 8 * 5),
        (2 * L, 4 * (Mt * 16 + 4 * 16 * d + Mt * d) + 8 * 5)])


# --------------------------------------------------------------- readers
def _prof(launches, ms):
    return {"by_op": {"grouped_gemm_rows_kernel<false>": ms / 2e3,
                      "void grouped_gemm_wgrad_kernel": ms / 2e3,
                      "other": 1.0},
            "count_by_op": {"grouped_gemm_rows_kernel<false>": launches - 1,
                            "void grouped_gemm_wgrad_kernel": 1,
                            "other": 5}}


def _stand_in(launches, per_call, ms, n_prof=1, spans_calls=2,
              cell=CELL):
    """A traced run of ``cell`` whose blocks hold 6 of 8 and 8 of 8."""
    blocks = [{"name": "block_exec", "args": {"level": 0, "capacity": 8,
                                              "R": 4, "members": 6}},
              {"name": "block_exec", "args": {"level": 1, "capacity": 8,
                                              "R": 4, "members": 8}}]
    c = manifest.cell(cell) if isinstance(cell, str) else cell
    flops = moe_kind.flops_per_call(c["config"], c["traffic"], {0: 6, 1: 8},
                                    c["traffic"]["test_windows"])
    return SimpleNamespace(
        flops_per_call=flops,
        profile=_prof(launches, ms),
        calls=set(range(n_prof + 1, n_prof + 1 + 2 * spans_calls, 2)),
        counters={"moe/grouped_gemm_launches": per_call * spans_calls},
        port_events=blocks * spans_calls,
        ranges={"moe": {"count": 9, "kernels": 40, "sum_ms": 9.0,
                        "union_ms": 7.5},
                "moe_bwd": {"count": 3, "kernels": 12, "sum_ms": 4.0,
                            "union_ms": 2.5},
                "member_update": {"count": 4, "kernels": 0, "sum_ms": 0.0,
                                  "union_ms": 0.0}})


def test_grouped_gemm_roofline_on_a_stand_in_run():
    cell = manifest.cell(CELL)
    work = moe_kind.grouped_gemm_launches(
        cell["config"], cell["traffic"], {0: 8, 1: 8},
        cell["traffic"]["test_windows"])
    per_call = sum(n for n, _, _ in work)
    # the cell's call: 9 launches a layer and step at each level, 3 a
    # layer and round for each evaluation and for the slave's teacher
    assert per_call == 2 * (9 * 16 * 4 + 3 * 4 * 4) + 3 * 4 * 4 == 1296
    bound = sum(n * counts.bound_ms(b, o)[0] for n, b, o in work)
    reader = manifest.reader("grouped_gemm_roofline.moe")
    run = _stand_in(2 * per_call, per_call, 8 * bound, n_prof=2)
    assert reader.read(run) == pytest.approx(100.0 * 2 * bound
                                             / (8 * bound), rel=1e-12)
    with pytest.raises(ValueError, match="launches"):
        reader.read(_stand_in(2 * per_call - 1, per_call, bound, n_prof=2))
    assert reader.read(SimpleNamespace(profile=None, calls={2})) is None
    none = _stand_in(per_call, per_call, bound)
    none.profile = {"by_op": {"other": 1.0}, "count_by_op": {"other": 1}}
    assert reader.read(none) is None
    # another MoE cell (here two layers more) that listed this reader
    # would get the cell's bound: it raises instead
    other = dict(cell, config=dict(cell["config"], n_layers=6))
    with pytest.raises(ValueError, match="alone"):
        reader.read(_stand_in(2 * per_call, per_call, bound, n_prof=2,
                              cell=other))


def test_moe_ms_on_a_stand_in_run():
    reader = manifest.reader("moe_ms.moe")
    assert reader.read(_stand_in(1, 1, 1.0)) == 7.5 + 2.5
    run = _stand_in(1, 1, 1.0)
    run.ranges["moe_bwd"]["kernels"] = 0
    assert reader.read(run) == 7.5
    assert reader.read(SimpleNamespace(ranges={})) is None
    # the member update's reading leaves the MoE layers to them
    assert manifest.reader("member_update_ms.moe").read(run) is None


def test_control_and_faults_fail_the_small_cell():
    """The plain reference in TF32 (emulated here) and each planted fault,
    put in the program's place, come out as not correct against the
    cell's limits, the KD-confined ones too."""
    from bench import check
    from bench.control import readings
    cell = moe_cell()
    got = readings(cell, 2 ** 31 + 67, "cpu")
    assert {"tf32", "half_batch", "frozen", "tf32_slaves",
            "half_batch_slaves"} == set(got)
    for variant, nums in got.items():
        ok, checks = check.judge(nums, cell["limits"])
        assert not ok, (variant, checks)
