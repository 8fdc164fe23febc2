"""The segmented initial-weight draw (``core.init_draw``) against the
serial draw it replaces.

A level's draw runs as segments of its generator's stream, each from a
generator jumped ahead by MT19937's characteristic polynomial, on host
threads; the values must be the serial ``family.init(Generator()
.manual_seed(s), level)``'s bit for bit.  The planner takes its worker count
and least piece as arguments, so these tests cut small levels into many
pieces and run them on one thread.
"""
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import init_draw
from repro_torch.core import server as srv
from repro_torch.core.families import cnn_family, lm_family, mlp_family
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import lm_batches, make_lm_corpus
from repro_torch.obs import make_observability

SEEDS = (0, 3, 987654321987)
# widths whose draws are not multiples of 16 (30 x 30, 30 x 70, ...)
LM = dict(name="draw-lm", family="dense", n_layers=2, d_model=30, n_heads=3,
          n_kv_heads=3, head_dim=10, d_ff=70, vocab_size=61, rope_theta=1e4)
FAMILIES = {"cnn": lambda: cnn_family(base_width=0.125),
            "mlp": lambda: mlp_family(hidden=37),
            "lm": lambda: lm_family(ModelConfig(**LM), 0.5)}


def serial(fam, level, seed):
    return fam.init(torch.Generator().manual_seed(seed), level)


def segmented(fam, level, seed, workers, min_piece):
    """A level's segmented draw, its segments run in order on this
    thread; (tree, segments)."""
    plan = init_draw.plan_draws(fam.init, level)
    segments = plan.segments(workers, min_piece)
    job = init_draw.LevelDraw(fam.init, level, seed, plan, segments)
    for task in job.tasks():
        task()
    return job.tree.result(timeout=0), segments


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def rand_after(state, k=0, n=1500):
    g = torch.Generator()
    g.set_state(state)
    if k:
        torch.rand(k, generator=g)
    return torch.rand(n, generator=g)


# ------------------------------------------------------------------ jump
@pytest.mark.parametrize("k", [0, 1, 623, 624, 625, 1_000_016])
def test_jump_equals_the_stream_k_words_on(k):
    seeded = torch.Generator().manual_seed(987654321987).get_state()
    jumped = init_draw.jump_state(seeded, init_draw.jump_poly(k))
    assert torch.equal(rand_after(jumped), rand_after(seeded, k))


def test_jump_above_two_to_the_32():
    """Past 2**32 words the stream cannot be drawn here: the jump of k
    equals the jump of k - d then d words drawn."""
    k, d = 2 ** 32 + 1_000_003, 1_000_016
    seeded = torch.Generator().manual_seed(3).get_state()
    far = init_draw.jump_state(seeded, init_draw.jump_poly(k))
    near = init_draw.jump_state(seeded, init_draw.jump_poly(k - d))
    assert torch.equal(rand_after(far), rand_after(near, d))


@pytest.mark.parametrize("n", [16, 17, 31, 48, 1001])
def test_randn_consumes_its_length_and_a_redrawn_tail(n):
    """The rule the plan rests on: a contiguous fp32 randn of n >= 16 takes
    n words, and 16 more when n % 16 != 0."""
    g = torch.Generator().manual_seed(5)
    torch.randn(n, generator=g)
    words = n + (16 if n % 16 else 0)
    seeded = torch.Generator().manual_seed(5).get_state()
    jumped = init_draw.jump_state(seeded, init_draw.jump_poly(words))
    assert torch.equal(rand_after(g.get_state()), rand_after(jumped))


def test_jump_needs_a_fresh_generator():
    g = torch.Generator().manual_seed(1)
    torch.rand(3, generator=g)
    with pytest.raises(ValueError, match="freshly seeded"):
        init_draw.jump_state(g.get_state(), init_draw.jump_poly(5))


# ---------------------------------------------------------------- values
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_segmented_draw_equals_the_serial_draw(family, level, seed):
    fam = FAMILIES[family]()
    tree, segments = segmented(fam, level, seed, workers=8, min_piece=32)
    assert segments is not None and len(segments) >= 4
    assert_trees_equal(tree, serial(fam, level, seed))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_draws_the_serial_values(arch):
    """The LM family of every architecture (MoE routers, Mamba, xLSTM,
    enc-dec at smoke size) records a placeable plan and draws its bits."""
    fam = lm_family(get_config(arch, smoke=True), 0.5)
    tree, segments = segmented(fam, 1, 5, workers=8, min_piece=64)
    assert segments is not None
    assert_trees_equal(tree, serial(fam, 1, 5))


def test_segments_cut_inside_draws_and_keep_tails():
    """The LM's plan has draws of n % 16 != 0 and cuts inside a draw,
    each piece 16-aligned unless it ends its draw."""
    plan = init_draw.plan_draws(FAMILIES["lm"]().init, 0)
    assert any(d.numel % 16 for d in plan.draws)
    segments = plan.segments(8, 32)
    ends = {d.start + d.numel for d in plan.draws}
    starts = {d.start for d in plan.draws}
    assert any(s.pieces[0][0] not in starts for s in segments)
    for s in segments:
        for start, length in s.pieces:
            assert length >= 32 or start in starts
            assert start + length in ends or length % 16 == 0
    covered = sorted(p for s in segments for p in s.pieces)
    assert covered[0][0] == 0 and sum(n for _, n in covered) == plan.elements


def test_small_levels_are_one_segment():
    plan = init_draw.plan_draws(FAMILIES["cnn"]().init, 0)
    assert plan.placeable
    assert plan.segments(4, init_draw.MIN_PIECE) is None
    assert plan.segments(1, 32) is None


def test_plan_draws_nothing():
    g = torch.Generator().manual_seed(7)
    before = g.get_state()
    plan = init_draw.plan_draws(lambda gen, level: FAMILIES["lm"]().init(
        g, level), 1)
    assert plan.placeable and plan.draws
    assert torch.equal(g.get_state(), before)


def test_pool_threads_fill_one_buffer():
    """Many segments on more threads than cores, with the interpreter
    switching often: every segment's countdown lands and the values hold."""
    fam = FAMILIES["lm"]()
    plan = init_draw.plan_draws(fam.init, 0)
    segments = plan.segments(32, 16)
    assert len(segments) >= 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            for seed in SEEDS:
                job = init_draw.LevelDraw(fam.init, 0, seed, plan, segments)
                for task in job.tasks():
                    pool.submit(task)
                assert_trees_equal(job.tree.result(timeout=60),
                                   serial(fam, 0, seed))
    finally:
        sys.setswitchinterval(interval)


# -------------------------------------------------------------- fallback
def odd_family(short: bool, bf16: bool):
    """An MLP family whose init adds a 7-element draw, a bf16 draw, or
    both, between two large fp32 draws."""
    base = mlp_family(hidden=37)

    def init(generator, level):
        p = base.init(generator, level)
        if short:
            p["short"] = torch.randn((7,), generator=generator)
        if bf16:
            p["half"] = torch.randn((40,), generator=generator,
                                    dtype=torch.bfloat16)
        p["tail"] = torch.randn((50, 30), generator=generator) * 0.1
        return p

    return srv.FLModelFamily(init=init, loss_and_logits=base.loss_and_logits,
                             model_bytes=base.model_bytes,
                             flops_per_sample=base.flops_per_sample)


def counters(eng):
    c = eng.obs.registry.counters
    return {k: c[k].value if k in c else 0
            for k in ("fl/init_draw_segments", "fl/init_draw_serial_levels")}


def bare_engine(family, monkeypatch, workers=4, min_piece=32):
    """An engine for ``init_params`` alone (no setup), its draws cut at a
    small least piece on a pool of ``workers``."""
    monkeypatch.setattr(init_draw, "MIN_PIECE", min_piece)
    monkeypatch.setattr(init_draw, "workers", lambda: workers)
    V = TABLE_III[:4]
    eng = srv.FedRAC(participants_from_matrix(V, n_data=[8] * 4),
                     [{"x": np.zeros((8, 196), np.float32),
                       "y": np.zeros(8, np.int32)}] * 4, family,
                     srv.FLConfig(seed=11), classes=10, device="cpu")
    eng.obs = make_observability(trace=False)
    return eng


@pytest.mark.parametrize("short,bf16", [(True, False), (False, True),
                                        (True, True)])
def test_unplaceable_draws_fall_back_to_one_segment(monkeypatch, short,
                                                    bf16):
    fam = odd_family(short, bf16)
    assert not init_draw.plan_draws(fam.init, 0).placeable
    eng = bare_engine(fam, monkeypatch)
    for level in (0, 1):
        assert_trees_equal(eng.init_params(level),
                           serial(fam, level, 11 + level))
    assert counters(eng) == {"fl/init_draw_segments": 2,
                             "fl/init_draw_serial_levels": 2}


def test_placeable_family_is_cut(monkeypatch):
    fam = odd_family(False, False)
    eng = bare_engine(fam, monkeypatch)
    assert_trees_equal(eng.init_params(0), serial(fam, 0, 11))
    assert counters(eng) == {"fl/init_draw_segments": 4,
                             "fl/init_draw_serial_levels": 0}


# ---------------------------------------------------------------- engine
class TokenFedRAC(srv.FedRAC):
    """Token-only data with the KD hard label; evaluation is -loss."""

    def _batch_from_gathered(self, g):
        return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    def evaluate(self, level, params, test):
        with torch.no_grad():
            loss, _ = self.family.loss_and_logits(level, params,
                                                  self._to_device(test))
        return -float(loss)


def lm_engine(cls=TokenFedRAC):
    corpus = make_lm_corpus(61, 4_000, seed=0)
    cd = [{"tokens": lm_batches(ch, 16, 9, 1, seed=i)[0]}
          for i, ch in enumerate(np.array_split(corpus, 6))]
    V = TABLE_III[np.random.default_rng(0).integers(0, 40, 6)]
    test = {"tokens": lm_batches(corpus, 8, 9, 1, seed=99)[0]}
    eng = cls(participants_from_matrix(V, n_data=[16] * 6), cd,
              lm_family(ModelConfig(**LM), 0.5),
              srv.FLConfig(steps_per_round=2, lr=0.05, seed=0, local_batch=4,
                           compact_to=2, class_balanced=False, rounds=2,
                           rounds_per_dispatch=2),
              classes=61, device="cpu").setup()
    assert eng.assignment.members[0] and eng.assignment.members[1]
    return eng, test


def test_init_params_equals_the_serial_draw(monkeypatch):
    monkeypatch.setattr(init_draw, "MIN_PIECE", 64)
    monkeypatch.setattr(init_draw, "workers", lambda: 4)
    eng, _ = lm_engine()
    eng.obs = make_observability(trace=False)
    for level in range(eng.m):
        got = eng.init_params(level)
        assert_trees_equal(got, serial(eng.family, level, level))
    assert counters(eng) == {"fl/init_draw_segments": 4 * eng.m,
                             "fl/init_draw_serial_levels": 0}


def test_train_draws_anew_each_call(monkeypatch):
    """Two calls give bit-equal histories and final planes, each drawing
    every level anew; the call keeps no draw once it returns."""
    monkeypatch.setattr(init_draw, "MIN_PIECE", 64)
    monkeypatch.setattr(init_draw, "workers", lambda: 4)
    eng, test = lm_engine()
    eng.obs = make_observability(trace=False)
    runs = []
    for call in (1, 2):
        res = eng.train(test)
        planes = {l: eng.plane_of(l, p) for l, p in eng.cluster_params.items()}
        runs.append((res.history, planes))
        assert counters(eng) == {"fl/init_draw_segments": 4 * eng.m * call,
                                 "fl/init_draw_serial_levels": 0}
        assert eng._init_draws is None
        assert all(isinstance(p, init_draw.DrawPlan)
                   for p in eng._draw_plans.values())
    (h1, p1), (h2, p2) = runs
    assert h1 == h2 and p1.keys() == p2.keys()
    assert all(torch.equal(p1[l], p2[l]) for l in p1)


def test_an_override_gets_its_own_tree(monkeypatch):
    """An ``init_params`` that never calls ``super()`` gets exactly its own
    tree (here the serial draw), so it trains as the segmented engine does;
    the draws ``train()`` queued for it are dropped when it returns."""
    monkeypatch.setattr(init_draw, "MIN_PIECE", 64)
    monkeypatch.setattr(init_draw, "workers", lambda: 4)

    class Own(TokenFedRAC):
        def init_params(self, level):
            return self._to_device(serial(self.family, level,
                                          self.cfg.seed + level))

    results = {}
    for cls in (Own, TokenFedRAC):
        eng, test = lm_engine(cls)
        eng.obs = make_observability(trace=False)
        res = eng.train(test)
        results[cls] = (res.history, {l: eng.plane_of(l, p) for l, p in
                                      eng.cluster_params.items()},
                        counters(eng))
        assert eng._init_draws is None
    (h1, p1, c1), (h2, p2, c2) = results[Own], results[TokenFedRAC]
    assert h1 == h2 and all(torch.equal(p1[l], p2[l]) for l in p1)
    assert c1["fl/init_draw_segments"] == 0 < c2["fl/init_draw_segments"]
