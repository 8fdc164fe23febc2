"""The plain reference against the program on the CPU: Procedure 1 and 2
at the cells' own sizes, and each model's forward and loss at a small
size from the same draws."""
import pytest
import torch

from bench import manifest, program, timeline, traffic
from bench.reference import cnn as ref_cnn, fedrac, lm as ref_lm
from bench.reference.numerics import FP32
from bench.tests import small


@pytest.mark.parametrize("name", ["cnn.paper40_kd", "olmo1b.fl14_kd"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_layout_equals_the_programs(name, seed):
    cell = manifest.cell(name)
    fed = traffic.generate(cell["traffic"], cell["config"], seed)
    eng = program.build_engine(cell["config"], cell["traffic"], fed, seed,
                               "cpu", timeline.Spans(torch, False, False))
    members, n_eff = fedrac.federation_layout(
        fed, cell["config"], cell["traffic"]["fl"], seed,
        fedrac.model_module(cell["config"]["reference"]))
    assert {l: m for l, m in members.items() if m} == {
        l: list(m) for l, m in eng.assignment.members.items() if m}
    assert n_eff == {int(k): int(v) for k, v in eng.assignment.n_eff.items()}


def test_cnn_logits_equal_the_programs():
    from repro_torch.core.families import cnn_family
    cfg = small.cnn_cell()["config"]
    fam = cnn_family(base_width=cfg["base_width"], alpha=cfg["alpha"])
    x = torch.randn(5, 14, 14, 1)
    for level in (0, 1, 2):
        p = program.flat_params(fam.init(torch.Generator().manual_seed(
            9 + level), level))
        r = ref_cnn.init(cfg, level, 9)
        assert all(torch.equal(p[k], r[k]) for k in r) and p.keys() == r.keys()
        _, want = fam.loss_and_logits(level, fam.init(
            torch.Generator().manual_seed(9 + level), level),
            {"x": x, "y": torch.zeros(5, dtype=torch.long)})
        got = ref_cnn.logits(cfg, level, r, x, FP32)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_lm_logits_equal_the_programs():
    from repro_torch.core.scaling import compress_config, param_count
    from repro_torch.models import transformer
    from bench.kinds import lm as lm_kind
    cfg = small.lm_cell()["config"]
    mc = lm_kind.model_config(cfg).replace(attn_impl="jnp")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 16))
    for level in (0, 1):
        c = compress_config(mc, cfg["alpha"], level)
        prog = transformer.init_params(
            c, torch.Generator().manual_seed(4 + level))
        r = ref_lm.init(cfg, level, 4)
        p = program.flat_params(prog)
        assert p.keys() == r.keys()
        assert all(torch.equal(p[k], r[k]) for k in r)
        want, _ = transformer.forward(c, prog, tokens)
        got = ref_lm.logits_at(cfg, r, tokens, slice(None), FP32)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert ref_lm.sizes(cfg, level)[0] == 4.0 * param_count(c)
