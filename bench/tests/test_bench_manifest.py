"""BENCHMARK.json against the contract, and every file it names resolving
by name."""
import json
import re

import pytest

from bench import manifest
from bench.kinds import lm as lm_kind

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E_NAMES = {"samples_per_s", "tokens_per_s", "peak_mem_gib", "setup_s"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_lines(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in bench["configs"] + bench["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_configs_resolve(bench):
    root = manifest.ROOT
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/configs/")
        cfg = json.loads((root / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells_resolve(bench):
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        cell = manifest.cell(w["name"], bench)
        own = {"first_round_gap", "first_round_median", "loss_gap",
               "change_gap", "change_median", "eval_gap"}
        names = {"layout"} | own | {"kd_" + n for n in own}
        assert set(cell["limits"]) <= names
        assert cell["limits"]["layout"] == 0
        assert "first_round_gap" in cell["limits"]
        # a KD cell holds its slave clusters to numbers of their own
        if cell["traffic"]["fl"]["use_kd"]:
            assert any(n.startswith("kd_") for n in cell["limits"])
        assert cell["trace_calls"] >= 1
        got = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2 and got <= E2E_NAMES
        assert cell["per_layer"]


def test_metric_readers_resolve(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert set(e2e) == E2E_NAMES and e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        r = manifest.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:          # each listed cell reports `moves`
            assert m["moves"] in {e["name"] for e in
                                  manifest.cell(w, bench)["end_to_end"]}
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_lm_config_is_what_runs():
    """The file's model keys build the program's config, and every field in
    which the architecture departs from the config defaults is in the
    file."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    cell = manifest.cell("olmo1b.fl14_kd")
    cfg = cell["config"]
    mc = lm_kind.model_config(cfg)
    arch = get_config(cfg["arch"])
    default = ModelConfig(name="x", family="dense", n_layers=1, d_model=1,
                          n_heads=1, n_kv_heads=1, head_dim=1, d_ff=1,
                          vocab_size=1)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "norm_type", "rope_theta",
              "tie_embeddings", "qk_norm", "sliding_window", "attn_softcap",
              "final_softcap", "residual_scale", "embed_scale",
              "logit_scale", "n_experts", "mrope_sections", "use_rope"):
        if f in cfg:
            assert getattr(mc, f) == cfg[f]
        else:
            assert getattr(arch, f) == getattr(default, f) or f == "family"
    assert arch.n_layers == cfg["published"]["n_layers"]
