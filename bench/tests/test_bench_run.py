"""The harness end to end on the CPU at a small size: the result line,
the refusal without a card, the import check, and ``correct`` coming out
false with the timed path broken underneath."""
import importlib.util
import json
import subprocess
import sys
import types

import pytest
import torch

from bench.tests import small
from bench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def load_run():
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run():
    return load_run()


@pytest.mark.parametrize("make,trace", [(small.cnn_cell, False),
                                        (small.lm_cell, False),
                                        (small.cnn_cell, True)])
def test_result_line(run, make, trace):
    cell = make()
    out = run.run_cell(cell, 2 ** 31 + 17, 0.2, trace, device="cpu")
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= cell["traffic"]["fl"]["rounds"] // \
        cell["traffic"]["fl"]["rounds_per_dispatch"]
    want = {m["name"] for m in cell["per_layer" if trace else "end_to_end"]}
    got = set(out["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    else:
        # profiled calls, then timed spans and untraced calls in turn
        phases = out["window"]["phases"]
        assert {"prof", "spans", "clean"} <= set(phases)
        assert {"mfu.cnn", "block_ms.cnn", "init_params_ms.cnn"} <= got
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    # the program and the reference agree far inside the limits here
    assert out["checks"]["layout"]["value"] == 0
    assert all(c["value"] < 1e-5 for c in out["checks"].values())
    json.dumps(out)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for machines without")
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                        "--workload", "cnn.paper40_kd", "--seed", "3",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_banned_names_compare_whole(run, monkeypatch):
    assert "repro_torch" not in run.BANNED
    monkeypatch.setitem(sys.modules, "repro_torch_probe",
                        types.ModuleType("repro_torch_probe"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert run.banned_modules() == ["repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import importlib.util, sys, torch; torch.set_num_threads(2); "
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
            "spec = importlib.util.spec_from_file_location('r', "
            f"{str(ROOT / 'bench' / 'run.py')!r}); "
            "r = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(r); "
            "from bench.tests import small; "
            "out = r.run_cell(small.lm_cell(), 5, 0.1, True, device='cpu'); "
            "print(r.banned_modules(), out['correct'])")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def _half_batch(orig):
    def local_update(loss_fn, params, batches, lr, **kw):
        B = next(iter(batches.values())).shape[1]
        batches = {k: v[:, :B // 2] for k, v in batches.items()}
        if kw.get("teacher_logits") is not None:
            kw["teacher_logits"] = kw["teacher_logits"][:, :B // 2]
        return orig(loss_fn, params, batches, lr, **kw)
    return local_update


def _half_batch_kd(orig):
    """Half of the batch left out in the KD clusters' steps alone."""
    half = _half_batch(orig)

    def local_update(loss_fn, params, batches, lr, **kw):
        if kw.get("teacher_logits") is None:
            return orig(loss_fn, params, batches, lr, **kw)
        return half(loss_fn, params, batches, lr, **kw)
    return local_update


def _frozen(orig):
    def local_update(loss_fn, params, batches, lr, **kw):
        _, loss = orig(loss_fn, params, batches, lr, **kw)
        return params, loss
    return local_update


@pytest.mark.parametrize("fault", [_half_batch, _half_batch_kd, _frozen])
@pytest.mark.parametrize("make", [small.cnn_cell, small.lm_cell])
def test_a_broken_step_is_not_correct(run, monkeypatch, fault, make):
    from repro_torch.core import client
    monkeypatch.setattr(client, "local_update", fault(client.local_update))
    out = run.run_cell(make(), 2 ** 31 + 29, 0.1, False, device="cpu")
    assert out["correct"] is False
