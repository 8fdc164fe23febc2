"""Port parity for serving (``repro_torch.launch.serve``) and the plane
dtypes it relies on (``repro_torch.core.plane``).

* ``generate`` gives JAX's tokens from carried parameters and prompts
  (fp32 smoke models of each family; greedy decoding, ties to the lower
  token id in both).
* ``PlaneWatcher`` on one checkpoint directory, written by the port's
  ``CheckpointManager``, reloads the step JAX's watcher reloads and skips
  what it skips: corrupt, key-missing and wrong-shape steps.  A bf16
  template keeps bf16 leaves after a reload.
* ``PlaneSpec.to_params`` gives leaves the dtypes JAX's unravel gives them:
  views in the plane's dtype for a single-dtype template, each leaf's own
  dtype for a template of mixed dtypes.
* ``main`` runs on the CPU with ``--device cpu`` (and raises without a card
  otherwise), and so does ``examples/torch_serve_demo.py``.
"""
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_examples_common import load_example
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_config as j_get_config
from repro.core.plane import make_plane_spec as j_make_plane_spec
from repro.launch import serve as j_serve
from repro.models import registry as j_registry

from repro_torch import interop
from repro_torch.ckpt.manifest import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.plane import make_plane_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.sim.faults import corrupt_checkpoint

jax.config.update("jax_platform_name", "cpu")
HDR = {"run_state": {"version": 1, "kind": "hetero-sim"}}


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m",
                                  "jamba-v0.1-52b", "xlstm-350m",
                                  "seamless-m4t-medium", "gemma2-9b"])
def test_generate_matches_jax(arch):
    jcfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    pj = j_registry.init_params(jcfg, jax.random.PRNGKey(1))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = j_serve.generate(jcfg, pj, jnp.asarray(prompts), 6)
    got = serve.generate(cfg, pt, torch.tensor(prompts), 6)
    assert got.shape == want.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def _template(dtype=torch.float32):
    return {"w": torch.zeros((7, 5), dtype=dtype),
            "b": torch.zeros(5, dtype=dtype)}


def test_watcher_reloads_and_skips_as_jax(tmp_path, caplog):
    tmpl = _template()
    spec = make_plane_spec(tmpl)
    mgr = CheckpointManager(str(tmp_path), keep=10)
    mgr.save(1, HDR, {"plane/0": np.full(spec.d_pad, 1.0, np.float32)})
    mgr.save(2, HDR, {"plane/0": np.full(spec.d_pad, 2.0, np.float32)})
    corrupt_checkpoint(str(tmp_path), "garbage")           # step 2 corrupt
    mgr.save(3, HDR, {"other": np.zeros(4, np.float32)})    # key missing
    mgr.save(4, HDR, {"plane/0": np.zeros(spec.d_pad * 2,    # another model
                                          np.float32)})
    jtmpl = {k: np.zeros(tuple(v.shape), np.float32) for k, v in tmpl.items()}
    jw = j_serve.PlaneWatcher(str(tmp_path), jtmpl, level=0)
    w = serve.PlaneWatcher(str(tmp_path), tmpl, level=0)
    pj, fresh_j = jw.poll(jtmpl)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        p, fresh = w.poll(tmpl)
    assert fresh and fresh_j and w.step == jw.step == 1
    for k in tmpl:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(pj[k]))
    skipped = [r.getMessage() for r in caplog.records
               if r.name == "repro_torch.serve"]
    assert len(skipped) == 3
    assert "step 4" in skipped[0] and "different model" in skipped[0]
    assert "step 3 has no 'plane/0'" in skipped[1]
    assert "skipping step 2" in skipped[2]
    p2, fresh = w.poll(p)                  # only the bad steps are newer
    assert not fresh and p2 is p
    mgr.save(5, HDR, {"plane/0": np.full(spec.d_pad, 5.0, np.float32)})
    p5, fresh = w.poll(p)
    assert fresh and w.step == 5 and float(p5["w"][0, 0]) == 5.0


def test_watcher_keeps_bf16_serving_params(tmp_path):
    """A bf16 model reloads an fp32 plane into bf16 leaves on the
    template's device, values rounded once."""
    tmpl = _template(torch.bfloat16)
    spec = make_plane_spec(tmpl)
    plane = np.random.default_rng(3).standard_normal(
        spec.d_pad).astype(np.float32)
    CheckpointManager(str(tmp_path)).save(7, HDR, {"plane/0": plane})
    p, fresh = serve.PlaneWatcher(str(tmp_path), tmpl).poll(tmpl)
    assert fresh
    for leaf, x in zip(tree_leaves(p), tree_leaves(spec.to_params(
            torch.tensor(plane)))):
        assert leaf.dtype == torch.bfloat16 and x.dtype == torch.float32
        assert torch.equal(leaf, x.to(torch.bfloat16))


def test_plane_to_params_dtypes_follow_jax():
    """Single-dtype templates unravel to views in the plane's dtype (fp32
    views for an fp32 template); mixed templates give each leaf its own
    dtype back, as JAX's ``ravel_pytree`` unravel does."""
    cases = [
        {"a": torch.ones(3), "b": torch.ones(2, 2)},
        {"a": torch.ones(3, dtype=torch.bfloat16),
         "b": torch.ones(2, 2, dtype=torch.bfloat16)},
        {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2, 2)},
    ]
    for tmpl in cases:
        spec = make_plane_spec(tmpl)
        plane = spec.to_plane(tmpl)
        assert plane.dtype == torch.float32
        got = spec.to_params(plane)
        jt = {k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
            for k, v in tmpl.items()}
        js = j_make_plane_spec(jt)
        want = js.to_params(js.to_plane(jt))
        for k in tmpl:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            if got[k].dtype == torch.float32:
                assert got[k].data_ptr() >= plane.data_ptr()   # a view
        kept = spec.to_params(plane, keep_dtypes=True)
        assert all(kept[k].dtype == tmpl[k].dtype for k in tmpl)


def test_main_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    toks = serve.main(["--arch", "granite-moe-1b-a400m", "--smoke",
                       "--batch", "2", "--prompt-len", "4", "--gen", "3",
                       "--metrics-json", str(out), "--device", "cpu"])
    assert toks.shape == (2, 3)
    snap = json.loads(out.read_text())
    assert snap["counters"]["serve/generated_tokens"] == 6
    assert snap["counters"]["serve/prefill_tokens"] == 8
    assert snap["counters"]["serve/decode_steps"] == 3
    assert snap["histograms"]["serve/decode_step_s"]["count"] == 1
    assert "tok/s" in capsys.readouterr().out


def test_main_watches_a_checkpoint_dir_on_cpu(tmp_path, capsys):
    cfg = get_config("olmo-1b", smoke=True)
    params = registry.init_params(cfg, torch.Generator().manual_seed(9))
    spec = make_plane_spec(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, HDR, {"plane/0": spec.to_plane(params).numpy()})
    serve.main(["--smoke", "--batch", "1", "--prompt-len", "2", "--gen", "2",
                "--watch-ckpt", str(tmp_path), "--watch-batches", "2",
                "--metrics-text", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "# serving plane from checkpoint step 3" in out
    assert "serve_plane_reloads 1" in out


def test_main_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example("torch_serve_demo").main([])


def test_serve_demo_runs_on_cpu(capsys):
    ex = load_example("torch_serve_demo")
    labels, m, k = ex.tiers()
    from repro.core import clustering as j_clu
    from repro.core.resources import LAMBDA_PAPER, TABLE_III
    res = j_clu.optimal_clusters(TABLE_III, LAMBDA_PAPER, seed=3, restarts=1)
    assert k == res.k
    want = np.clip(j_clu.order_clusters_by_resources(
        res.normalized, res.labels, LAMBDA_PAPER), 0, m - 1)
    np.testing.assert_array_equal(labels, want)
    out = ex.main(["--device", "cpu"])
    assert len(out) == m and all(t.shape[1] == 16 for t in out)
    assert capsys.readouterr().out.count("tok/s") == m
