"""Port parity for LM pretraining (``repro_torch.launch.train``): the
training step against ``repro.launch.train.build_step``, remat, the
launcher's output and checkpoint, and the synthetic corpus it reads.

Both packages start from the JAX package's parameter draw (carried by
``interop.params_from_numpy``) and take the same token windows; the smoke
configurations run in fp32.  Tolerance rtol 2e-4 / atol 1e-5 on the
per-step cross-entropy and the final parameters.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_ckpt
from repro.configs import get_config as j_get_config
from repro.data import synthetic as j_syn
from repro.launch import train as j_train
from repro.models import registry as j_registry
from repro.optim import optimizers as j_opt
from repro.optim import schedules as j_sched

from repro_torch import interop
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves
from repro_torch.data import synthetic
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.optim import optimizers, schedules

from _torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")
RTOL, ATOL = 2e-4, 1e-5
STEPS, B, S, LR = 5, 4, 32, 1e-3


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


def _carried(arch, seed=0, **replace):
    """(JAX cfg, port cfg, JAX params, port params): JAX's draw, carried."""
    jcfg = j_get_config(arch, smoke=True).replace(**replace)
    cfg = get_config(arch, smoke=True).replace(**replace)
    pj = j_registry.init_params(jcfg, jax.random.PRNGKey(seed))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    for x in tree_leaves(pt):
        x.requires_grad_(True)
    return jcfg, cfg, pj, pt


def _windows(vocab, seed=0):
    corpus = synthetic.make_lm_corpus(vocab, 5_000, seed=seed)
    return [synthetic.lm_batches(corpus, B, S, 1, seed=seed + s)[0]
            for s in range(STEPS)]


def _train_both(arch, **replace):
    """STEPS AdamW + WSD steps of both packages' ``build_step``; returns
    (JAX ces, port ces, JAX params, port params)."""
    jcfg, cfg, pj, pt = _carried(arch, **replace)
    oj, ot = j_opt.adamw(), optimizers.adamw()
    sj, st = oj.init(pj), ot.init(pt)
    step_j = jax.jit(j_train.build_step(jcfg, oj, j_sched.wsd(LR, STEPS)))
    step_t = train.build_step(cfg, ot, schedules.wsd(LR, STEPS))
    ces_j, ces_t = [], []
    for step, toks in enumerate(_windows(cfg.vocab_size)):
        pj, sj, ce_j = step_j(pj, sj, {"tokens": jnp.asarray(toks)},
                              jnp.asarray(step))
        pt, st, ce_t = step_t(pt, st, train.lm_batch(cfg, toks, "cpu"), step)
        ces_j.append(float(ce_j))
        ces_t.append(float(ce_t))
    return ces_j, ces_t, pj, pt


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_build_step_matches_jax(arch):
    ces_j, ces_t, pj, pt = _train_both(arch)
    _close(ces_t, ces_j)
    assert ces_t[-1] < ces_t[0]
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        assert tuple(a.shape) == b.shape
        _close(a.detach(), b)


def test_remat_matches_no_remat_and_jax():
    """remat=True recomputes each superblock in the backward pass: the
    gradients and so the trained parameters equal remat=False's in the
    port, and JAX's remat=True run (``jax.checkpoint`` of its scan body)."""
    ces_j, ces_t, pj, pt = _train_both("olmo-1b", remat=True)
    *_, pt_plain = _train_both("olmo-1b")
    _close(ces_t, ces_j)
    for a, b, c in zip(tree_leaves(pt), jax.tree.leaves(pj),
                       tree_leaves(pt_plain)):
        _close(a.detach(), b)
        torch.testing.assert_close(a.detach(), c.detach(), rtol=0, atol=0)


def test_remat_grads_equal_no_remat():
    cfg = get_config("olmo-1b", smoke=True)
    _, _, _, pt = _carried("olmo-1b")
    batch = train.lm_batch(cfg, _windows(cfg.vocab_size)[0], "cpu")
    leaves = tree_leaves(pt)
    out = []
    for remat in (False, True):
        loss, _ = registry.loss_fn(cfg.replace(remat=remat), pt, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _shape_of_lines(text):
    """Each output line with its numbers replaced by ``#`` and the
    checkpoint path by ``PATH``: the launcher's line formats."""
    lines = []
    for line in text.strip().splitlines():
        line = re.sub(r"^saved .*$", "saved PATH", line)
        lines.append(re.sub(r"[\d][\d,.]*", "#", line))
    return lines


def test_main_prints_jax_lines_and_writes_a_jax_checkpoint(tmp_path, capsys):
    argv = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "16",
            "--log-every", "3"]
    losses = train.main(argv + ["--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "t")])
    out_t = capsys.readouterr().out
    j_train.main(argv + ["--ckpt-dir", str(tmp_path / "j")])
    out_j = capsys.readouterr().out
    assert _shape_of_lines(out_t) == _shape_of_lines(out_j)
    assert out_t.splitlines()[0] == out_j.splitlines()[0]   # arch, count
    assert len(losses) == 6 and all(np.isfinite(losses))
    path = tmp_path / "t" / "step_00000006.ckpt"
    assert f"saved {path}" in out_t
    restored_j = j_ckpt.restore(str(path))
    restored_t = checkpoint.restore(str(path))
    layout = j_ckpt.restore(str(tmp_path / "j" / "step_00000006.ckpt"))
    assert restored_j.keys() == restored_t.keys() == layout.keys()
    for k, v in restored_j.items():
        assert v.shape == layout[k].shape and v.dtype == layout[k].dtype
        np.testing.assert_array_equal(v, np.asarray(restored_t[k]))


@pytest.mark.parametrize("vocab,length,seed", [
    (512, 4_000, 0), (2048, 20_000, 3), (50304, 3_000, 1)])
def test_lm_corpus_equals_jax(vocab, length, seed):
    """The corpus the launcher trains on: token for token JAX's, though
    drawn without a search of the vocabulary row per token."""
    np.testing.assert_array_equal(
        synthetic.make_lm_corpus(vocab, length, seed=seed),
        j_syn.make_lm_corpus(vocab, length, seed=seed))
