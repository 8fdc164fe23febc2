"""Port parity for the LM modules: configs, scaling, LM data, layers,
attention (all three routes), the decoder-only transformer and
``lm_family``, plus carrying LM parameter trees across (``interop``).

Configs and scaling must equal the JAX package's exactly, and the LM data
bit for bit.  The models run on the smoke variants of olmo-1b
(non-parametric LN, tied head), qwen3-8b (qk-norm, GQA, untied head) and
gemma2-9b (local / global alternation, sliding window, both softcaps), with
the JAX draws carried into the port; JAX's ``"pallas"`` route runs its
kernel in interpret mode here.  Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.core import scaling as j_scaling
from repro.core.families import lm_family as j_lm_family
from repro.data import synthetic as j_syn
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import registry as j_registry
from repro.models import transformer as j_tf

from repro_torch import interop
from repro_torch.configs import ARCHS, get_config, list_archs, smoke_variant
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.core import scaling
from repro_torch.core.families import lm_family
from repro_torch.core.plane import make_plane_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.data import synthetic
from repro_torch.models import attention, layers, registry, transformer

jax.config.update("jax_platform_name", "cpu")
TOL = dict(rtol=2e-4, atol=1e-5)
MODELS = ["olmo-1b", "qwen3-8b", "gemma2-9b"]


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(kw or TOL))


def _carried(cfg, seed=0):
    """JAX init of ``cfg`` and the same tree in the port."""
    pj = j_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return pj, interop.params_from_numpy(jax.tree.map(np.asarray, pj))


def _tokens(cfg, B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------------ configs
def _jax_fields(cfg) -> dict:
    """The port's config as JAX's fields; its own fields at their 0."""
    out = dataclasses.asdict(cfg)
    assert all(out.pop(k) == 0.0 for k in PORT_FIELDS)
    return out


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_arch_and_smoke_configs_equal_jax(name):
    assert list_archs() == sorted(J_ARCHS)
    assert _jax_fields(ARCHS[name]) == dataclasses.asdict(J_ARCHS[name])
    assert _jax_fields(get_config(name, smoke=True)) == \
        dataclasses.asdict(j_get_config(name, smoke=True))
    for c, jc in ((ARCHS[name], J_ARCHS[name]),
                  (smoke_variant(ARCHS[name]), j_get_config(name, True))):
        assert (c.padded_vocab, c.q_dim, c.kv_dim, c.n_superblocks) == \
            (jc.padded_vocab, jc.q_dim, jc.kv_dim, jc.n_superblocks)


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_scaling_equals_jax(name):
    for level in range(4):
        c = scaling.compress_config(ARCHS[name], 0.5, level)
        jc = j_scaling.compress_config(J_ARCHS[name], 0.5, level)
        assert _jax_fields(c) == dataclasses.asdict(jc)
        assert scaling.param_count(c) == j_scaling.param_count(jc)
        assert scaling.active_param_count(c) == \
            j_scaling.active_param_count(jc)
        assert scaling.model_bytes(c) == j_scaling.model_bytes(jc)
        assert scaling.flops_per_token_train(c, 4096) == \
            j_scaling.flops_per_token_train(jc, 4096)
        for kind in ("train", "prefill", "decode"):
            assert scaling.analytic_step_flops(c, kind, 8, 1024) == \
                j_scaling.analytic_step_flops(jc, kind, 8, 1024)
    assert [_jax_fields(c) for c in
            scaling.model_family(ARCHS[name], 0.5, 3)] == \
        [dataclasses.asdict(c) for c in
         j_scaling.model_family(J_ARCHS[name], 0.5, 3)]


def test_olmo_main_path_level_sizes():
    """The card run's two-layer OLMo-1B-width levels (chip_smoke.py)."""
    base = get_config("olmo-1b").replace(n_layers=2, attn_impl="pallas")
    sizes = [scaling.param_count(scaling.compress_config(base, 0.5, l))
             for l in (0, 1)]
    assert sizes == [237_502_464, 187_170_816]
    assert sizes == [j_scaling.param_count(j_scaling.compress_config(
        j_get_config("olmo-1b").replace(n_layers=2), 0.5, l))
        for l in (0, 1)]


# ------------------------------------------------------------------ data
def test_lm_data_bit_identical():
    for vocab, n, seed in ((64, 3000, 0), (50304, 400, 3)):
        a = synthetic.make_lm_corpus(vocab, n, seed=seed)
        b = j_syn.make_lm_corpus(vocab, n, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        for batch, seq, steps, s in ((4, 17, 3, 1), (2, 64, 1, 99)):
            x = synthetic.lm_batches(a, batch, seq, steps, seed=s)
            y = j_syn.lm_batches(b, batch, seq, steps, seed=s)
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_jax(norm):
    cfg = get_config("olmo-1b", smoke=True).replace(norm_type=norm)
    jcfg = j_get_config("olmo-1b", smoke=True).replace(norm_type=norm)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 256)) * 3 + 1).astype(np.float32)
    p = {k: rng.standard_normal(256).astype(np.float32)
         for k in j_layers.init_norm(jcfg, 256, jnp.float32)}
    want = j_layers.apply_norm(jcfg, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x))
    got = layers.apply_norm(cfg, interop.params_from_numpy(p),
                            torch.tensor(x))
    _close(got, want)
    assert layers.init_norm(cfg, 256, torch.float32).keys() == p.keys()


def test_rope_mrope_headnorm_mlp_softcap_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(6) + 3]).astype(np.int32)
    pos3 = np.stack([pos, pos * 2, pos + 1])
    _close(layers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4),
           j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    _close(layers.apply_mrope(torch.tensor(x), torch.tensor(pos3), 1e6,
                              (2, 3, 3)),
           j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                                (2, 3, 3)))
    scale = rng.standard_normal(16).astype(np.float32)
    _close(layers.rms_head_norm(torch.tensor(scale), torch.tensor(x)),
           j_layers.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)))
    mlp = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
           (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    _close(layers.apply_mlp(interop.params_from_numpy(mlp), torch.tensor(x)),
           j_layers.apply_mlp(jax.tree.map(jnp.asarray, mlp),
                              jnp.asarray(x)))
    big = x * 40
    _close(layers.softcap(torch.tensor(big), 30.0),
           j_layers.softcap(jnp.asarray(big), 30.0))


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("impl", ["jnp", "blocked", "pallas"])
@pytest.mark.parametrize("name,local", [("olmo-1b", False),
                                        ("qwen3-8b", False),
                                        ("gemma2-9b", True),
                                        ("gemma2-9b", False)])
def test_attn_forward_matches_jax(name, local, impl):
    cfg = get_config(name, smoke=True).replace(attn_impl=impl)
    jcfg = j_get_config(name, smoke=True).replace(attn_impl=impl)
    p = j_attn.init_attn(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want = j_attn.attn_forward(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               local=local)
    got = attention.attn_forward(
        interop.params_from_numpy(jax.tree.map(np.asarray, p)), cfg,
        torch.tensor(x), torch.tensor(pos), local=local)
    _close(got, want)


def test_attn_init_structure_matches_jax():
    for name in MODELS:
        cfg = get_config(name, smoke=True)
        pj = j_attn.init_attn(jax.random.PRNGKey(0),
                              j_get_config(name, smoke=True), jnp.float32)
        pt = attention.init_attn(torch.Generator().manual_seed(0), cfg,
                                 torch.float32)
        assert sorted(pt) == sorted(pj)
        assert all(tuple(pt[k].shape) == pj[k].shape for k in pj)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_and_loss_match_jax(name, impl):
    cfg = get_config(name, smoke=True).replace(attn_impl=impl)
    jcfg = j_get_config(name, smoke=True).replace(attn_impl=impl)
    pj, pt = _carried(jcfg)
    toks = _tokens(cfg)
    lj, _ = j_tf.forward(jcfg, pj, jnp.asarray(toks))
    lt, aux = transformer.forward(cfg, pt, torch.tensor(toks))
    assert tuple(lt.shape) == (2, 32, cfg.padded_vocab) and float(aux) == 0
    _close(lt, lj)
    total_j, ce_j = j_registry.loss_fn(jcfg, pj,
                                       {"tokens": jnp.asarray(toks)})
    total_t, ce_t = registry.loss_fn(cfg, pt, {"tokens": torch.tensor(toks)})
    _close(total_t, total_j)
    _close(ce_t, ce_j)
    assert registry.param_count(pt) == j_registry.param_count(pj)


@pytest.mark.parametrize("name", MODELS + ["minicpm-2b", "qwen2-vl-2b"])
def test_init_tree_matches_jax(name):
    """Same pytree, shapes, dtypes and plane length as the JAX init, and
    the carried tree round-trips through numpy and the plane."""
    jcfg = j_get_config(name, smoke=True)
    cfg = get_config(name, smoke=True)
    pj = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    pt = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_flatten_with_path(pj)[0]
    tl = tree_leaves(pt)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
    carried = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    spec = make_plane_spec(carried)
    plane = spec.to_plane(carried)
    np.testing.assert_array_equal(plane.numpy()[:spec.d],
                                  np.asarray(ravel_pytree(pj)[0]))
    back = interop.params_to_numpy(spec.to_params(plane))
    for a, b in zip(jax.tree.leaves(pj), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_stacked_superblock_leaves_carry_across():
    """Nested LM trees with stacked superblock leaves keep their layout
    through ``interop``: ``blocks/p0/mixer/wq`` is (n_sb, d, q_dim)."""
    jcfg = j_get_config("gemma2-9b", smoke=True).replace(n_layers=4)
    pj = j_tf.init_params(jcfg, jax.random.PRNGKey(1))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    assert tuple(pt["blocks"]["p0"]["mixer"]["wq"].shape) == \
        (2, jcfg.d_model, jcfg.q_dim)
    assert pt["final_norm"].keys() == pj["final_norm"].keys()
    back = interop.params_to_numpy(pt)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(flat_j) == len(tree_leaves(back))
    for (path, a), b in zip(flat_j, tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    cfg = get_config("gemma2-9b", smoke=True).replace(n_layers=4)
    toks = _tokens(cfg, S=16)
    _close(transformer.forward(cfg, pt, torch.tensor(toks))[0],
           j_tf.forward(jcfg, pj, jnp.asarray(toks))[0])


@pytest.mark.parametrize("level", [0, 1])
def test_lm_family_loss_and_logits_match_jax(level):
    jcfg = j_get_config("qwen3-8b", smoke=True).replace(attn_impl="pallas")
    cfg = get_config("qwen3-8b", smoke=True).replace(attn_impl="pallas")
    fj, ft = j_lm_family(jcfg, 0.5), lm_family(cfg, 0.5)
    assert ft.model_bytes(level) == fj.model_bytes(level)
    assert ft.flops_per_sample(level) == fj.flops_per_sample(level)
    pj = fj.init(jax.random.PRNGKey(level), level)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj))
    assert [tuple(x.shape) for x in tree_leaves(
        ft.init(torch.Generator().manual_seed(0), level))] == \
        [x.shape for x in jax.tree.leaves(pj)]
    toks = _tokens(cfg, B=3, S=16, seed=level)
    lj, gj = fj.loss_and_logits(level, pj, {"tokens": jnp.asarray(toks)})
    lt, gt = ft.loss_and_logits(level, pt, {"tokens": torch.tensor(toks)})
    assert tuple(gt.shape) == (3, cfg.padded_vocab)
    _close(lt, lj)
    _close(gt, gj)


def test_remat_raises():
    """remat=True under torch.func (the name is kept from when it raised
    there, ROADMAP C6): ``Recompute`` gives the LM's ``torch.func.grad``
    bit-equal to remat=False's, and a dispatch block of the FL engine with
    remat=True (its vmapped member step, attention on the flash route's
    plain version) equals JAX's remat=True block (``jax.checkpoint`` of the
    scan body, plain attention) on JAX's plane and batch draws."""
    cfg = get_config("olmo-1b", smoke=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor(_tokens(cfg, B=2, S=8, seed=0))
    grads = [torch.func.grad(lambda p: transformer.next_token_loss(
        cfg.replace(remat=remat), p, toks)[0])(params)
        for remat in (False, True)]
    for a, b in zip(*map(tree_leaves, grads)):
        assert torch.equal(a, b)

    from repro.core import server as j_srv
    from repro.core.resources import participants_from_matrix as j_parts
    from _torch_mesh_common import InjectedFedRAC
    from _torch_mesh_jax import RecordingBridgedFedRAC
    from _torch_tp_common import CFG, LM, TokenHooks, lm_federation
    from repro.configs.base import ModelConfig as JModelConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import server as t_srv
    from repro_torch.core.resources import participants_from_matrix

    class JTokens(j_srv.FedRAC):
        def _batch_from_gathered(self, g):
            return {"tokens": g["tokens"], "y": g["tokens"][:, :, -1]}

    V, n_data, cd, _ = lm_federation()
    kw = dict(CFG, class_balanced=False)
    jf = j_lm_family(JModelConfig(**dict(LM, attn_impl="jnp", remat=True)))
    j = JTokens(j_parts(V, n_data=n_data), cd, jf,
                j_srv.FLConfig(**kw, donate_plane=False), classes=64).setup()
    InjectedFedRAC.draws = {}
    t = type("Tokens", (TokenHooks, RecordingBridgedFedRAC), {})(
        participants_from_matrix(V, n_data=n_data), cd,
        lm_family(ModelConfig(**dict(LM, remat=True))), t_srv.FLConfig(**kw),
        classes=64, device="cpu").setup()
    members = j.assignment.members[0]
    plane = np.asarray(j.plane_of(0, jf.init(jax.random.PRNGKey(0), 0)))
    oj = j.dispatch_rounds(0, members, jnp.asarray(plane), 0, 2)
    ot = t.dispatch_rounds(0, members, torch.tensor(plane), 0, 2)
    _close(ot.losses, oj.losses)
    _close(ot.plane, oj.plane)