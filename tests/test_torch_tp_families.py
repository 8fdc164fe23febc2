"""Port parity for the tensor-parallel member forward of the MoE, hybrid
Mamba, xLSTM and enc-dec families (``tp_forward=True`` on a 2D mesh): a
spawn of 4 gloo ranks holds the meshes 1x2 (two replicas side by side),
2x2 and 1x4 (``_torch_tp_families_common``), on smoke configurations.
The cases are spread over six files, each with its own rank world
(``_torch_tp_families_suite``): this one holds granite-moe's dispatch
runs on 1x2, its unsharded sync run against JAX's and the tests that
need no world, ``_granite`` its runs on 2x2 and 1x4 and its banked block
against JAX's, ``_grads`` its and jamba's member-gradient cases,
``_jamba`` jamba's runs, ``_xlstm`` xlstm-350m's runs, ``_xgrads`` the
xLSTM configurations' and seamless-m4t-medium's member gradients.

* Member gradients, on 1x2 and 1x4 (2x2's model axis is 1x2's): under
  ``vmap(grad)`` over 2 members, each rank's gradients under the TP
  forward equal its chunk of the unsharded ones, for granite-moe (dense
  and capacity dispatch, ``moe_shard`` "tp" and "ep", capacity groups
  run in chunks; level 1's 2 experts fall back to the d_ff split at a
  model axis of 4), jamba (Mamba, attention, a dense and an MoE FFN),
  xlstm-350m (mLSTM on its scan and chunk routes, sLSTM; with 2 heads
  the split does not fall on heads at 4) and seamless-m4t-medium's FL
  build (decoder-only).  Every router makes the unsharded forward's
  top-k choices, or differs only at a near-tie.
* The dispatch path: "sync" (``train()``) and "buffered" (a banked block
  per level) runs of granite-moe (capacity dispatch that drops tokens;
  1x2, 2x2, 1x4), jamba and xlstm-350m (1x2), each mesh run held to
  the port's unsharded engine, and that engine to JAX's single-device
  path on JAX's parameter and batch-index draws (``jax_runs``; JAX's
  mesh path fails under JAX 0.9.0, ROADMAP C2).  Every whole leaf's
  copies in a TP plane stay bit-equal across the chunks (routers, norms,
  ``w_if`` / ``b_if``, ``r``, ``b``); fedagg runs on each rank's (C/n,
  d_loc) block as often as the unsharded engine.

Tolerance rtol 2e-4 / atol 1e-5 in fp32.
"""
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_tp_families_common import (FAMILIES, config, federation,
                                       grad_inputs)
from _torch_tp_families_suite import suite
from repro_torch.core.scaling import compress_config
from repro_torch.core.tree import tree_map
from repro_torch.models import moe, tp

globals().update(suite(families=("granite",), meshes=("1x2",),
                       jax_runs=(("granite", "sync"),)))


def test_tp_operations_without_a_context_return_their_input():
    """With no TP context every operation the mixers call returns its
    input (the product's bits for ``linear_whole``), so the single-device
    forward is unchanged."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(3, 4, 8, generator=g), torch.randn(8, 6, generator=g)
    for partial in (False, True):
        assert tp.whole(x, 8, partial=partial) is x
        assert torch.equal(tp.linear_whole(x, w, 6, partial), x @ w)
    assert tp.own(x) is x
    for op in (tp.copy_to_tp, tp.reduce_from_tp, tp.max_from_tp,
               tp.gather_from_tp, tp.scatter_to_tp):
        assert op(x) is x


def test_expert_parallel_falls_back_to_the_ff_split():
    """granite level 1 holds 2 experts: "ep" splits them at a model axis
    of 2, and at 4 falls back to each expert's d_ff slice; the router
    stays whole."""
    fam, p, _, _ = grad_inputs("granite-ep", 1)
    cfg = compress_config(config("granite-ep"), 0.5, 1)
    assert cfg.n_experts == 2
    w_gate = p["blocks"]["p0"]["ffn"]["w_gate"]          # (1, E, d, f)
    for m, dim, split in ((2, 1, "ep"), (4, 3, "f")):
        spec = fam.param_specs(1, p, m, "model")["blocks"]["p0"]["ffn"]
        assert spec["w_gate"] == {"model": dim} and spec["router"] == {}
        loc = w_gate[0].narrow(dim - 1, 0, w_gate.shape[dim] // m)
        assert moe.expert_split({"w_gate": loc}, cfg) == split


def test_the_federation_drops_tokens():
    """granite's capacity dispatch keeps fewer routing choices than it
    makes on the federation's windows (their embeddings as the input)."""
    name = FAMILIES["granite"]
    V, n_data, cd, _ = federation()
    toks = torch.as_tensor(cd[0]["tokens"][:4])
    for level in (0, 1):
        cfg = compress_config(config(name), 0.5, level)
        fam, p, _, _ = grad_inputs(name, level)
        x = torch.nn.functional.embedding(toks, p["embed"])
        kept, made = moe.kept_choices(
            tree_map(lambda t: t[0], p["blocks"]["p0"]["ffn"]), cfg, x)
        assert kept < made
