"""Card-only checks of the port: each CUDA kernel against its plain version,
and the engine on the card against the engine on the CPU.

Run on a machine with an NVIDIA card:
  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Without one, the ``cuda`` fixture skips every test.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import server as t_srv
from repro_torch.core.families import cnn_family
from repro_torch.core.resources import TABLE_III, participants_from_matrix
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_classification, train_test_split
from repro_torch.kernels.distill import ops as distill_ops
from repro_torch.kernels.distill import ref as distill_ref
from repro_torch.kernels.fedagg import ops as fedagg_ops
from repro_torch.kernels.fedagg import ref as fedagg_ref
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("C,D", [(1, 128), (3, 2176), (16, 409_216),
                                 (64, 2176)])
def test_fedagg_kernel_matches_plain(cuda, C, D):
    g = torch.Generator(device=cuda).manual_seed(C + D)
    x = torch.randn(C, D, device=cuda, generator=g)
    w = torch.rand(C, device=cuda, generator=g)
    w = w / w.sum()                      # FedAvg weights: normalized
    before = fedagg_ops.weighted_aggregate.launches
    got = fedagg_ops.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    assert fedagg_ops.weighted_aggregate.launches == before + 1
    torch.testing.assert_close(got, fedagg_ref.weighted_aggregate(x, w),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,V,dtype,label_dtype", [
    (256, 10, torch.float32, torch.int32), (8, 7000, torch.float32,
                                            torch.int64),
    (33, 1025, torch.float32, torch.int32), (16, 512, torch.bfloat16,
                                             torch.int64)])
def test_distill_kernel_matches_plain(cuda, N, V, dtype, label_dtype):
    g = torch.Generator(device=cuda).manual_seed(N + V)
    s = (torch.randn(N, V, device=cuda, generator=g) * 3).to(dtype)
    t = (torch.randn(N, V, device=cuda, generator=g) * 3).to(dtype)
    y = torch.randint(0, V, (N,), device=cuda, generator=g).to(label_dtype)
    got = distill_ops.kd_loss_rows(s, t, y, T=2.0, alpha=0.3)
    want = distill_ref.kd_loss_rows(s, t, y, T=2.0, alpha=0.3)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_distill_split_vocabulary_matches_plain_and_repeats_bits(cuda, dtype):
    """Three rows of qwen's 151,936 logits, split over 176 blocks each:
    against the plain version, and two calls give the same bits (the
    chunks merge in a fixed order)."""
    N, V = 3, 151_936
    assert distill_ops.split_plan(N, V)[0] > 1
    g = torch.Generator(device=cuda).manual_seed(V)
    s = (torch.randn(N, V, device=cuda, generator=g) * 3).to(dtype)
    t = (torch.randn(N, V, device=cuda, generator=g) * 3).to(dtype)
    y = torch.randint(0, V, (N,), device=cuda, generator=g)
    before = distill_ops.kd_loss_rows.launches
    got = distill_ops.kd_loss_rows(s, t, y, T=2.0, alpha=0.3)
    again = distill_ops.kd_loss_rows(s, t, y, T=2.0, alpha=0.3)
    torch.cuda.synchronize()
    assert distill_ops.kd_loss_rows.launches == before + 2
    assert torch.equal(got, again)
    want = distill_ref.kd_loss_rows(s, t, y, T=2.0, alpha=0.3)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,kw", [
    (2, 128, 4, 2, 64, torch.float32, dict(causal=True)),
    (1, 256, 4, 1, 128, torch.float32, dict(causal=True, window=32)),
    (1, 128, 2, 2, 256, torch.float32, dict(causal=True, softcap=30.0)),
    (2, 64, 2, 2, 32, torch.float32, dict(causal=False)),
    (1, 17, 4, 2, 8, torch.float32, dict(causal=True)),
    (1, 200, 4, 2, 16, torch.float32, dict(causal=True, window=70,
                                           softcap=5.0)),
    (1, 128, 2, 2, 64, torch.bfloat16, dict(causal=True)),
    # the tensor-core kernels: bf16 (wgmma) with window and softcap, fp32
    # (split TF32) at ragged S 300, and GQA on both
    (1, 256, 2, 2, 128, torch.bfloat16, dict(causal=True, window=100,
                                             softcap=30.0)),
    (1, 256, 2, 1, 256, torch.bfloat16, dict(causal=True, window=90,
                                             softcap=50.0)),
    (1, 300, 2, 2, 64, torch.float32, dict(causal=True)),
    (1, 300, 2, 2, 128, torch.float32, dict(causal=True)),
    (1, 300, 2, 2, 256, torch.float32, dict(causal=True)),
    (2, 192, 8, 2, 128, torch.float32, dict(causal=True)),
    (2, 192, 8, 2, 128, torch.bfloat16, dict(causal=False))])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, hd, dtype, kw):
    """Causal and not, window, softcap, GQA, ragged S, every head size
    class and both tensor-core kernels; tolerances of
    tests/test_kernels_flash.py."""
    g = torch.Generator(device=cuda).manual_seed(B * S + hd)
    q = torch.randn(B * H, S, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(B * KV, S, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(B * KV, S, hd, device=cuda, generator=g).to(dtype)
    before = flash_ops.flash_attention_bh.launches
    got = flash_ops.flash_attention_bh(q, k, v, heads=H, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bh.launches == before + 1
    want = flash_ref.attention_bh_gqa(q, k, v, heads=H, **kw)
    tol = (dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=2e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_flash_vmap_grad_on_card_matches_cpu(cuda):
    """The member-axis vmap of grad through FlashAttention: one launch on
    the card, and the same values and gradients as on the CPU."""
    from torch.func import grad_and_value, vmap
    C, B, S, H, KV, hd = 3, 2, 40, 4, 2, 16
    g = torch.Generator().manual_seed(1)
    q = torch.randn(C, B, S, H, hd, generator=g)
    k = torch.randn(C, B, S, KV, hd, generator=g)
    v = torch.randn(C, B, S, KV, hd, generator=g)

    def loss(q, k, v):
        return (flash_ops.flash_attention(q, k, v, window=12,
                                          softcap=8.0) ** 2).sum()

    step = vmap(grad_and_value(loss, argnums=(0, 1, 2)))
    before = flash_ops.flash_attention_bh.launches
    g_card, v_card = step(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bh.launches == before + 1
    g_cpu, v_cpu = step(q, k, v)
    torch.testing.assert_close(v_card.cpu(), v_cpu, rtol=1e-4, atol=1e-4)
    for a, b in zip(g_card, g_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_engine_on_card_matches_cpu(cuda, monkeypatch):
    # one convolution algorithm in every run (see chip_smoke.py, parity)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = make_classification("synth-mnist", 400, seed=3)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, 8, alpha=1.0, seed=3)
    V = TABLE_III[np.random.default_rng(3).integers(0, 40, 8)]
    n_data = [len(p) for p in idx]
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    cfg = dict(rounds=2, rounds_per_dispatch=2, compact_to=2, seed=3)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = t_srv.FedRAC(participants_from_matrix(V, n_data=n_data), cd,
                           cnn_family(base_width=0.125),
                           t_srv.FLConfig(**cfg), classes=10,
                           device=dev).setup()
        eng.train({"x": test.x, "y": test.y})
        out[dev] = {l: eng.plane_of(l, p).cpu()
                    for l, p in eng.cluster_params.items()}
    for level in out["cpu"]:
        torch.testing.assert_close(out["cuda"][level], out["cpu"][level],
                                   rtol=2e-4, atol=1e-5)


def test_buffered_block_merges_bank_and_flushes_on_the_kernel(cuda,
                                                              monkeypatch):
    """One fused "buffer" block (R = 2, rows entering the bank, member 0
    re-banked each round) and an anchored flush of two bank rows: on the
    card fedagg runs twice a round (members, then bank) and once for the
    flush, and the results match the CPU's plain version."""
    from repro_torch.sim import HeterogeneitySim, SimConfig, make_trace
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ds = make_classification("synth-mnist", 400, seed=3)
    train, _ = train_test_split(ds)
    idx = dirichlet_partition(train.y, 8, alpha=1.0, seed=3)
    V = TABLE_III[np.random.default_rng(3).integers(0, 40, 8)]
    n_data = [len(p) for p in idx]
    cd = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = t_srv.FedRAC(participants_from_matrix(V, n_data=n_data), cd,
                           cnn_family(base_width=0.125),
                           t_srv.FLConfig(rounds_per_dispatch=2, seed=3,
                                          aggregation="buffered",
                                          compact_to=1),
                           classes=10, device=dev).setup()
        members = eng.assignment.members[0]
        cap = eng._capacity(len(members))
        plane = eng.plane_of(0, eng.init_params(0))
        noise = torch.randn(cap, plane.shape[0],
                            generator=torch.Generator().manual_seed(5))
        rows = plane.cpu()[None] * (1.0 + 0.02 * noise)
        rows[2:] = 0.0
        bank_w = torch.zeros(cap)
        bank_w[:2] = torch.tensor([0.9, 0.36])
        gain = torch.zeros(cap)
        gain[0] = 0.6 * eng.assignment.n_eff[members[0]]
        weights = [0.0] + [eng.assignment.n_eff[p] for p in members[1:]]
        before = fedagg_ops.weighted_aggregate.launches
        blk = eng.dispatch_rounds(0, members, plane, 0, 2, weights=weights,
                                  bank=(rows.to(dev), bank_w.to(dev), gain))
        sim = HeterogeneitySim(eng, make_trace("stable", 8, 2),
                               SimConfig(rounds=2, mar_policy="buffer"))
        entries = [{"pid": members[i], "round": 1 - i, "n_eff": 3 + i,
                    "plane": blk.bank[0][i].clone()} for i in range(2)]
        flushed = sim._anchored_merge_plane(blk.plane, entries, 2, 0)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (blk.plane.cpu(), blk.bank[0].cpu(), flushed.cpu(),
                    fedagg_ops.weighted_aggregate.launches - before)
    assert out["cpu"][3] == 0 and out["cuda"][3] == 2 * 2 + 1
    for got, want in zip(out["cuda"][:3], out["cpu"][:3]):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "xlstm-350m", "seamless-m4t-medium"])
def test_new_mixers_on_card_match_cpu(cuda, arch):
    """The MoE, Mamba, xLSTM and enc-dec smoke models on the card: forward
    and eight decode steps equal the CPU's from the same weights (fp32,
    TF32 off; capacity dispatch for the MoE)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import registry

    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = cfg.replace(moe_impl="capacity", moe_group=8,
                          moe_capacity=0.5)
    cpu = registry.init_params(cfg, torch.Generator().manual_seed(0))
    dev = tree_map(lambda x: x.to(cuda), cpu)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
    batch = {"tokens": toks}
    if cfg.frontend:
        batch["embeds"] = torch.tensor(
            rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    want, _ = registry.forward(cfg, cpu, batch)
    got, _ = registry.forward(cfg, dev, on_card)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=1e-5)
    c_cpu = registry.init_cache(cfg, 2, 8)
    c_dev = registry.init_cache(cfg, 2, 8, device=cuda)
    for t in range(8):
        a, c_cpu = registry.decode_step(cfg, cpu, c_cpu, toks[:, t:t + 1], t)
        b, c_dev = registry.decode_step(cfg, dev, c_dev,
                                        on_card["tokens"][:, t:t + 1], t)
        torch.testing.assert_close(b.cpu(), a, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "xlstm-350m", "seamless-m4t-medium"])
def test_cuda_generator_draws_on_the_card(cuda, arch):
    """A CUDA generator draws every leaf on the card, with the shapes and
    dtypes a CPU generator gives."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import registry

    cfg = get_config(arch, smoke=True).replace(dtype="bfloat16")
    on_card = registry.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    on_host = registry.init_params(cfg, torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(on_card), tree_leaves(on_host)):
        assert a.device.type == "cuda" and b.device.type == "cpu"
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        assert bool(torch.isfinite(a.float()).all())


@pytest.mark.parametrize("G,Gw,K,N", [(12, 4, 72, 40), (64, 64, 1024, 512),
                                      (32, 32, 512, 1024)])
def test_grouped_gemm_kernels_match_plain(cuda, G, Gw, K, N):
    """The rows kernel (plain and transposed weights) and the weight
    gradient kernel against the per-group plain versions, with empty
    groups and one group of most rows; fp32 FMAs against fp32 GEMMs:
    rtol 1e-5 of the largest entry."""
    from repro_torch import obs
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.grouped_gemm import ref as gg_ref
    g = torch.Generator().manual_seed(G + K)
    counts = torch.randint(0, 40, (G,), generator=g)
    counts[::5] = 0
    counts[1] = 700
    off = torch.cat([torch.zeros(1, dtype=torch.int64),
                     counts.cumsum(0)]).to(cuda)
    M = int(counts.sum())
    x = torch.randn(M, K, generator=g).to(cuda)
    w = (torch.randn(Gw, K, N, generator=g) * K ** -0.5).to(cuda)
    d = torch.randn(M, N, generator=g).to(cuda)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))

    with obs.observing(obs.make_observability(trace=False)) as o:
        close(gg_ops.grouped_rows(x, w, off), gg_ref.grouped_rows(x, w, off))
        close(gg_ops.grouped_rows(x, w.transpose(1, 2).contiguous(), off,
                                  True),
              gg_ref.grouped_rows(x, w, off))
        close(gg_ops.grouped_wgrad(x, d, off),
              gg_ref.grouped_wgrad(x, d, off))
    assert o.registry.counter("moe/grouped_gemm_launches").value == 3


def test_dropless_moe_on_card_matches_cpu(cuda):
    """Granite's 32 experts top-8 at a small width, under the members'
    vmap(grad): the card's grouped kernels give the CPU's values and
    gradients."""
    from torch.func import grad_and_value, vmap
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(
        n_experts=32, experts_per_tok=8, d_model=128, d_ff=64,
        moe_impl="dropless")
    gen = torch.Generator().manual_seed(2)
    ps = [moe.init_moe(gen, cfg, torch.float32) for _ in range(3)]
    P = {k: torch.stack([p[k] for p in ps]) for k in ps[0]}
    x = torch.randn(3, 2, 64, 128, generator=gen)

    def loss(p, x):
        y, aux = moe.apply_moe(p, cfg, x)
        return (y ** 2).mean() + aux

    step = vmap(grad_and_value(loss, argnums=(0, 1)))
    (gp, gx), v = step(P, x)
    (gp_c, gx_c), v_c = step({k: t.to(cuda) for k, t in P.items()},
                             x.to(cuda))
    torch.testing.assert_close(v_c.cpu(), v, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx_c.cpu(), gx, rtol=1e-4, atol=1e-6)
    for k in gp:
        torch.testing.assert_close(gp_c[k].cpu(), gp[k], rtol=1e-4,
                                   atol=1e-6)
