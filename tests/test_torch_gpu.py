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
