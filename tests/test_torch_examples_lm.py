"""The port's LM example (``examples/torch_fedrac_lm_train.py``): its
configurations equal the JAX example's, and it trains on the CPU, writes a
checkpoint the JAX package restores, and holds its assert that the loss
fell.  The step count is cut from the default 300 to fit the test budget;
the example's own assert compares the mean of the first and last 20
steps."""
import dataclasses

import numpy as np
import pytest

from repro.ckpt import checkpoint as j_ckpt
from repro.configs import get_config as j_get_config
from repro.core.scaling import compress_config as j_compress
from repro.core.scaling import param_count as j_param_count

from _torch_examples_common import load_example
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs.base import PORT_FIELDS
from repro_torch.core.scaling import param_count


def _jax_config(full_100m, level):
    """The configuration ``examples/fedrac_lm_train.py`` builds."""
    cfg = j_get_config("olmo-1b", smoke=True)
    if full_100m:
        cfg = cfg.replace(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                          head_dim=64, d_ff=2048, vocab_size=50304)
    else:
        cfg = cfg.replace(n_layers=4, d_model=256, vocab_size=2048)
    return j_compress(cfg, 0.5, level)


@pytest.mark.parametrize("full_100m", [False, True])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_example_config_equals_jax(full_100m, level):
    ex = load_example("torch_fedrac_lm_train")
    t, j = ex.make_config(full_100m, level), _jax_config(full_100m, level)
    port = dataclasses.asdict(t)
    assert [port.pop(k) for k in PORT_FIELDS] == [0.0] * len(PORT_FIELDS)
    assert port == dataclasses.asdict(j)
    assert param_count(t) == j_param_count(j)


@pytest.mark.parametrize("level", [0, 1])
def test_example_trains_on_cpu(tmp_path, capsys, level):
    ex = load_example("torch_fedrac_lm_train")
    losses = ex.main(["--device", "cpu", "--steps", "50", "--batch", "4",
                      "--cluster-level", str(level),
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("config: olmo-1b-smoke")
    assert "step   50 ce=" in out and "ckpt=" in out
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    restored = j_ckpt.restore(str(tmp_path / "step_00000050.ckpt"))
    assert restored and all(np.isfinite(v).all() for v in restored.values())
