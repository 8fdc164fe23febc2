"""Port parity for the per-arch config modules ``repro_torch.configs.<arch>``:
each module's ``CONFIG`` and ``SMOKE`` equal the JAX package's in every
field JAX's ``ModelConfig`` has, hold the port's own fields
(``PORT_FIELDS``) at their defaults, and name the same architecture as
``get_config``."""
import dataclasses
import importlib

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import PORT_FIELDS, ModelConfig

MODULES = ["gemma2_9b", "granite_moe_1b_a400m", "jamba_v0_1_52b",
           "minicpm_2b", "olmo_1b", "qwen2_vl_2b", "qwen3_8b",
           "qwen3_moe_235b_a22b", "seamless_m4t_medium", "xlstm_350m"]


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("mod", MODULES)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_arch_module_equals_jax(mod, which):
    j = getattr(importlib.import_module(f"repro.configs.{mod}"), which)
    t = getattr(importlib.import_module(f"repro_torch.configs.{mod}"), which)
    port = _fields(t)
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert {k: port.pop(k) for k in PORT_FIELDS} == \
        {k: defaults[k] for k in PORT_FIELDS}
    assert port == _fields(j)
    assert t == get_config(t.name.removesuffix("-smoke")
                           if which == "SMOKE" else t.name,
                           smoke=which == "SMOKE")


def test_every_arch_has_a_module():
    names = {importlib.import_module(f"repro_torch.configs.{m}").CONFIG.name
             for m in MODULES}
    from repro_torch.configs import list_archs
    assert names == set(list_archs())
