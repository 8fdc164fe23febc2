"""Stand-ins for every model input, a torch copy of ``repro.launch.specs``:
tensors on the ``meta`` device, which carry a shape and a dtype and
allocate nothing.  The compile analysis (``launch.dryrun``) sizes its
programs from them.

Per family:
  * decoder-only train/prefill:  tokens (B, S) int32
  * vlm:    embeds (B, front, d) + tokens (B, S-front)   [frontend stub]
  * encdec: embeds (B, S, d) + tokens (B, max(S//8,128)) [frontend stub]
  * decode: token (B,1) + pos scalar + cache (``registry.init_cache``
    under a fake-tensor mode, JAX's ``eval_shape``)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import registry
from repro_torch.models.layers import torch_dtype


def meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (JAX's ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _as_meta(tree):
    return tree_map(lambda x: meta(x.shape, x.dtype), tree)


def _eval_shape(fn):
    """The output of ``fn()`` as meta tensors: ``fn`` runs on fake tensors
    (``FakeTensorMode``), so nothing is drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn()
    return _as_meta(out)


def train_inputs(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        front = min(cfg.frontend_tokens, S // 4)
        return {"embeds": meta((B, front, cfg.d_model), dt),
                "tokens": meta((B, S - front), torch.int32)}
    if cfg.family == "encdec":
        return {"embeds": meta((B, S, cfg.d_model), dt),
                "tokens": meta((B, max(S // 8, 128)), torch.int32)}
    return {"tokens": meta((B, S), torch.int32)}


def decode_inputs(cfg: ModelConfig, shape: InputShape):
    """Returns (token, pos, cache) — ONE new token against a seq_len
    cache."""
    B, S = shape.global_batch, shape.seq_len
    token = meta((B, 1), torch.int32)
    pos = meta((), torch.int32)
    cache = _eval_shape(lambda: registry.init_cache(cfg, B, S))
    return token, pos, cache


def params_shape(cfg: ModelConfig):
    return _eval_shape(
        lambda: registry.init_params(cfg, torch.Generator().manual_seed(0)))


def input_specs(cfg: ModelConfig, shape_name: str):
    shape = INPUT_SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return train_inputs(cfg, shape)
    return decode_inputs(cfg, shape)


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs."""
    if shape_name != "long_500k":
        return True, ""
    sub_quadratic = (cfg.family in ("hybrid", "ssm")
                     or (cfg.sliding_window > 0))
    if not sub_quadratic:
        return False, ("pure full-attention arch: 500k-token decode requires "
                       "sub-quadratic attention (skip per assignment brief)")
    return True, ""
