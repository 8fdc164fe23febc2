"""Carrying weights between the JAX package and the port, through numpy.

Parameters are pytrees of the same structure and layouts in both packages
(HWIO conv weights, ``(in, out)`` dense weights, the LM's nested dicts with
superblock-stacked leaves such as ``blocks/p0/mixer/wq`` of shape
``(n_sb, d, q_dim)``, and empty dicts for parameter-free norms), and planes
hold the same elements in the same order, so the conversion is a copy per
leaf.  The
caller turns JAX arrays into numpy first (``jax.tree.map(np.asarray, p)``);
this module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map


def _leaf_from_numpy(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (JAX's bf16 arrays), read by its 16-bit words
        # so this module need not import ml_dtypes
        return torch.from_numpy(x.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def params_from_numpy(tree, device="cpu"):
    """A pytree of numpy arrays (fp32, bf16 or any numpy dtype torch
    takes) -> the port's params on ``device``."""
    return tree_map(lambda x: _leaf_from_numpy(x, device), tree)


def params_to_numpy(tree):
    """The port's params -> a pytree of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def plane_from_numpy(plane, device="cpu") -> torch.Tensor:
    """A (..., D_pad) numpy plane -> an fp32 plane on ``device``."""
    return torch.tensor(np.asarray(plane, np.float32), device=device)


def plane_to_numpy(plane: torch.Tensor) -> np.ndarray:
    return plane.detach().cpu().numpy()
