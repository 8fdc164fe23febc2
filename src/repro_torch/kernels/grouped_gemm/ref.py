"""Plain PyTorch versions of the grouped GEMM kernels: a loop over the
groups, each an fp32 ``@`` of its rows.  The host reads the offsets, which
the kernels never do."""
from __future__ import annotations

import torch


def _bounds(offsets):
    off = offsets.tolist()
    return list(zip(off[:-1], off[1:]))


def grouped_rows(x, w, offsets, trans: bool = False):
    """x (M, K), w (Gw, K, N) or, with ``trans``, (Gw, N, K), offsets
    (G + 1,) -> (M, N): rows [offsets[g], offsets[g + 1]) of x times
    ``w[g % Gw]`` (its transpose with ``trans``)."""
    Gw = w.shape[0]
    N = w.shape[1] if trans else w.shape[2]
    y = x.new_empty((x.shape[0], N))
    for g, (a, b) in enumerate(_bounds(offsets)):
        wg = w[g % Gw]
        y[a:b] = x[a:b] @ (wg.T if trans else wg)
    return y


def grouped_wgrad(x, d, offsets):
    """x (M, K), d (M, N), offsets (G + 1,) -> (G, K, N): each group's
    rows of x, transposed, times its rows of d; zeros for a group with no
    rows."""
    bounds = _bounds(offsets)
    out = x.new_zeros((len(bounds), x.shape[1], d.shape[1]))
    for g, (a, b) in enumerate(bounds):
        if b > a:
            out[g] = x[a:b].T @ d[a:b]
    return out
