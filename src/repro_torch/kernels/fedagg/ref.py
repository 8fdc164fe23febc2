"""Plain PyTorch version of the fedagg kernel: one ``tensordot``."""
import torch


def weighted_aggregate(plane: torch.Tensor, weights: torch.Tensor):
    """plane (C, D), weights (C,) -> (D,) fp32 = sum_c w[c] * plane[c]."""
    return torch.tensordot(weights.to(torch.float32),
                           plane.to(torch.float32), dims=([0], [0]))
