"""The distill kernel: the fused KD loss, forward only."""
