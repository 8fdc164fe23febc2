"""Synthetic data, federated partitions and batch samplers."""
