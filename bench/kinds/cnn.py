"""The paper's CNN family of the program (``core.families.cnn_family``)."""
from __future__ import annotations

from bench import counts

UNIT = "samples"
EVAL_IS_ACCURACY = True     # the check compares evaluations in test samples


def family(cfg: dict):
    from repro_torch.core.families import cnn_family
    from repro_torch.models.cnn import BASE_FILTERS
    if tuple(cfg["base_filters"]) != BASE_FILTERS:
        raise ValueError(f"the program's CNN has filters {BASE_FILTERS}, "
                         f"the configuration {cfg['base_filters']}")
    return cnn_family(classes=cfg["classes"], in_channels=cfg["in_channels"],
                      alpha=cfg["alpha"], base_width=cfg["base_width"],
                      input_hw=cfg["image_hw"])


def classes(cfg: dict) -> int:
    return cfg["classes"]


def engine_base(srv):
    return srv.FedRAC


def units_per_sample(traffic: dict) -> int:
    return 1


def flops_per_call(cfg: dict, traffic: dict, members: dict,
                   n_test: int) -> float:
    """Model FLOPs of a ``train()`` call (``counts.call_flops``): a
    sample's training step, the master's forward as teacher, an
    evaluation's forward."""
    return counts.call_flops(traffic, members, n_test, lambda level, kd: (
        counts.cnn_train(cfg, level), counts.cnn_forward(cfg, 0),
        counts.cnn_forward(cfg, level)))
