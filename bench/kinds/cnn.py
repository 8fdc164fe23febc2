"""The paper's CNN family of the program (``core.families.cnn_family``)."""
from __future__ import annotations

UNIT = "samples"


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
