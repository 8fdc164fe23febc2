"""Selectable config for --arch (see archs.py for the cited source)."""
from repro_torch.configs.archs import GRANITE_MOE_1B as CONFIG, smoke_variant

SMOKE = smoke_variant(CONFIG)
