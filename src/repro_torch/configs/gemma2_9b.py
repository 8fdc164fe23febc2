"""Selectable config for --arch (see archs.py for the cited source)."""
from repro_torch.configs.archs import GEMMA2_9B as CONFIG, smoke_variant

SMOKE = smoke_variant(CONFIG)
