"""Selectable config for --arch (see archs.py for the cited source)."""
from repro_torch.configs.archs import QWEN2_VL_2B as CONFIG, smoke_variant

SMOKE = smoke_variant(CONFIG)
