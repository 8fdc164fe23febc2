from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      TrainConfig, pad_vocab)
from repro_torch.configs.archs import (ARCHS, get_config, list_archs,
                                       smoke_variant)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "TrainConfig",
           "pad_vocab", "ARCHS", "get_config", "list_archs", "smoke_variant"]
