"""Typed configuration (a copy of accunet_tpu/config)."""

from accunet_tpu_torch.config.config import (
    MODELS_224,
    PRESETS,
    TASK_TEST_NUM,
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    get_config,
)

__all__ = ["Config", "DataConfig", "ModelConfig", "TrainConfig", "get_config",
           "PRESETS", "MODELS_224", "TASK_TEST_NUM"]
