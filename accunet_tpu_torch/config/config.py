"""Typed configuration system — a pure-Python copy of
accunet_tpu/config/config.py (that package cannot be imported without flax).

Replaces the reference's comment-toggled flat module
(Experiments/Config.py: model_name at :87-160, task_name at :45-79, img_size
via the `models_224` set at :162-176, batch/lr/epochs at :81-84) with
dataclasses + named presets + CLI overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

# models that train at 224 instead of 256 (Config.py:162-176)
MODELS_224 = {
    "SwinUnet",
    "SMESwinUnet",
    "TransUNet",
    "TransUnet_fKAN",
    "TransUNet_Vit_fKAN",
    "SegViT_fKAN",
    "UNext",
    "Segmamba",
} | {
    f"Segmamba_hybrid{suffix}"
    for suffix in (
        "", "_gsc", "_gsc_ds", "_gsc_KAN_PE", "_gsc_KAN_PE_ds",
        "_gsc_KAN_PE_ds_flip", "_gsc_MLP_PE_ds", "_gsc_KAN_PE_ds_SPATIAL",
        "_gsc_KAN_PE_ds_text", "_gsc_KAN_PE_ds_CrossAttn",
        "_gsc_KAN_PE_ds_CrossAttn_TGDC", "_gsc_KAN_PE_ds_CrossAttn_HSLCA",
        "_gsc_KAN_PE_ds_CrossAttn_HSLCA_SpatialMamba",
    )
}

TASK_TEST_NUM = {
    # per-task held-out test sizes (test_model.py:91-175)
    "GlaS": 80,
    "ISIC18": 518,
    "ISIC18_UNET": 1000,
    "Clinic": 122,
    "BUSI": 130,
    "Covid": 20,
    "MoNuSeg": 14,
    "Kvasir": 99,
}


@dataclasses.dataclass
class ModelConfig:
    name: str = "ACC_UNet"
    n_channels: int = 3
    n_classes: int = 1
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DataConfig:
    task_name: str = "ISIC18"
    train_dir: str = ""
    val_dir: str = ""
    test_dir: str = ""
    img_size: int = 256
    batch_size: int = 8  # Config.py:81


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-3           # Config.py:83
    epochs: int = 2000         # Config.py:84 upper bound; early stop governs
    early_stop_patience: int = 100
    optimizer: str = "adam"    # SGD for Swin family (train_model.py:644-646)
    loss: str = "weighted_dice_bce"
    seed: int = 666
    ckpt_dir: str = "checkpoints"
    resume: bool = False
    compute_dtype: str = "float32"  # 'bfloat16' for TPU speed runs
    vis_frequency: int = 10


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def override(self, dotted: dict[str, Any]) -> "Config":
        """Apply {'train.lr': 3e-4, ...} style overrides."""
        cfg = self
        for key, val in dotted.items():
            parts = key.split(".")
            obj = cfg
            for p in parts[:-1]:
                obj = getattr(obj, p)
            if parts[0] == "model" and len(parts) == 2 and not hasattr(obj, parts[-1]):
                # unknown model.* keys become constructor kwargs
                obj.kwargs[parts[-1]] = val
                continue
            cur = getattr(obj, parts[-1])
            if cur is not None and not isinstance(cur, (dict, list)):
                val = type(cur)(val) if not isinstance(val, type(cur)) else val
            setattr(obj, parts[-1], val)
        return cfg


def get_config(model_name: str = "ACC_UNet", task_name: str = "ISIC18") -> Config:
    img_size = 224 if model_name in MODELS_224 else 256
    optimizer = "sgd" if "Swin" in model_name else "adam"
    loss = "binary_dice_bce" if model_name in ("Segmamba", "SegViT_fKAN") else "weighted_dice_bce"
    return Config(
        model=ModelConfig(name=model_name),
        data=DataConfig(task_name=task_name, img_size=img_size),
        train=TrainConfig(optimizer=optimizer, loss=loss),
    )


PRESETS = {
    name: (lambda n=name: get_config(n))
    for name in [
        "ACC_UNet", "ACC_UNet_Lite", "ACC_UNet_W", "UNet_base", "UNext",
        "SwinUnet", "TransUNet", "UCTransNet", "MultiResUnet", "Unetpp",
    ]
}
