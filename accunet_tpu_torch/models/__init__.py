"""Model registry of the port: the ACC-UNet family, under the JAX package's
registry names (accunet_tpu/models/__init__.py)."""

from __future__ import annotations

from typing import Callable, Dict

from accunet_tpu_torch.models.acc_unet import (
    ACC_UNet,
    ACC_UNet_Lite,
    ACC_UNet_W,
    ACCUNet,
    init_parameters,
)

registry: Dict[str, Callable] = {
    "ACC_UNet": ACC_UNet,
    "ACC_UNet_Lite": ACC_UNet_Lite,
    "ACC_UNet_W": ACC_UNet_W,
}


def build(name: str, **kwargs):
    if name not in registry:
        raise KeyError(f"unknown model {name!r}; available: {sorted(registry)}")
    return registry[name](**kwargs)


__all__ = ["ACCUNet", "ACC_UNet", "ACC_UNet_Lite", "ACC_UNet_W", "build",
           "init_parameters", "registry"]
