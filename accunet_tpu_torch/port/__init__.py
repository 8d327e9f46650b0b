from accunet_tpu_torch.port.jax_params import state_dict_from_jax
from accunet_tpu_torch.port.torch_ckpt import (
    load_reference_checkpoint,
    read_checkpoint,
    reference_state_dict,
)

__all__ = ["load_reference_checkpoint", "read_checkpoint", "reference_state_dict",
           "state_dict_from_jax"]
