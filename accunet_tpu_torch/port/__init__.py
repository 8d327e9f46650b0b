from accunet_tpu_torch.port.jax_params import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
