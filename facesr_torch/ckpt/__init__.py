"""Checkpoints and weight transfer of the port."""

from facesr_torch.ckpt.weights import (load_reference_pth, state_dict_from_jax_params,
                                       vgg_params_from_jax)

__all__ = ["load_reference_pth", "state_dict_from_jax_params", "vgg_params_from_jax"]
