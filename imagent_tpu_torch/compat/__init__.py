"""Weight interchange with the JAX package (numpy in, tensors out)."""

from imagent_tpu_torch.compat.jax_weights import (
    convnext_params_from_jax, convnext_params_to_jax,
    resnet_params_from_jax, resnet_params_to_jax, vit_params_from_jax,
    vit_params_to_jax,
)
