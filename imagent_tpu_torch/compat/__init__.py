"""Weight interchange with the JAX package (numpy in, tensors out)."""

from imagent_tpu_torch.compat.jax_weights import (
    vit_params_from_jax, vit_params_to_jax,
)
