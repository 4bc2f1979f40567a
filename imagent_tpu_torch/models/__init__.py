"""Model registry (PyTorch port of ``imagent_tpu/models/__init__.py``).

The ResNet, ViT and ConvNeXt families are ported.
"""

from __future__ import annotations

import torch


def create_model(arch: str, num_classes: int = 1000, bf16: bool = False,
                 image_size: int = 224,
                 generator: torch.Generator | None = None, **overrides):
    """Instantiate a model by name (the ``--arch`` flag), its weights
    drawn from ``generator``. ``overrides`` are forwarded to the ResNet
    (``stem``), the ViT (``attn_impl``, ``fused_qkv``,
    ``register_tokens``) or the ConvNeXt (``fused_mlp``,
    ``drop_path_rate``); ``remat`` is refused for every family."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    if arch.startswith("vit"):
        from imagent_tpu_torch.models import vit
        return vit.create_vit(arch, num_classes=num_classes, dtype=dtype,
                              image_size=image_size, generator=generator,
                              **overrides)
    if arch.startswith("convnext"):
        from imagent_tpu_torch.models.convnext import create_convnext
        fused_mlp = overrides.pop("fused_mlp", "off")
        drop_path = overrides.pop("drop_path_rate", 0.0)
        if overrides:
            raise ValueError(f"overrides {sorted(overrides)} do not apply "
                             "to the ConvNeXt family")
        return create_convnext(arch, num_classes=num_classes, dtype=dtype,
                               generator=generator, fused_mlp=fused_mlp,
                               drop_path_rate=drop_path)
    from imagent_tpu_torch.models.resnet import ARCH_DEFS, create_resnet
    if arch in ARCH_DEFS:
        if overrides.pop("remat", False):
            raise ValueError("remat is not yet ported to imagent_tpu_torch")
        stem = overrides.pop("stem", "v1")
        if overrides:
            raise ValueError(f"overrides {sorted(overrides)} do not apply "
                             "to the ResNet family")
        return create_resnet(arch, num_classes=num_classes, dtype=dtype,
                             generator=generator, stem=stem)
    raise ValueError(f"unknown --arch {arch!r}")
