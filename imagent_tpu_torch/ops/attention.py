"""Dot-product attention, written out (einsum), in the JAX layout
``(B, N, H, D)``; PyTorch port of ``imagent_tpu/ops/attention.py``.

The plain path behind ``--attn full``. ``ops/flash_attention.py`` swaps
in behind the same signature.
"""

from __future__ import annotations

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Standard softmax attention. q/k/v ``(B, N, H, D)`` -> ``(B, N, H, D)``.

    The logits are computed in the input type and the softmax statistics
    in fp32; the weights are cast back to the input type for the second
    product, as in the JAX package."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    weights = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = weights / weights.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(dtype), v)
