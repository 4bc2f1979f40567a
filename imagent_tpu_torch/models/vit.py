"""Vision Transformer (ViT-B/16, ViT-L/16, ...), PyTorch port of
``imagent_tpu/models/vit.py``.

Same architecture as the JAX model and torchvision's ``vit_b_16``:
patchify conv, class token, learned position embedding, pre-LN encoder
blocks (LN eps 1e-6, exact GELU), final LN, class-token readout, fp32
head. Parameter names are torchvision's (``conv_proj``, ``class_token``,
``encoder.pos_embedding``, ``encoder.layers.encoder_layer_i.*`` with a
fused ``self_attention.in_proj_weight``, ``encoder.ln``,
``heads.head``), plus a top-level ``register_tokens`` when those are
on; ``compat/jax_weights.py`` maps them to and from the Flax tree.

Input is NHWC, as at the JAX model's public call. Mixed precision
follows Flax's ``dtype=bfloat16`` placement explicitly rather than
through ``torch.autocast``: parameters stay fp32 and every projection
casts its input, weight and bias to the compute type; the residual
stream is in the compute type; LayerNorm takes its statistics in fp32
and returns the compute type; the head runs in fp32.

Not ported in this slice: sequence/tensor/pipeline parallelism, MoE,
remat and GAP readout (``create_vit`` refuses them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagent_tpu_torch.ops.attention import dot_product_attention

VIT_REGISTRY = {
    "vit_b16": dict(patch_size=16, hidden_dim=768, num_layers=12,
                    num_heads=12, mlp_dim=3072),
    "vit_l16": dict(patch_size=16, hidden_dim=1024, num_layers=24,
                    num_heads=16, mlp_dim=4096),
    "vit_h14": dict(patch_size=14, hidden_dim=1280, num_layers=32,
                    num_heads=16, mlp_dim=5120),
    # Debug-scale arch for CPU tests — not a real model.
    "vit_debug": dict(patch_size=8, hidden_dim=32, num_layers=2,
                      num_heads=4, mlp_dim=64),
}

# torchvision reference param counts at 1000 classes.
VIT_PARAM_COUNTS = {
    "vit_b16": 86_567_656,
    "vit_l16": 304_326_632,
}

_LN_EPS = 1e-6
# Std of a standard normal truncated to [-2, 2]: lecun_normal divides by
# it so the truncated draw keeps variance 1/fan_in (JAX's constant).
_TRUNC_STD = 0.87962566103423978


def _make_attn_fn(attn_impl: str):
    if attn_impl == "full":
        return dot_product_attention
    if attn_impl == "flash":
        from imagent_tpu_torch.ops.flash_attention import flash_attention
        return flash_attention
    raise ValueError(f"attn_impl {attn_impl!r} is unknown or not yet ported "
                     "to imagent_tpu_torch (full, flash)")


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator | None) -> torch.Tensor:
    """``std`` x a standard normal truncated to [-2, 2], by the inverse
    CDF (``jax.random.truncated_normal``'s method), drawn in float64."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(
        lo, hi, generator=generator)
    x = (torch.erfinv(u) * math.sqrt(2)).clamp_(-2.0, 2.0)
    return t.copy_(x * std)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> torch.Tensor:
    """Flax's default kernel init: truncated normal with variance
    1/fan_in."""
    return trunc_normal_(t, (1.0 / fan_in) ** 0.5 / _TRUNC_STD, generator)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """fp32 statistics, output in the input's (compute) type."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        _LN_EPS).to(x.dtype)


def _linear(x: torch.Tensor, weight, bias) -> torch.Tensor:
    return F.linear(x, weight.to(x.dtype), bias.to(x.dtype))


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around the attention kernel. The q, k and
    v weights live in one ``in_proj_weight`` [3D, D] (torchvision's
    layout). ``fused_qkv`` computes the three projections as one GEMM
    and hands the attention kernel strided views of its output; without
    it they are three GEMMs — the same parameters either way."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "full",
                 fused_qkv: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.fused_qkv = fused_qkv
        self.attn = _make_attn_fn(attn_impl)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def reset_parameters(self, generator) -> None:
        d = self.out_proj.in_features
        lecun_normal_(self.in_proj_weight, d, generator)
        nn.init.zeros_(self.in_proj_bias)
        lecun_normal_(self.out_proj.weight, d, generator)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x):
        b, n, d = x.shape
        heads = (self.num_heads, d // self.num_heads)
        w, bias = self.in_proj_weight, self.in_proj_bias
        if self.fused_qkv:
            qkv = _linear(x, w, bias)
            q, k, v = (qkv[..., i * d:(i + 1) * d].unflatten(-1, heads)
                       for i in range(3))
        else:
            q, k, v = (_linear(x, w[i * d:(i + 1) * d],
                               bias[i * d:(i + 1) * d]).unflatten(-1, heads)
                       for i in range(3))
        y = self.attn(q, k, v)
        return _linear(y.flatten(2), self.out_proj.weight, self.out_proj.bias)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: x += MHA(LN(x)); x += MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 attn_impl: str = "full", fused_qkv: bool = False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.self_attention = MultiHeadAttention(dim, num_heads, attn_impl,
                                                 fused_qkv)
        self.ln_2 = nn.LayerNorm(dim, eps=_LN_EPS)
        # torchvision's MLPBlock indices: 0 Linear, 1 GELU, 2 Dropout,
        # 3 Linear (the state_dict keys mlp.0.* and mlp.3.*).
        self.mlp = nn.Sequential(nn.Linear(dim, mlp_dim), nn.GELU(),
                                 nn.Identity(), nn.Linear(mlp_dim, dim))

    def reset_parameters(self, generator) -> None:
        for ln in (self.ln_1, self.ln_2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)
        self.self_attention.reset_parameters(generator)
        for lin in (self.mlp[0], self.mlp[3]):
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x):
        x = x + self.self_attention(_layer_norm(x, self.ln_1))
        y = _layer_norm(x, self.ln_2)
        y = F.gelu(_linear(y, self.mlp[0].weight, self.mlp[0].bias))
        return x + _linear(y, self.mlp[3].weight, self.mlp[3].bias)


class _Encoder(nn.Module):
    def __init__(self, n_tokens, dim, num_layers, num_heads, mlp_dim,
                 attn_impl, fused_qkv):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, n_tokens, dim))
        self.layers = nn.ModuleDict({
            f"encoder_layer_{i}": EncoderBlock(dim, num_heads, mlp_dim,
                                               attn_impl, fused_qkv)
            for i in range(num_layers)})
        self.ln = nn.LayerNorm(dim, eps=_LN_EPS)


class _Heads(nn.Module):
    def __init__(self, dim, num_classes):
        super().__init__()
        self.head = nn.Linear(dim, num_classes)


class VisionTransformer(nn.Module):
    """Class-token ViT over NHWC input. ``dtype`` is the compute type
    (``torch.bfloat16`` under ``--bf16``); parameters are fp32.
    ``image_size`` fixes the position-embedding length, as the JAX
    model's init shape does. The constructor leaves the weights
    uninitialised; ``reset_parameters(generator)`` draws them (the
    registry's ``create_vit`` does)."""

    def __init__(self, image_size: int, patch_size: int = 16,
                 hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 num_classes: int = 1000, dtype=torch.float32,
                 attn_impl: str = "full", fused_qkv: bool = False,
                 register_tokens: int = 0):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.n_registers = register_tokens
        side = image_size // patch_size
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.encoder = _Encoder(side * side + 1, hidden_dim, num_layers,
                                num_heads, mlp_dim, attn_impl, fused_qkv)
        if register_tokens:
            self.register_tokens = nn.Parameter(
                torch.empty(1, register_tokens, hidden_dim))
        self.heads = _Heads(hidden_dim, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None) -> None:
        """Flax's initializers: lecun_normal (truncated) kernels, zero
        biases and class token, N(0, 0.02) position embedding and
        registers, unit LayerNorm scales."""
        w = self.conv_proj.weight
        lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)
        nn.init.zeros_(self.conv_proj.bias)
        nn.init.zeros_(self.class_token)
        self.encoder.pos_embedding.normal_(0.0, 0.02, generator=generator)
        if self.n_registers:
            self.register_tokens.normal_(0.0, 0.02, generator=generator)
        for block in self.encoder.layers.values():
            block.reset_parameters(generator)
        nn.init.ones_(self.encoder.ln.weight)
        nn.init.zeros_(self.encoder.ln.bias)
        head = self.heads.head
        lecun_normal_(head.weight, head.in_features, generator)
        nn.init.zeros_(head.bias)

    def _patchify(self, x):
        """NHWC -> (B, h*w, D): the stride-p p x p conv with VALID
        padding, written as one GEMM over (p, p, C)-ordered patches."""
        p = self.patch_size
        b, hh, ww, c = x.shape
        h, w = hh // p, ww // p
        x = x[:, :h * p, :w * p].reshape(b, h, p, w, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * w, p * p * c)
        kernel = self.conv_proj.weight.permute(0, 2, 3, 1).flatten(1)
        return _linear(x, kernel, self.conv_proj.bias)

    def forward(self, x):
        x = self._patchify(x.to(self.dtype))
        b, _, d = x.shape
        cls = self.class_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1)
        x = x + self.encoder.pos_embedding.to(self.dtype)
        if self.n_registers:
            x = torch.cat([x, self.register_tokens.to(self.dtype).expand(
                b, self.n_registers, d)], dim=1)
        for block in self.encoder.layers.values():
            x = block(x)
        x = _layer_norm(x, self.encoder.ln)
        pooled = x[:, 0].float()  # class-token readout; head in fp32
        return F.linear(pooled, self.heads.head.weight, self.heads.head.bias)


def create_vit(arch: str, num_classes: int = 1000, dtype=torch.float32,
               image_size: int = 224, generator: torch.Generator | None = None,
               **overrides) -> VisionTransformer:
    """A ViT from the registry with its weights drawn from
    ``generator``. ``overrides``: ``attn_impl`` (full | flash),
    ``fused_qkv``, ``register_tokens``; the JAX model's parallel-layout,
    MoE and remat overrides are refused as not yet ported."""
    if arch not in VIT_REGISTRY:
        raise ValueError(f"unknown ViT arch {arch!r}")
    extra = sorted(set(overrides) - {"attn_impl", "fused_qkv",
                                     "register_tokens"})
    if extra:
        raise ValueError(f"ViT overrides {extra} are not yet ported to "
                         "imagent_tpu_torch")
    model = VisionTransformer(image_size, num_classes=num_classes,
                              dtype=dtype, **VIT_REGISTRY[arch], **overrides)
    model.reset_parameters(generator)
    return model
