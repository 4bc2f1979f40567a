"""ConvNeXt (tiny/small/base/large), PyTorch port of
``imagent_tpu/models/convnext.py``.

Same architecture as the JAX model and torchvision's ``convnext_*``:
stem 4x4/s4 conv + LayerNorm, stage transitions LayerNorm + 2x2/s2
conv, blocks [depthwise 7x7 -> LayerNorm -> Linear 4x -> GELU -> Linear]
with a per-channel layer scale initialised to 1e-6, LayerNorm eps 1e-6
everywhere, exact GELU, global mean pool, fp32 head. Parameter counts
match the published ones (``CONVNEXT_PARAM_COUNTS``).

Channels-last end to end, as the JAX model: the input and every
activation are NHWC; the convolutions run on a channels-last NCHW view
of them (no copy), LayerNorm reduces the last axis and the two MLP
projections are matrix products on it. Module names follow the Flax
tree (``stem_conv``, ``stage{i}_block{j}.dwconv``, ``.norm``,
``.pwconv1``, ...), and ``pwconv1``/``pwconv2`` keep Flax's Dense
layout, a ``kernel`` of ``(in, out)``: ``C x 4C`` and ``4C x C``, the
layout the fused kernels read, so no transposed copy is made per step.
``compat/jax_weights.py`` maps the rest (conv kernels HWIO <-> OIHW,
the head's Dense <-> ``nn.Linear``).

Mixed precision follows Flax's ``dtype=bfloat16`` placement: parameters
stay fp32; each conv and projection casts its input, weight and bias to
the compute type; LayerNorm takes fp32 statistics and returns the
compute type; the residual stream is in the compute type; the head runs
in fp32 after the pool.

``fused_mlp`` (auto|on|off, the --fused-mlp flag) runs each block's
LN -> C->4C -> GELU -> 4C->C -> layer-scale -> residual chain through
``ops/fused_mlp.py`` (the CUDA kernels on the card, their plain versions
on the CPU) where ``unfused_reason`` says the kernel fits, reading the
same parameters: the parameter tree is the same in every mode.

Stochastic depth is refused: the JAX package's train step supports only
``drop_path_rate=0.0`` (no droppath rngs), and the port has no other
caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagent_tpu_torch.models.vit import trunc_normal_
from imagent_tpu_torch.ops.fused_mlp import fused_mlp_block, unfused_reason

_LN_EPS = 1e-6
_INIT_STD = 0.02  # torchvision's trunc_normal_(std=0.02)

# (depths, dims) per arch — torchvision's constructor table.
CONVNEXT_DEFS = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}

# torchvision published param counts at 1000 classes.
CONVNEXT_PARAM_COUNTS = {
    "convnext_tiny": 28_589_128,
    "convnext_small": 50_223_688,
    "convnext_base": 88_591_464,
    "convnext_large": 197_767_336,
}


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """fp32 statistics over the last axis, output in the input's type."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        _LN_EPS).to(x.dtype)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """NHWC in, NHWC out: the conv on a channels-last NCHW view, weight
    and bias cast to the input's type."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 conv.bias.to(x.dtype), conv.stride, conv.padding,
                 conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Flax's ``nn.Dense`` layout: ``y = x @ kernel + bias`` with a
    ``kernel`` of ``(in, out)``."""

    def __init__(self, features_in: int, features_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))

    def forward(self, x):
        return torch.addmm(self.bias.to(x.dtype), x.reshape(-1, x.shape[-1]),
                           self.kernel.to(x.dtype)).reshape(
                               *x.shape[:-1], self.kernel.shape[1])


class ConvNeXtBlock(nn.Module):
    """Inverted depthwise block: dw7x7 -> LN -> 4x MLP -> layer scale ->
    residual."""

    def __init__(self, dim: int, fused_mlp: str = "off"):
        super().__init__()
        self.dim = dim
        self.fused_mlp = fused_mlp
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=_LN_EPS)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.layer_scale = nn.Parameter(torch.empty(dim))
        self._fuses = {}  # device -> fused or not, decided on first call

    def reset_parameters(self, generator) -> None:
        for w in (self.dwconv.weight, self.pwconv1.kernel,
                  self.pwconv2.kernel):
            trunc_normal_(w, _INIT_STD, generator)
        for b in (self.dwconv.bias, self.pwconv1.bias, self.pwconv2.bias,
                  self.norm.bias):
            nn.init.zeros_(b)
        nn.init.ones_(self.norm.weight)
        nn.init.constant_(self.layer_scale, 1e-6)

    def forward(self, x):
        y = _conv(x, self.dwconv)
        fuses = self._fuses.get(x.device)
        if fuses is None:
            fuses = self._fuses[x.device] = unfused_reason(
                self.fused_mlp, self.dim, device=x.device) is None
        if fuses:
            return fused_mlp_block(
                x, y, self.norm.weight, self.norm.bias, self.pwconv1.kernel,
                self.pwconv1.bias, self.pwconv2.kernel, self.pwconv2.bias,
                self.layer_scale, eps=_LN_EPS)
        y = _layer_norm(y, self.norm)
        y = F.gelu(self.pwconv1(y))
        y = self.pwconv2(y)
        return x + y * self.layer_scale.to(y.dtype)


class ConvNeXt(nn.Module):
    """torchvision-plan ConvNeXt over NHWC input. ``dtype`` is the
    compute type (``torch.bfloat16`` under ``--bf16``); parameters are
    fp32. The constructor leaves the weights uninitialised;
    ``reset_parameters(generator)`` draws them (``create_convnext``
    does)."""

    def __init__(self, depths, dims, num_classes: int = 1000,
                 dtype=torch.float32, fused_mlp: str = "off"):
        super().__init__()
        self.depths = tuple(depths)
        self.dims = tuple(dims)
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=_LN_EPS)
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i > 0:
                setattr(self, f"downsample{i}_norm",
                        nn.LayerNorm(dims[i - 1], eps=_LN_EPS))
                setattr(self, f"downsample{i}_conv",
                        nn.Conv2d(dims[i - 1], dim, 2, stride=2))
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}",
                        ConvNeXtBlock(dim, fused_mlp))
        self.head_norm = nn.LayerNorm(dims[-1], eps=_LN_EPS)
        self.head = nn.Linear(dims[-1], num_classes)

    def blocks(self):
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                yield getattr(self, f"stage{i}_block{j}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None) -> None:
        """torchvision's init (the JAX model's): truncated normal (0.02)
        conv and linear weights, zero biases, unit LayerNorm scales,
        layer scale 1e-6."""
        stages = range(1, len(self.dims))
        for conv in [self.stem_conv, *(getattr(self, f"downsample{i}_conv")
                                       for i in stages)]:
            trunc_normal_(conv.weight, _INIT_STD, generator)
            nn.init.zeros_(conv.bias)
        for norm in [self.stem_norm, self.head_norm,
                     *(getattr(self, f"downsample{i}_norm") for i in stages)]:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)
        for block in self.blocks():
            block.reset_parameters(generator)
        trunc_normal_(self.head.weight, _INIT_STD, generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, x):
        x = _layer_norm(_conv(x.to(self.dtype), self.stem_conv),
                        self.stem_norm)
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = _layer_norm(x, getattr(self, f"downsample{i}_norm"))
                x = _conv(x, getattr(self, f"downsample{i}_conv"))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
        x = x.mean(dim=(1, 2)).float()  # global average pool; head in fp32
        x = _layer_norm(x, self.head_norm)
        return F.linear(x, self.head.weight, self.head.bias)


def create_convnext(arch: str, num_classes: int = 1000, dtype=torch.float32,
                    generator: torch.Generator | None = None,
                    fused_mlp: str = "off",
                    drop_path_rate: float = 0.0) -> ConvNeXt:
    """A ConvNeXt from ``CONVNEXT_DEFS`` with its weights drawn from
    ``generator``. A nonzero ``drop_path_rate`` is refused."""
    if arch not in CONVNEXT_DEFS:
        raise ValueError(f"unknown ConvNeXt arch {arch!r}; one of "
                         f"{sorted(CONVNEXT_DEFS)}")
    if drop_path_rate:
        raise ValueError(f"drop_path_rate={drop_path_rate} is not yet "
                         "ported to imagent_tpu_torch (the JAX train step "
                         "supports 0.0 only)")
    if fused_mlp not in ("auto", "on", "off"):
        raise ValueError(
            f"--fused-mlp must be one of auto|on|off, got {fused_mlp!r}")
    depths, dims = CONVNEXT_DEFS[arch]
    model = ConvNeXt(depths, dims, num_classes=num_classes, dtype=dtype,
                     fused_mlp=fused_mlp)
    model.reset_parameters(generator)
    return model
