"""ResNet family (18/34/50/101/152, ResNeXt, Wide ResNet), PyTorch port
of ``imagent_tpu/models/resnet.py``.

The same architecture as the JAX model and torchvision's: the block
plan of ``ARCH_DEFS``, BatchNorm after every convolution, stride on the
3x3 of a bottleneck (torchvision v1.5), bias-free convolutions with
symmetric ``k // 2`` padding, the projection shortcut only where the
shapes differ, He fan-out *normal* conv init, global average pool and an
fp32 head. Parameter counts match the published ones (``PARAM_COUNTS``).

Channels-last end to end, as the JAX model and the port's ConvNeXt: the
input and every activation are NHWC; the convolutions run on a
channels-last NCHW view of them (no copy, cuDNN's channels-last
kernels), and BatchNorm reduces every axis but the last. Module names
follow the Flax tree (``conv1``, ``bn1``, ``layer{i}_block{j}.Conv_{k}``
/ ``.BatchNorm_{k}``, ``.downsample_conv``/``.downsample_bn``, ``fc``),
so ``compat/jax_weights.py`` maps the weights leaf by leaf.

``BatchNorm`` is the port's own, computing what ``flax.linen.BatchNorm``
computes (momentum 0.9, eps 1e-5): batch statistics over N, H and W in
fp32 whatever the compute type, ``var = max(E[x^2] - E[x]^2, 0)`` (the
*biased* variance), normalisation by the batch statistics in train mode
and by the running ones in eval mode, and the running statistics updated
as ``0.9 * running + 0.1 * batch`` with that biased variance.
``torch.nn.BatchNorm2d`` would update ``running_var`` with the unbiased
variance (n / (n - 1) times larger) and count batches; this module does
neither. The running statistics are buffers, so ``state_dict``, the
checkpoints and ``--resume`` carry them; they stay per replica, as in
the JAX package.

Mixed precision follows Flax's ``dtype=bfloat16`` placement: parameters
and BN statistics stay fp32; each conv casts its input and weight to the
compute type; BatchNorm normalises in fp32 and returns the compute type;
the head runs in fp32 after the pool.

Not ported: ``remat`` (``create_model`` refuses it) and the pipeline
``stage``/``pipe_boundary`` split.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagent_tpu_torch.models.vit import lecun_normal_

# Flax's convention: running = m * running + (1 - m) * batch.
_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5

# Per-arch structure: (stage_sizes, bottleneck?, groups, base_width), a
# copy of the JAX package's table.
ARCH_DEFS = {
    "resnet18": ((2, 2, 2, 2), False, 1, 64),
    "resnet34": ((3, 4, 6, 3), False, 1, 64),
    "resnet50": ((3, 4, 6, 3), True, 1, 64),
    "resnet101": ((3, 4, 23, 3), True, 1, 64),
    "resnet152": ((3, 8, 36, 3), True, 1, 64),
    "resnext50_32x4d": ((3, 4, 6, 3), True, 32, 4),
    "resnext101_32x8d": ((3, 4, 23, 3), True, 32, 8),
    "wide_resnet50_2": ((3, 4, 6, 3), True, 1, 128),
    "wide_resnet101_2": ((3, 4, 23, 3), True, 1, 128),
}

STAGE_SIZES = {name: d[0] for name, d in ARCH_DEFS.items()}

# torchvision reference param counts at 1000 classes (trainable only).
PARAM_COUNTS = {
    "resnet18": 11_689_512,
    "resnet34": 21_797_672,
    "resnet50": 25_557_032,
    "resnet101": 44_549_160,
    "resnet152": 60_192_808,
    "resnext50_32x4d": 25_028_904,
    "resnext101_32x8d": 88_791_336,
    "wide_resnet50_2": 68_883_240,
    "wide_resnet101_2": 126_886_696,
}


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis of an NHWC (or any
    channels-last) tensor; see the module docstring."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        # At least fp32 (Flax's promote_types(dtype, float32)).
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(axes)
            var = torch.clamp_min((x32 * x32).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(
                    _BN_MOMENTUM * self.running_mean
                    + (1 - _BN_MOMENTUM) * mean)
                self.running_var.copy_(
                    _BN_MOMENTUM * self.running_var
                    + (1 - _BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # Flax's _normalize, in its order: (x - mean) * (rsqrt(var + eps)
        # * scale) + bias, in fp32, then the compute type.
        y = (x32 - mean) * (torch.rsqrt(var + _BN_EPS) * self.weight)
        return (y + self.bias).to(x.dtype)


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """NHWC in, NHWC out: ``layer`` on a channels-last NCHW view of
    ``x``, its weight cast to ``x``'s type."""
    y = F.conv2d(x.permute(0, 3, 1, 2), layer.weight.to(x.dtype), None,
                 layer.stride, layer.padding, layer.dilation, layer.groups)
    return y.permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          padding: int | None = None) -> nn.Conv2d:
    """A bias-free conv with torch's symmetric ``k // 2`` padding (the
    JAX model's ``_sym_pad``)."""
    return nn.Conv2d(cin, cout, k, stride,
                     k // 2 if padding is None else padding, groups=groups,
                     bias=False)


class BasicBlock(nn.Module):
    """2 x 3x3 residual block (resnet18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1, "
                             "base_width=64 (torchvision semantics)")
        self.Conv_0 = _conv(cin, filters, 3, stride)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = _conv(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters)
        if stride != 1 or cin != filters:
            self.downsample_conv = _conv(cin, filters, 1, stride)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(conv(x, self.Conv_0)))
        y = self.BatchNorm_1(conv(y, self.Conv_1))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(conv(x, self.downsample_conv))
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, groups) -> 1x1 block (resnet50 and wider),
    inner width ``int(filters * base_width / 64) * groups``."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(filters * base_width / 64) * groups
        cout = filters * self.expansion
        self.Conv_0 = _conv(cin, width, 1)
        self.BatchNorm_0 = BatchNorm(width)
        self.Conv_1 = _conv(width, width, 3, stride, groups)
        self.BatchNorm_1 = BatchNorm(width)
        self.Conv_2 = _conv(width, cout, 1)
        self.BatchNorm_2 = BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.downsample_conv = _conv(cin, cout, 1, stride)
            self.downsample_bn = BatchNorm(cout)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(conv(x, self.Conv_0)))
        y = F.relu(self.BatchNorm_1(conv(y, self.Conv_1)))
        y = self.BatchNorm_2(conv(y, self.Conv_2))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(conv(x, self.downsample_conv))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """torchvision-plan ResNet over NHWC input. ``dtype`` is the compute
    type (``torch.bfloat16`` under ``--bf16``); parameters are fp32.
    ``stem`` is ``v1`` (7x7/s2 conv + 3x3/s2 max-pool) or ``s2d``
    (space-to-depth to 12 channels, then a 4x4/s1 conv padded
    ((2, 1), (2, 1)), the exact receptive field of the 7x7/s2 pad 3).
    ``num_filters`` is the stem's width; stage i has ``num_filters *
    2**i`` filters (the JAX model's field; the published archs use 64)."""

    def __init__(self, stage_sizes, bottleneck: bool, num_classes: int = 1000,
                 groups: int = 1, base_width: int = 64, dtype=torch.float32,
                 stem: str = "v1", num_filters: int = 64):
        super().__init__()
        if stem not in ("v1", "s2d"):
            raise ValueError(f"unknown stem {stem!r}; 'v1' or 's2d'")
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.stem = stem
        if stem == "s2d":
            self.conv1 = _conv(12, num_filters, 4, padding=0)
        else:
            self.conv1 = _conv(3, num_filters, 7, 2)
        self.bn1 = BatchNorm(num_filters)
        block_cls = Bottleneck if bottleneck else BasicBlock
        cin = num_filters
        for i, n_blocks in enumerate(self.stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, f"layer{i + 1}_block{j}",
                        block_cls(cin, filters, stride, groups, base_width))
                cin = filters * block_cls.expansion
        self.fc = nn.Linear(cin, num_classes)

    def blocks(self):
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                yield getattr(self, f"layer{i + 1}_block{j}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None) -> None:
        """The JAX model's init: He fan-out normal conv kernels
        (``variance_scaling(2.0, "fan_out", "normal")``), unit BN scales
        and zero BN biases, Flax's default Dense init for the head
        (LeCun truncated normal, zero bias)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(2.0 / fan_out)
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
            elif isinstance(m, BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        lecun_normal_(self.fc.weight, self.fc.in_features, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "s2d":
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"stem='s2d' needs even H/W (space-to-depth "
                                 f"rearrange), got {h}x{w}")
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            # NHWC: pad W then H by (2, 1) each, the JAX model's padding.
            x = F.pad(x, (0, 0, 2, 1, 2, 1))
        x = F.relu(self.bn1(conv(x, self.conv1)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for block in self.blocks():
            x = block(x)
        x = x.mean(dim=(1, 2)).float()  # global average pool; head in fp32
        return self.fc(x)


def create_resnet(arch: str, num_classes: int = 1000, dtype=torch.float32,
                  generator: torch.Generator | None = None,
                  stem: str = "v1") -> ResNet:
    """A ResNet from ``ARCH_DEFS`` with its weights drawn from
    ``generator``."""
    if arch not in ARCH_DEFS:
        raise ValueError(f"unknown ResNet arch {arch!r}; one of "
                         f"{sorted(ARCH_DEFS)}")
    stages, bottleneck, groups, base_width = ARCH_DEFS[arch]
    model = ResNet(stages, bottleneck, num_classes=num_classes, groups=groups,
                   base_width=base_width, dtype=dtype, stem=stem)
    model.reset_parameters(generator)
    return model
