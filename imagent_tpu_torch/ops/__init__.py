"""Ops: attention (plain and the flash CUDA kernels), the fused ConvNeXt
MLP, the fused ResNet bottleneck and the loss."""

from imagent_tpu_torch.ops.cross_entropy import softmax_cross_entropy
