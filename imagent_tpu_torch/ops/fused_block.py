"""Fused stride-1 identity ResNet bottleneck (eval mode, BatchNorm folded
into the convolutions): a hand-written CUDA kernel for Hopper, with the
plain PyTorch version of the same math.

Port of ``imagent_tpu/ops/fused_block.py``:

    out = relu(x + (relu(conv3x3(relu(x W1 + b1)) + b3)) Wc + bc)

``fused_bottleneck`` launches ``csrc/fused_block.cu`` (which replaces the
Pallas ``_kernel``; see its header for the design and what bounds it on
an H100). The TPU kernel keeps a batch tile's whole H x W extent in
VMEM; a CUDA block owns one spatial tile of one image instead, with a
one-pixel halo of the first 1x1's output recomputed around it. The tile
is chosen per shape by ``plan`` against the kernel's own shared-memory
formula (``smem_bytes``) and the device's opt-in limit.

Numerics follow the TPU kernel: the three products accumulate in fp32,
the biases are fp32, y1 and y2 are rounded to ``x``'s dtype before the
next product, and the residual add and the last ReLU run in fp32 before
the output is rounded. y1 is zero outside the image (the TPU pads y1,
not x): with folded BN, b1 is far from zero.

Forward only, as in the JAX package (no VJP). No model path calls it:
the JAX package's docstring records that it lost to XLA's unfused
schedule on a TPU; here it is checked on the card against the
eval-mode blocks of a trained ResNet-50 (``chip_smoke.py``).

Dispatch: ``fused_bottleneck`` launches the kernel for CUDA tensors and
raises for any other; ``reference_bottleneck`` is the plain version.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = {"fused_block": 0}

# GEMM geometry of csrc/fused_block.cu (kRows, kCols, kKC): each pass
# of a block computes up to ROWS pixels x COLS channels, its K axis
# staged KC at a time.
ROWS, COLS, KC = 64, 64, 32
# Opt-in shared memory per block of an H100 (sm_90): the limit the plan
# uses when no CUDA device is given.
H100_SMEM_OPTIN = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "fused_block": [_P] * 8 + [_I] * 8 + [_P],
    "fused_block_smem_bytes": [_I, _I, _I],
}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from imagent_tpu_torch.ops import _cuda
        lib = _cuda.load("fused_block")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ----------------------------------------------------------------- plan


def smem_bytes(th: int, tw: int, f: int) -> int:
    """Dynamic shared memory of one block for a ``th`` x ``tw`` output
    tile at bottleneck width ``f`` (``smem_floats`` of
    csrc/fused_block.cu): y1 over the halo and y2 over the tile, both
    fp32 and channel-major with one pad float per row, plus the staged
    x and weight chunks."""
    p1, q = (th + 2) * (tw + 2), th * tw
    return 4 * (f * (p1 + 1) + f * (q + 1) + KC * (ROWS + 1) + KC * COLS)


# Output tiles the plan chooses from: (th + 2) * (tw + 2) <= ROWS, so
# the halo fits one GEMM pass.
TILES = ((6, 6), (4, 8), (8, 4), (4, 7), (7, 4), (5, 5), (4, 6), (6, 4),
         (4, 4), (3, 8), (8, 3), (2, 8), (8, 2), (2, 4), (1, 1))


def _smem_limit(device) -> int:
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return int(getattr(props, "shared_memory_per_block_optin",
                           H100_SMEM_OPTIN))
    return H100_SMEM_OPTIN


def plan(h: int, w: int, f: int, device=None) -> tuple[int, int]:
    """The output tile ``(th, tw)`` for an ``h`` x ``w`` image at width
    ``f``: of the tiles in ``TILES`` whose shared memory fits the
    device's opt-in limit (an H100's when ``device`` is not CUDA), the
    one with the fewest tiles per image (every tile costs a full
    ``ROWS``-row pass, so fewer tiles is less work), ties to the
    earlier. Raises when none fits."""
    limit = _smem_limit(device)
    best = None
    for th, tw in TILES:
        if smem_bytes(th, tw, f) > limit:
            continue
        n = -(-h // th) * -(-w // tw)
        if best is None or n < best[0]:
            best = (n, (th, tw))
    if best is None:
        raise ValueError(f"F={f} does not fit the fused-block kernel's "
                         f"shared memory ({smem_bytes(1, 1, f)} bytes at "
                         f"the smallest tile, limit {limit})")
    return best[1]


# ---------------------------------------------------------------- plain


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding conv: returns
    ``(kernel * s, bias - mean * s)``, ``s = scale / sqrt(var + eps)``,
    ``kernel``'s output channels last. Exact for running statistics."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s, bias - mean * s


def reference_bottleneck(x, w1, b1, w3, b3, wc, bc):
    """The plain version (the JAX package's ``reference_bottleneck``):
    1x1 matmul, 3x3 conv, 1x1 matmul as unfused torch ops, each product
    on ``x``'s-dtype operands accumulated in fp32 (the operands widened:
    a bf16 product is exact in fp32), fp32 biases, y1 and y2 rounded to
    ``x.dtype``. ``x`` is NHWC, ``w1`` (C, F), ``w3`` (3, 3, F, F) HWIO,
    ``wc`` (F, C)."""
    dt = x.dtype
    y = x.float() @ w1.float() + b1
    y = torch.relu(y).to(dt)
    y = F.conv2d(y.float().permute(0, 3, 1, 2),
                 w3.float().permute(3, 2, 0, 1), padding=1)
    y = torch.relu(y.permute(0, 2, 3, 1) + b3).to(dt)
    y = y.float() @ wc.float() + bc
    return torch.relu(y + x.float()).to(dt)


# --------------------------------------------------------------- kernel


def _check(x, w1, b1, w3, b3, wc, bc) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused block takes float32 or bfloat16, got "
                         f"{x.dtype}")
    c = x.shape[-1]
    f = w1.shape[-1] if w1.dim() == 2 else -1
    want = {"w1": ((c, f), x.dtype), "b1": ((f,), torch.float32),
            "w3": ((3, 3, f, f), x.dtype), "b3": ((f,), torch.float32),
            "wc": ((f, c), x.dtype), "bc": ((c,), torch.float32)}
    for (name, (shape, dtype)), t in zip(want.items(),
                                         (w1, b1, w3, b3, wc, bc)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def fused_bottleneck(x, w1, b1, w3, b3, wc, bc):
    """The fused block on CUDA tensors (``x`` (B, H, W, C) NHWC, ``w1``
    (C, F), ``w3`` (3, 3, F, F) HWIO, ``wc`` (F, C), all in ``x``'s
    dtype; biases fp32): one launch of the kernel. Ragged B, H and W are
    masked in the kernel, not padded. Raises for tensors off CUDA (the
    plain version is ``reference_bottleneck``)."""
    _check(x, w1, b1, w3, b3, wc, bc)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck is the CUDA kernel and takes "
                         f"CUDA tensors, got {x.device}; the plain version "
                         "is reference_bottleneck")
    b, h, w, c = x.shape
    f = w1.shape[1]
    th, tw = plan(h, w, f, x.device)
    lib = _kernels()
    args = [t.contiguous() for t in (x, w1, b1, w3, b3, wc, bc)]
    out = torch.empty_like(args[0])
    rc = lib.fused_block(*(t.data_ptr() for t in args), out.data_ptr(),
                         b, h, w, c, f, th, tw,
                         int(x.dtype == torch.bfloat16),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"fused_block kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["fused_block"] += 1
    return out
