"""Fused stride-1 identity ResNet bottleneck (eval mode, BatchNorm folded
into the convolutions): a hand-written CUDA kernel for Hopper, with the
plain PyTorch version of the same math.

Port of ``imagent_tpu/ops/fused_block.py``:

    out = relu(x + (relu(conv3x3(relu(x W1 + b1)) + b3)) Wc + bc)

``fused_bottleneck`` launches ``csrc/fused_block.cu`` (which replaces the
Pallas ``_kernel``; see its header for the design and what bounds it on
an H100): in bf16 ``block_tc_kernel``, three block GEMMs on the tensor
cores (``mma.sync``) with y1 and y2 in shared memory as bf16 and the 3x3
as an implicit GEMM over shifted halo rows; in fp32 the first version's
FMA kernel. The TPU kernel keeps a batch tile's whole H x W extent in
VMEM; a CUDA block owns one spatial tile of one image instead, with a
one-pixel halo of the first 1x1's output recomputed around it. The tile
is chosen per shape against the kernel's own shared-memory formula
(``smem_bytes``) and the device's opt-in limit: ``plan_tc`` for bf16
(the fewest waves times the busiest warp's products), ``plan`` for fp32.

Numerics follow the TPU kernel: the three products accumulate in fp32,
the biases are fp32, y1 and y2 are rounded to ``x``'s dtype before the
next product, and the residual add and the last ReLU run in fp32 before
the output is rounded. y1 is zero outside the image (the TPU pads y1,
not x): with folded BN, b1 is far from zero.

Forward only, as in the JAX package (no VJP). No model path calls it:
the JAX package's docstring records that it lost to XLA's unfused
schedule on a TPU; here it is checked on the card against the
eval-mode blocks of a trained ResNet-50 (``chip_smoke.py``).

Dispatch: ``fused_bottleneck`` launches the kernel for CUDA tensors (by
dtype only: bf16 to the tensor-core kernel, fp32 to the FMA kernel) and
raises for any other; ``reference_bottleneck`` is the plain version.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

LAUNCHES = {"fused_block": 0}

# GEMM geometry of the fp32 kernel of csrc/fused_block.cu (kRows, kCols,
# kKC): each pass of a block computes up to ROWS pixels x COLS channels,
# its K axis staged KC at a time.
ROWS, COLS, KC = 64, 64, 32
# The bf16 tensor-core kernel (kTcKC, kTcStages, kTcStage): K staged
# TC_KC at a time through a ring of TC_STAGES stages of TC_STAGE bf16
# elements each (the largest x chunk + weight chunk of its three warp
# grids); a warp computes 64 rows x 32 columns, 8 warps a block.
TC_KC, TC_STAGES = 64, 2
TC_STAGE = 256 * (TC_KC + 8) + TC_KC * (64 + 8)
# Bytes ahead of y1: the three steps' GEMM geometry (kTcGeoBytes).
TC_GEO_BYTES = 128
# Streaming multiprocessors of an H100 SXM: the plan's wave count when
# no CUDA device is given.
H100_SMS = 132
# Opt-in shared memory per block of an H100 (sm_90): the limit the plan
# uses when no CUDA device is given.
H100_SMEM_OPTIN = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "fused_block": [_P] * 8 + [_I] * 12 + [_P],
    "fused_block_smem_bytes": [_I, _I, _I, _I],
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


def smem_bytes(th: int, tw: int, f: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block for a ``th`` x ``tw`` output
    tile at bottleneck width ``f``. fp32 (``smem_floats`` of
    csrc/fused_block.cu): y1 over the halo and y2 over the tile, both
    fp32 and channel-major with one pad float per row, plus the staged
    x and weight chunks. bf16 (``tc_smem_bytes``): the steps' geometry
    (``TC_GEO_BYTES``), y1 and y2 as bf16, pixel-major, ``f`` padded to
    whole ``TC_KC`` chunks plus an 8-element pitch pad, and
    ``TC_STAGES`` stages of ``TC_STAGE`` elements."""
    p1, q = (th + 2) * (tw + 2), th * tw
    if dtype == torch.bfloat16:
        return TC_GEO_BYTES + 2 * ((p1 + q) * (tc_fp(f) + 8)
                                   + TC_STAGES * TC_STAGE)
    return 4 * (f * (p1 + 1) + f * (q + 1) + KC * (ROWS + 1) + KC * COLS)


def tc_fp(f: int) -> int:
    """``f`` zero-padded to whole chunks of the bf16 kernel (``tc_fp``)."""
    return -(-f // TC_KC) * TC_KC


# Output tiles the fp32 plan chooses from: (th + 2) * (tw + 2) <= ROWS,
# so the halo fits one GEMM pass.
TILES = ((6, 6), (4, 8), (8, 4), (4, 7), (7, 4), (5, 5), (4, 6), (6, 4),
         (4, 4), (3, 8), (8, 3), (2, 8), (8, 2), (2, 4), (1, 1))


def _smem_limit(device) -> int:
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return int(getattr(props, "shared_memory_per_block_optin",
                           H100_SMEM_OPTIN))
    return H100_SMEM_OPTIN


def _sm_count(device) -> int:
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count
    return H100_SMS


def plan(h: int, w: int, f: int, device=None) -> tuple[int, int]:
    """The fp32 kernel's output tile ``(th, tw)`` for an ``h`` x ``w``
    image at width ``f``: of the tiles in ``TILES`` whose shared memory
    fits the device's opt-in limit (an H100's when ``device`` is not CUDA), the
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


def _tc_warp_tiles(m: int, wn: int) -> int:
    """16-row tiles of the busiest warp of the bf16 kernel over ``m``
    rows, summed over its row passes: 8 // ``wn`` warps down the rows,
    64 rows (4 tiles) each, a pass of 512 // ``wn`` rows."""
    return sum(min(4, -(-(m - m0) // 16)) for m0 in range(0, m, 512 // wn))


# The bf16 plan's cost weights, nanoseconds on an H100 at one block per
# SM: of one warp step (16 rows x 32 columns x 16 of K, 4 mma, counted on
# the busiest warp), of one KB staged into a block's shared memory
# (weight chunks, and step 1's x halo), and of one pass (its epilogue and
# its turn of the ring). Fitted by least squares to the kernel's times at
# forced plans (chip_smoke.py --block-plans).
TC_STEP_NS, TC_KB_NS, TC_PASS_NS = 41.0, 29.0, 4600.0


class TcPlan(NamedTuple):
    """A launch of the bf16 kernel: the ``th`` x ``tw`` output tile, the
    blocks per tile (``split`` 2: a cluster of two that split every
    step's columns and trade y1's and y2's halves through distributed
    shared memory) and each step's warps across the columns (``wn``)."""
    th: int
    tw: int
    split: int
    wn: tuple


def _tc_steps(c: int, f: int, th: int, tw: int, split: int) -> tuple:
    """Per step of the bf16 kernel: its rows, its columns in one block,
    its k16 steps, the KB of weights it stages per row pass and the KB
    of x halo (step 1) per column pass; F padded by ``tc_fp``, C to
    whole chunks, a block of a split tile computing half the columns."""
    fp, cp, p1, q = tc_fp(f), tc_fp(c), (th + 2) * (tw + 2), th * tw
    cols_f, cols_c = fp // split, c // split
    return ((p1, cols_f, cp // 16, cp * cols_f / 512, p1 * cp / 512),
            (q, cols_f, 9 * fp // 16, 9 * fp * cols_f / 512, 0.0),
            (q, cols_c, fp // 16, fp * cols_c / 512, 0.0))


def _tc_terms(step: tuple, wn: int) -> tuple:
    """``(warp steps, KB, passes)`` of one step (``_tc_steps``) at
    ``wn`` warps across the columns: passes of BM = 512 / wn rows by 32
    wn columns, the weights staged once per row pass, the x halo once
    per column pass, the busiest warp's steps."""
    m, cols, k16, w_kb, x_kb = step
    passes, blocks_n = -(-m // (512 // wn)), -(-cols // (32 * wn))
    return (_tc_warp_tiles(m, wn) * blocks_n * k16,
            passes * w_kb + blocks_n * x_kb, passes * blocks_n)


def tc_terms(b: int, h: int, w: int, c: int, f: int, plan,
             sms: int = H100_SMS) -> tuple:
    """``(waves, warp steps, KB, passes)`` of the bf16 kernel at
    ``plan`` (a ``TcPlan``): the waves of its blocks on ``sms`` SMs at
    one block each, and one block's terms summed over the three steps;
    the model that ``tc_cost`` weighs."""
    th, tw, split, wn = plan
    terms = [_tc_terms(st, n) for st, n in
             zip(_tc_steps(c, f, th, tw, split), wn)]
    blocks = b * -(-h // th) * -(-w // tw) * split
    return (-(-blocks // sms), *(sum(t[i] for t in terms) for i in range(3)))


def tc_cost(b: int, h: int, w: int, c: int, f: int, th: int, tw: int,
            split: int = 1, sms: int = H100_SMS) -> tuple[float, tuple]:
    """``(ns, wn)`` of the bf16 kernel at a ``th`` x ``tw`` tile: the
    waves of ``b`` x tiles x ``split`` blocks on ``sms`` SMs at one block
    each, times one block's modelled time (``tc_terms`` weighed by
    ``TC_STEP_NS``, ``TC_KB_NS``, ``TC_PASS_NS``), each step at the warps
    across the columns (``wn``) of 2, 4 and 8 that cost it least and
    leave no warp without columns."""
    total, wns = 0.0, []
    for step in _tc_steps(c, f, th, tw, split):
        best = None
        for wn in (2, 4, 8):
            if wn > 2 and 32 * wn > step[1]:
                continue
            steps, kb, passes = _tc_terms(step, wn)
            ns = steps * TC_STEP_NS + kb * TC_KB_NS + passes * TC_PASS_NS
            if best is None or ns < best[0]:
                best = (ns, wn)
        total += best[0]
        wns.append(best[1])
    blocks = b * -(-h // th) * -(-w // tw) * split
    return -(-blocks // sms) * total, tuple(wns)


@functools.lru_cache(maxsize=None)
def _plan_tc(b, h, w, c, f, limit, sms):
    best = None
    splits = (1, 2) if c % 64 == 0 else (1,)
    for th in range(1, min(h, 32) + 1):
        for tw in range(1, min(w, 32) + 1):
            if smem_bytes(th, tw, f, torch.bfloat16) > limit:
                continue
            for split in splits:
                ns, wn = tc_cost(b, h, w, c, f, th, tw, split, sms)
                key = (ns, -(-h // th) * -(-w // tw), split)
                if best is None or key < best[0]:
                    best = (key, TcPlan(th, tw, split, wn))
    if best is None:
        least = smem_bytes(1, 1, f, torch.bfloat16)
        raise ValueError(f"F={f} does not fit the fused-block kernel's "
                         f"shared memory ({least} bytes at the smallest "
                         f"tile, limit {limit})")
    return best[1]


def plan_tc(b: int, h: int, w: int, c: int, f: int,
            device=None) -> TcPlan:
    """The bf16 tensor-core kernel's launch for ``b`` images of ``h`` x
    ``w`` at widths ``c``, ``f``: of the tiles (each side at most 32)
    whose shared memory fits the device's opt-in limit, with one or (where
    ``c`` is a multiple of 64) two blocks a tile, the one of least
    ``tc_cost`` on the device's SM count (an H100's when ``device`` is
    not CUDA), ties to fewer tiles, then no split, then the earlier
    (th, tw). Raises when none fits."""
    return _plan_tc(b, h, w, c, f, _smem_limit(device), _sm_count(device))


def tile(b: int, h: int, w: int, c: int, f: int, dtype,
         device=None) -> TcPlan:
    """The launch ``fused_bottleneck`` makes for ``dtype``: ``plan_tc``
    for bf16; for fp32 ``plan``'s tile, one block a tile (``wn`` is not
    the fp32 kernel's and reads (0, 0, 0))."""
    if dtype == torch.bfloat16:
        return plan_tc(b, h, w, c, f, device)
    return TcPlan(*plan(h, w, f, device), 1, (0, 0, 0))


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
    dtype; biases fp32): one launch of the kernel, bf16 on the tensor
    cores, fp32 on the FMA kernel, as ``tile`` plans it. Ragged B, H and
    W are masked in the kernel, and C and F zero-padded there, not here.
    Raises for tensors off CUDA (the plain version is
    ``reference_bottleneck``)."""
    _check(x, w1, b1, w3, b3, wc, bc)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck is the CUDA kernel and takes "
                         f"CUDA tensors, got {x.device}; the plain version "
                         "is reference_bottleneck")
    b, h, w, c = x.shape
    return launch(tile(b, h, w, c, w1.shape[1], x.dtype, x.device),
                  x, w1, b1, w3, b3, wc, bc)


def launch(plan: TcPlan, x, w1, b1, w3, b3, wc, bc):
    """One launch of the kernel at ``plan`` on checked CUDA tensors
    (``fused_bottleneck`` passes the planned one; a sweep of plans,
    ``chip_smoke.py --block-plans``, passes others)."""
    b, h, w, c = x.shape
    th, tw, split, wn = plan
    lib = _kernels()
    args = [t.contiguous() for t in (x, w1, b1, w3, b3, wc, bc)]
    out = torch.empty_like(args[0])
    rc = lib.fused_block(*(t.data_ptr() for t in args), out.data_ptr(),
                         b, h, w, c, w1.shape[1], th, tw, split, *wn,
                         int(x.dtype == torch.bfloat16),
                         torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"fused_block kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["fused_block"] += 1
    return out
