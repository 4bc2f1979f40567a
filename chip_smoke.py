#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``imagent_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still builds and trains.

    python3 chip_smoke.py            # needs one CUDA card; no arguments
    python3 chip_smoke.py --kernels-only   # phases 1-5 only
    python3 chip_smoke.py --block-plans    # fused-block plan sweep
    # A/B of a kernel edit: time another tree's package with this script
    PYTHONPATH=<tree> python3 -P chip_smoke.py --timings-only

Phases, in order (any failure raises and exits non-zero):

1. the card: name and power limit from ``nvidia-smi``;
2. the build: every CUDA kernel of the main paths, from
   ``imagent_tpu_torch/csrc`` (nvcc, one process per source, all started
   together); each flash and fused-MLP kernel's registers and spill bytes
   from the ``-Xptxas -v`` log (the three D=64 flash tensor-core kernels,
   the bf16 fused-MLP forward and backward row kernels at the four
   ConvNeXt-T widths and the weight-gradient kernel must be in it and
   must not spill), and the fused block's (both instantiations of the
   bf16 tensor-core kernel must be in it and must not spill);
3. the flash kernels: ``fwd``, ``dq`` and ``dkv`` against their plain
   PyTorch versions at ViT-B/16 shapes (N=197, H=12, D=64, the smoke's
   batch) in bf16 and fp32, and at small ragged shapes for every
   supported head dim; two ``dq`` runs and two ``dkv`` runs must each be
   bitwise identical;
   q, k and v sliced from one fused (B, N, 3*H*D) projection at the
   ViT-B/16 shape, read in place (16-byte aligned) and through the
   wrapper's copy (misaligned), bitwise equal to contiguous inputs;
   timings (bf16, and the fp32 instantiations) beside SDPA as a
   yardstick, with each kernel's share of its bound;
4. the fused-MLP kernels: their shared-memory and row-tile formulas
   against the plan's; ``fwd``, ``bwd`` (bf16: the row pass and the
   weight-gradient pass) and ``reduce`` against their plain versions at
   each ConvNeXt-T width (C = 96, 192, 384, 768) at its B=64, 224 px row
   count and at a ragged row count, and at C=16 and C=200, in fp32 and
   bf16; two backward runs must be bitwise identical and the reduce
   bitwise equal to ``reduce_plain``; timings at the B=64 shapes in bf16
   (the reduce beside ``torch.sum(ws, 0)``, the forward and backward
   beside the unfused schedule of ``--fused-mlp off``: LayerNorm, cuBLAS
   addmm, GELU, addmm, layer scale and residual, and its autograd
   backward);
5. the fused-block kernel: its shared-memory formula against the plan
   rule's, for both dtypes; the kernel against ``reference_bottleneck``
   at the four ResNet-50 identity-block geometries at B=64 (56x56 C=256
   F=64, 28x28 C=512 F=128, 14x14 C=1024 F=256, 7x7 C=2048 F=512), a
   ragged shape, a 7x7 shape whose C and F are no multiples of 16 (nor
   of 8: the plain-load staging) and a ragged one whose bf16 plan splits
   each tile over a cluster of two blocks, fp32 and bf16, biases from
   N(0, 1); two bf16 runs at 56x56, at 7x7 and at the split ragged shape
   must be bitwise identical;
   timings at the four B=64 shapes in bf16 beside the plain version and
   the unfused cuDNN/cuBLAS schedule, with the tile and the grid
   (``--kernels-only`` stops here);
6. ViT-B/16 with ``attn=flash`` against ``attn=full`` on the same
   weights: fp32 logits; then bf16 logits and one backward's gradients
   of every attention parameter (``_VIT_BF16_TOL``);
7. main path 1: ``python -m imagent_tpu_torch`` in-process on ViT-B/16
   at 224 px with ``--attn flash --optimizer adamw`` (bf16, global
   batch 64, synthetic data sized for 4 train steps and one eval batch
   per epoch, 2 epochs, --save-model). The flash launch
   counters are zeroed just before and read just after: every kernel
   must have run at least 12 times per step taken;
8. main path 2: the same CLI on ConvNeXt-T at 224 px with
   ``--fused-mlp on --optimizer adamw`` (bf16, batch 64, 3 train steps
   and one eval batch per epoch, 2 epochs, --save-model). The
   plan line must fuse all 18 blocks, and the fused counters, zeroed
   just before, must read exactly 18 forward launches per train and
   eval step and 18 backward, weight-gradient and reduce launches per
   train step; then the same with ``--fused-mlp off`` (no fused launch),
   so that the two compare within one run;
9. main path 3, the system's default command: the CLI with no
   ``--arch``, so ResNet-18 at 448 px with SGD (lr 0.1, momentum 0.9, wd
   1e-4), bf16, global batch 128 (the repo's primary cell), 3 train steps
   and one eval batch per epoch, 2 epochs, --save-model;
10. main path 5, data parallelism: first one train step of ResNet-18
    (448 px, B=128, bf16, SGD) through a 1-rank NCCL group formed under
    a Slurm world of one, and the same step with no group, under
    ``cudnn.deterministic`` for this check only: params, BatchNorm
    buffers and metric vector bitwise equal, one ``pmean`` and one
    ``psum`` with the group and none without, then 5 steps of each
    timed; then main path 3's command again as a Slurm world of one
    (the ``SLURM_*`` variables and a free ``IMAGENT_COORDINATOR_PORT``
    set for that call only, restored after, no group left open): the
    banner must name a world of 1 over nccl and the collective counter,
    zeroed just before, must read exactly one ``pmean`` and one ``psum``
    per train step and one ``psum`` per eval step; the ``ddp`` line
    puts its img/s beside main path 3's;
11. main path 4: ResNet-50 at 224 px, SGD, bf16, global batch 64, 3
    train steps and one eval batch per epoch, 2 epochs, --save-model.
    Every counter is zeroed before each ResNet path and must read 0
    after it: no model path calls the fused block, as in the JAX
    package. Every train path must write its last checkpoint; whether it
    wrote a best one (only on a top-1 above 0, as in the JAX engine) is
    reported;
12. the model check: the 12 stride-1 identity bottlenecks of that trained
    ResNet-50 (its last checkpoint, after 2 epochs), eval mode, fp32,
    each block's input captured on one
    synthetic batch, its BN folded (``fold_bn``) from the trained running
    statistics and run through ``fused_bottleneck`` with the counter
    zeroed just before and reading exactly 12 after; each held to the
    block's own fp32 output (``_MODEL_TOL``) and to its float64 output;
    then the same inputs and folded weights in bf16 against
    ``reference_bottleneck`` at 3e-2, again exactly 12 launches;
13. a profile of each main path's train step (``torch.profiler``), and
    of ConvNeXt-T with ``--fused-mlp off``: host step time, device time
    per kernel group, the device's idle share;
14. the ``kernels`` JSON line, the card line, then the device JSON line
    last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# Published peaks per card (NVIDIA data sheets, dense): HBM bytes/s and
# FLOP/s for bf16 tensor-core work and for fp32 outside the tensor cores.
# Matched on the nvidia-smi name; the SXM part is the default.
_PEAKS = (
    ("H100 PCIe", {"bytes": 2.0e12, "bf16": 756e12, "fp32": 51e12}),
    ("H100 NVL", {"bytes": 3.9e12, "bf16": 835e12, "fp32": 60e12}),
    ("H100", {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12}),
)

# |kernel - plain| <= atol + rtol * |plain|. fp32: the kernels sum in
# another order than the plain einsums (fp32 rounding, ~1e-6 relative).
# bf16: both sides round an fp32 result to bf16, so they may differ by
# one bf16 ulp (2^-7 relative at worst); 1/64 allows two.
_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 1.0 / 64)}

# The fused-MLP block output and dh, elementwise. bf16: the values that
# feed each GEMM (y1, GELU(a), da) are rounded to bf16 inside the chain,
# and where the kernel's and the plain version's fp32 sums straddle a
# rounding boundary one operand differs by a bf16 ulp, which moves the
# output by up to ~1e-2; so the bound is the JAX package's own bf16 bound
# for this kernel against its reference (3e-2, tests/test_fused_mlp.py).
_FUSED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
# The fused-MLP weight and vector gradients are fp32 sums over all R
# rows; the kernel and the plain version sum them in different orders,
# so they are held normwise: max |err| <= tol * max |plain|. bf16 allows
# more: an intermediate rounded to bf16 (GELU(a), da) may land on the
# other side of a rounding boundary in one of the two.
_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-3}

_KERNELS = (
    ("flash_attention.fwd", "fwd", "imagent_tpu/ops/flash_attention.py:58"),
    ("flash_attention.dq", "dq", "imagent_tpu/ops/flash_attention.py:98"),
    ("flash_attention.dkv", "dkv", "imagent_tpu/ops/flash_attention.py:126"),
)
_SOURCE = "imagent_tpu_torch/csrc/flash_attention.cu"
_FUSED_KERNELS = (
    ("fused_mlp.fwd", "fwd", "imagent_tpu/ops/fused_mlp.py:113"),
    ("fused_mlp.bwd", "bwd", "imagent_tpu/ops/fused_mlp.py:122"),
    # the dW1 / dW2 products of the same TPU body, as a second pass
    ("fused_mlp.wgrad", "wgrad", "imagent_tpu/ops/fused_mlp.py:122"),
    # the revisited-output accumulation of the TPU backward
    ("fused_mlp.reduce", "reduce", "imagent_tpu/ops/fused_mlp.py:163"),
)
_FUSED_SOURCE = "imagent_tpu_torch/csrc/fused_mlp.cu"
_BLOCK_KERNEL = ("fused_block", "imagent_tpu/ops/fused_block.py:45")
_BLOCK_SOURCE = "imagent_tpu_torch/csrc/fused_block.cu"
# The fused block against its plain version: fp32 differs by summation
# order only; bf16 is the JAX package's own bound for this kernel
# (tests/test_fused_block.py:38): y1 and y2 are rounded to bf16 inside
# the chain, and where two fp32 sums straddle a rounding boundary an
# operand of the next product moves by a bf16 ulp.
_BLOCK_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
# The model check: the JAX package's bound for the kernel against a real
# eval-mode Bottleneck with folded BN (tests/test_fused_block.py:96), set
# there on O(1) activations. The trained smoke model in eval mode carries
# a residual stream of up to ~1,300 (running statistics from 6 steps),
# where one fp32 rounding of x + y3 is already ~1e-4 and the fp32 module
# itself sits up to 1.8e-3 from its own float64 result; so atol scales
# with the block's input, atol = 2e-4 * max(1, max |x|) (2e-4 at O(1)),
# and each block's kernel must also be within twice the fp32 module's own
# error of the float64 block output (+1e-5).
_MODEL_TOL = (2e-4, 2e-4)
# ResNet-50's identity (stride-1) bottlenecks, (H = W, C, F) per stage at
# 224 px, and how many of them each stage has (stage sizes 3/4/6/3).
_R50_BLOCKS = ((56, 256, 64), (28, 512, 128), (14, 1024, 256),
               (7, 2048, 512))
_R50_STAGES = (3, 4, 6, 3)
_RAGGED_BLOCK = (3, 9, 11, 96, 40)  # B, H, W, C, F
# C and F no multiples of 16 (nor of 8) at a 7x7 image.
_ODD_BLOCK = (2, 7, 7, 100, 36)
# Ragged W and F whose bf16 plan shares each tile between a cluster of
# two blocks (as at ResNet-50's 7x7 geometry).
_SPLIT_BLOCK = (3, 7, 9, 512, 200)
# Both instantiations of the bf16 fused-block kernel (cp.async staging,
# and plain loads for C or F off a multiple of 8): the spill gate's.
_BLOCK_TC = ("block_tc_kernel<true>", "block_tc_kernel<false>")
_VIT_SHAPE = dict(N=197, H=12, D=64)  # ViT-B/16 at 224 px: 196 patches + cls
_BATCH = 64  # global batch of the kernel and train phases
# ConvNeXt-T (depths, widths); stage i runs at 56 / 2^i px at 224 px.
_CONVNEXT_T = ((3, 3, 9, 3), (96, 192, 384, 768))
_RAGGED_ROWS = 333  # a row count that is no multiple of any row tile
# Widths off the ConvNeXt-T ladder: C=16 (K zero-padded to the mma depth,
# one 64-wide weight-gradient tile) and C=200 (a multiple of 8, not of
# 16 or 32), at small ragged row counts.
_ODD_WIDTHS = ((16, 50), (200, 77))
# The bf16 fused-MLP kernels the spill gate holds: the row kernels at the
# four ConvNeXt-T widths (NJ = C / 32) and the weight-gradient kernel.
_FUSED_TC = tuple(f"mlp_{k}_tc_kernel<{c // 32}>" for c in (96, 192, 384, 768)
                  for k in ("fwd", "bwd")) + ("mlp_wgrad_kernel",)


def _convnext_rows(stage: int, batch: int = _BATCH) -> int:
    return batch * (56 >> stage) ** 2


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _peaks(card: str) -> dict:
    for key, peaks in _PEAKS:
        if key in card:
            return peaks
    return _PEAKS[-1][1]


def _cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn`` over ``iters`` back-to-back calls.
    The start event is queued behind the warm-up calls, with no
    synchronize between: the card is busy when the timed calls begin, so
    the host's latency to the first of them (tens of microseconds through
    a Python wrapper, a few percent of a 0.1 ms kernel over 10 calls) is
    not counted, while a function whose host side cannot keep up with
    its device side still shows its full host time."""
    import torch
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _inputs(b, n, h, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, n, h, d), generator=g, device="cuda",
                        dtype=torch.float32).to(dtype) for _ in range(4)]


def _max_err(name, got, want, dtype_name, tol=_TOL) -> float:
    import torch
    atol, rtol = tol[dtype_name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max |err| {float(err.max()):.3e}")
    return float(err.max())


def _compare(fa, b, n, h, d, dtype, seed) -> dict:
    """Each kernel against its plain version on the same inputs;
    returns max |err| per kernel."""
    import torch
    dname = str(dtype).replace("torch.", "")
    q, k, v, do = _inputs(b, n, h, d, dtype, seed)
    o_k, lse_k = fa.fwd(q, k, v)
    torch.cuda.synchronize()
    o_p, lse_p = fa.fwd_plain(q, k, v)
    tag = f"B={b} N={n} H={h} D={d} {dname}"
    errs = {"fwd": max(_max_err(f"fwd O {tag}", o_k, o_p, dname),
                       _max_err(f"fwd LSE {tag}", lse_k, lse_p, "float32"))}
    di = fa.delta(do, o_p)
    dq_k = fa.dq(q, k, v, do, lse_p, di)
    dq_again = fa.dq(q, k, v, do, lse_p, di)
    torch.cuda.synchronize()
    if not torch.equal(dq_k, dq_again):
        raise AssertionError(f"dq {tag}: two runs on the same inputs differ "
                             f"(each output tile has one owner, so they "
                             f"must be bitwise identical)")
    errs["dq"] = _max_err(f"dq {tag}", dq_k,
                          fa.dq_plain(q, k, v, do, lse_p, di), dname)
    dk_k, dv_k = fa.dkv(q, k, v, do, lse_p, di)
    again = fa.dkv(q, k, v, do, lse_p, di)
    torch.cuda.synchronize()
    if not (torch.equal(dk_k, again[0]) and torch.equal(dv_k, again[1])):
        raise AssertionError(f"dkv {tag}: two runs on the same inputs "
                             f"differ (each output tile has one owner, so "
                             f"they must be bitwise identical)")
    dk_p, dv_p = fa.dkv_plain(q, k, v, do, lse_p, di)
    errs["dkv"] = max(_max_err(f"dk {tag}", dk_k, dk_p, dname),
                      _max_err(f"dv {tag}", dv_k, dv_p, dname))
    print(json.dumps({"phase": "compare", "shape": tag,
                      "kernels": _flash_kernel_names(dtype),
                      "max_abs_err": errs, "tolerance": _TOL[dname],
                      "dq_bitwise_repeat": True,
                      "dkv_bitwise_repeat": True}), flush=True)
    return errs


def _flash_kernel_names(dtype) -> dict:
    """The CUDA kernel each flash entry point launches for ``dtype``."""
    import torch
    if dtype == torch.bfloat16:
        return {"fwd": "fwd_tc_kernel", "dq": "dq_tc_kernel",
                "dkv": "dkv_tc_kernel"}
    return {"fwd": "fwd_kernel", "dq": "dq_kernel", "dkv": "dkv_kernel"}


def _fused_qkv(b, n, h, d, dtype, seed, offset):
    """q, k and v sliced from one (B, N, 3*H*D + offset) projection the
    way the ViT slices its fused QKV (``models/vit.py``), ``offset``
    elements in, and dO ``offset`` elements into a buffer of its own.
    Offset 0 keeps every pointer and stride 16-byte aligned (the kernels
    read the slices in place); offset 1 does not (the wrapper copies)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = h * d
    qkv = torch.randn((b, n, 3 * w + offset), generator=g, device="cuda",
                      dtype=torch.float32).to(dtype)
    q, k, v = (qkv[..., offset + i * w:offset + (i + 1) * w]
               .unflatten(-1, (h, d)) for i in range(3))
    buf = torch.randn(b * n * w + offset, generator=g, device="cuda",
                      dtype=torch.float32).to(dtype)
    return q, k, v, buf[offset:].view(b, n, h, d)


def _compare_fused_qkv(fa, b, n, h, d, dtype, seed, offset) -> dict:
    """Each kernel on strided fused-QKV slices (``_fused_qkv``): bitwise
    equal to the same kernel on contiguous copies, and within ``_TOL`` of
    the plain version on the slices themselves."""
    import torch
    dname = str(dtype).replace("torch.", "")
    tag = f"fused QKV offset {offset} B={b} N={n} H={h} D={d} {dname}"
    q, k, v, do = _fused_qkv(b, n, h, d, dtype, seed, offset)
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    o_p, lse_p = fa.fwd_plain(q, k, v)
    di = fa.delta(do, o_p)
    runs = {
        "fwd": (lambda q, k, v, do: fa.fwd(q, k, v), (o_p, lse_p)),
        "dq": (lambda q, k, v, do: (fa.dq(q, k, v, do, lse_p, di),),
               (fa.dq_plain(q, k, v, do, lse_p, di),)),
        "dkv": (lambda q, k, v, do: fa.dkv(q, k, v, do, lse_p, di),
                fa.dkv_plain(q, k, v, do, lse_p, di)),
    }
    errs = {}
    for key, (kern, plain) in runs.items():
        got = kern(q, k, v, do)
        ref = kern(qc, kc, vc, doc)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, ref)):
            raise AssertionError(f"{key} {tag}: differs from the same kernel "
                                 f"on contiguous copies of its inputs")
        # LSE is fp32 at either dtype
        errs[key] = max(_max_err(f"{key} {tag}", a, p,
                                 "float32" if a.dtype == torch.float32
                                 else dname)
                        for a, p in zip(got, plain))
    print(json.dumps({"phase": "compare_fused_qkv", "shape": tag,
                      "kernels": _flash_kernel_names(dtype),
                      "max_abs_err": errs, "tolerance": _TOL[dname],
                      "bitwise_equal_to_contiguous": True}), flush=True)
    return errs


def _kernel_label(mangled: str) -> str:
    """``fwd_tc_kernel<bf16,64>`` from a mangled flash entry name (the
    tensor-core kernels are bf16, the others fp32), ``mlp_bwd_tc_kernel<3>``
    from a fused-MLP one (NJ), ``block_tc_kernel<true>`` from a fused-block
    one (cp.async staging or not), the name as given when none parses."""
    m = re.search(r"(mlp_(?:fwd|bwd)_tc_kernel)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"block_tc_kernelILb([01])E", mangled)
    if m:
        return f"block_tc_kernel<{'true' if m.group(1) == '1' else 'false'}>"
    if "bottleneck_kernelIfE" in mangled:
        return "bottleneck_kernel<float>"
    if "mlp_wgrad_kernel" in mangled:
        return "mlp_wgrad_kernel"
    m = re.search(r"((?:fwd|dq|dkv)(?:_tc)?_kernel)ILi(\d+)E", mangled)
    if not m:
        return mangled
    name, d = m.groups()
    return f"{name}<{'bf16' if '_tc_' in name else 'fp32'},{d}>"


def _ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel entry from ``-Xptxas -v``."""
    report, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = report.setdefault(_kernel_label(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return report


def _timings(fa, b, peaks) -> dict:
    """Kernel, plain and SDPA times at the main path's shape (bf16), and
    each kernel's bound: the larger of its bytes (inputs read once,
    outputs written once) over HBM bandwidth and its flops over the bf16
    peak."""
    import torch
    import torch.nn.functional as F
    n, h, d = _VIT_SHAPE["N"], _VIT_SHAPE["H"], _VIT_SHAPE["D"]
    q, k, v, do = _inputs(b, n, h, d, torch.bfloat16, 7)
    o, lse = fa.fwd_plain(q, k, v)
    di = fa.delta(do, o)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    qt.requires_grad_(True)
    kt.requires_grad_(True)
    vt.requires_grad_(True)
    with torch.no_grad():
        lib_fwd = _cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    lib_bwd = _cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))

    tensor = b * n * h * d * 2   # one bf16 (B, N, H, D) tensor
    stats = b * h * n * 4        # one fp32 (B, H, N) row statistic
    mm = 2 * b * h * n * n * d   # flops of one N x N x D product
    work = {"fwd": (4 * tensor + stats, 2 * mm),
            "dq": (5 * tensor + 2 * stats, 3 * mm),
            "dkv": (6 * tensor + 2 * stats, 4 * mm)}
    runs = {
        "fwd": (lambda: fa.fwd(q, k, v), lambda: fa.fwd_plain(q, k, v),
                lib_fwd),
        "dq": (lambda: fa.dq(q, k, v, do, lse, di),
               lambda: fa.dq_plain(q, k, v, do, lse, di), lib_bwd),
        "dkv": (lambda: fa.dkv(q, k, v, do, lse, di),
                lambda: fa.dkv_plain(q, k, v, do, lse, di), lib_bwd),
    }
    out_t = {}
    for key, (kern, plain, lib_ms) in runs.items():
        nbytes, flops = work[key]
        t_bytes = nbytes / peaks["bytes"] * 1e3
        t_ops = flops / peaks["bf16"] * 1e3
        out_t[key] = {"ms": _cuda_ms(kern), "plain_ms": _cuda_ms(plain, 3, 1),
                      "library_ms": lib_ms,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "bytes": nbytes, "flops": flops}
        out_t[key]["bound_share"] = out_t[key]["bound_ms"] / out_t[key]["ms"]
    # The fp32 instantiations (--no-bf16) on the same values: time only.
    q, k, v, do, lse, di = (x.float() for x in (q, k, v, do, lse, di))
    for key, fn in (("fwd", lambda: fa.fwd(q, k, v)),
                    ("dq", lambda: fa.dq(q, k, v, do, lse, di)),
                    ("dkv", lambda: fa.dkv(q, k, v, do, lse, di))):
        out_t[key]["fp32_ms"] = _cuda_ms(fn)
    return out_t


def _ab_timings(fa, fm, fb, peaks, card) -> None:
    """``--timings-only``: the flash kernels (bf16, with their fp32
    instantiations and SDPA), the fused-MLP kernels per ConvNeXt-T
    width (the reduce beside ``torch.sum``) and per step, and the bf16
    fused block per ResNet-50 geometry beside the unfused schedule,
    timed by this script's own functions whichever package is
    imported."""
    flash = _timings(fa, _BATCH, peaks)
    per_width = _fused_timings(fm, peaks, card)
    steps = _fused_step_totals(per_width)
    block = _block_timings(fb, peaks, card)
    print(json.dumps({
        "phase": "ab_timings", "package": os.path.dirname(fa.__file__),
        "card": card,
        "flash": {k: {f: t[f] for f in ("ms", "fp32_ms", "library_ms",
                                        "bound_ms", "bound_share")}
                  for k, t in flash.items()},
        "reduce_per_width": {c: {"ms": w["reduce"]["ms"],
                                 "torch_sum_ms": w["reduce"]["library_ms"],
                                 "bound_ms": w["reduce"]["bound_ms"]}
                             for c, w in per_width.items()},
        "fused_per_width_ms": {c: {k: t["ms"] for k, t in w.items()}
                               for c, w in per_width.items()},
        "fused_step_ms": {k: t["ms"] for k, t in steps.items()},
        "unfused_schedule_step_ms": {k: steps[k]["unfused_schedule_ms"]
                                     for k in ("fwd", "bwd")},
        "reduce_step": steps["reduce"],
        "block_ms": {f"{hw}x{hw}": t["ms"] for (hw, _, _), t in block.items()},
        "block_unfused_ms": {f"{hw}x{hw}": t["library_ms"]
                             for (hw, _, _), t in block.items()},
        "block_total_ms": sum(t["ms"] for t in block.values())}),
        flush=True)


def _norm_err(name, got, want, dtype_name) -> tuple:
    """``(max |got - want|, that over max |want|)``; the ratio, the
    normwise error, is held to ``_GRAD_TOL``."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    ratio = err / float(want.abs().max())
    if ratio > _GRAD_TOL[dtype_name]:
        raise AssertionError(f"{name}: max |err| / max |plain| "
                             f"{ratio:.3e} > {_GRAD_TOL[dtype_name]}")
    return err, ratio


def _fused_compare(fm, c, rows, dtype, seed) -> dict:
    """fwd, bwd + reduce and reduce alone against their plain versions
    on the same inputs, and a bitwise-identical second backward. Returns
    the max |err| of the block output (``fwd``), of dh (``bwd``) and of
    the reduced slots (``reduce``), and the normwise error
    (``_norm_err``) of the worst weight or vector gradient
    (``bwd_grads``)."""
    import torch
    dname = str(dtype).replace("torch.", "")
    *fwd_args, dout = fm.block_inputs(c, rows, dtype, seed)
    bwd_args = fwd_args[1:] + [dout]
    tag = f"C={c} R={rows} {dname}"
    out_k = fm.fwd(*fwd_args)
    torch.cuda.synchronize()
    errs = {"fwd": _max_err(f"fused fwd {tag}", out_k,
                            fm.fwd_plain(*fwd_args), dname, _FUSED_TOL)}
    dh_k, ws = fm.bwd_partials(*bwd_args)
    flat = fm.reduce_partials(ws)
    torch.cuda.synchronize()
    # The kernel adds the slots in reduce_plain's order: bitwise equal,
    # on the workspace (16-byte loads) and on an odd column count of its
    # first slots (the scalar path).
    odd = ws[:8, :-1].contiguous()
    for what, got_r, ws_r in (("", flat, ws),
                              (" odd columns", fm.reduce_partials(odd), odd)):
        want_r = fm.reduce_plain(ws_r)
        if not torch.equal(got_r.view(torch.int32), want_r.view(torch.int32)):
            raise AssertionError(
                f"fused reduce {tag}{what}: not bitwise equal to reduce_plain"
                f" (max |err| {float((got_r - want_r).abs().max()):.3e})")
    del odd
    errs["reduce"] = 0.0
    got = (dh_k, *fm.split_grads(flat, c))
    again = fm.bwd(*bwd_args)
    torch.cuda.synchronize()
    want = fm.bwd_plain(*bwd_args)
    names = ("dh", "dw1", "db1", "dw2", "dgamma", "dls", "dlb")
    errs["bwd"] = _max_err(f"fused bwd dh {tag}", got[0], want[0], dname,
                           _FUSED_TOL)
    errs["bwd_grads"] = max(_norm_err(f"fused bwd {name} {tag}", g, w,
                                      dname)[1]
                            for name, g, w in zip(names[1:], got[1:],
                                                  want[1:]))
    identical = all(torch.equal(g, a) for g, a in zip(got, again))
    if not identical:
        raise AssertionError(f"fused bwd {tag}: two runs differ")
    print(json.dumps({"phase": "fused_compare", "shape": tag,
                      "errors": errs, "bitwise_repeat": identical,
                      "tolerance": _fused_tol(dname)}), flush=True)
    return errs


def _fused_tol(dname) -> dict:
    """Each entry of ``_fused_compare``'s errors beside its tolerance."""
    atol, rtol = _FUSED_TOL[dname]
    elementwise = f"|err| <= {atol} + {rtol} * |plain|"
    grads = f"max |err| / max |plain| <= {_GRAD_TOL[dname]}"
    return {"fwd": elementwise, "bwd": elementwise, "bwd_grads": grads,
            "wgrad": grads, "reduce": "bitwise equal to reduce_plain"}


def _bound(nbytes, flops, peak_flops, peaks) -> dict:
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes": nbytes,
            "flops": flops, "t_bytes_ms": t_bytes, "t_ops_ms": t_ops}


def _unfused_mlp(resid, h, ls, lb, w1, b1, w2, b2, gamma):
    """The ``--fused-mlp off`` block tail of ``models/convnext.py`` in
    h's dtype: LayerNorm with fp32 statistics, cuBLAS addmm, GELU, addmm,
    layer scale and the residual (the yardstick of the fused kernels;
    the port never calls it)."""
    import torch
    import torch.nn.functional as F
    c = h.shape[-1]
    y = F.layer_norm(h.float(), (c,), ls.float(), lb.float(),
                     1e-6).to(h.dtype)
    y = F.gelu(torch.addmm(b1, y, w1))
    return resid + torch.addmm(b2, y, w2) * gamma


def _fused_timings(fm, peaks, card) -> dict:
    """Each fused kernel at each ConvNeXt-T width at its B=64 shape in
    bf16: kernel, plain and (reduce only) library times and the bound,
    the larger of bytes (inputs read once, outputs written once) over
    HBM bandwidth and flops over the peak for their type. The backward
    (``bwd``: the whole backward before the reduce, both passes in bf16)
    has the bound of the function, dh and the gradients from h, dout and
    the weights: the partial-sum workspace and the bf16 design's
    intermediates exist only because of the design, so their bytes are
    reported beside the bound (``workspace_bytes``, ``workspace_write_ms``,
    ``intermediate_bytes``), not in it, as is the weight-gradient pass
    alone (``wgrad_ms``). The weight-gradient kernel (``wgrad``) also
    gets a row of its own, bound by its own work: the intermediates read
    and the workspace written, 16 R C^2 flops. No single PyTorch call
    computes the fused block or its backward, so their library_ms is
    null and the unfused ``--fused-mlp off`` schedule stands beside them
    (``unfused_schedule_ms``: its forward, and its autograd backward);
    the reduce's library_ms is ``torch.sum`` over the slots. Works on a
    package without the weight-gradient pass too (the A/B's parent)."""
    import torch
    two_pass = hasattr(fm, "wgrad_partials")
    per_width = {}
    for stage, c in enumerate(_CONVNEXT_T[1]):
        rows = _convnext_rows(stage)
        *fwd_args, dout = fm.block_inputs(c, rows, torch.bfloat16, 7 + c)
        bwd_args = fwd_args[1:] + [dout]
        _, ws = fm.bwd_partials(*bwd_args)
        slots, slot = ws.shape
        item = 2
        io = rows * c * item
        weights = (8 * c * c + 8 * c) * item
        grads = fm.slot_floats(c) * 4  # fp32 dW1, dW2, db1, dgamma, dls, dlb
        work = {
            "fwd": _bound(3 * io + weights, 16 * rows * c * c,
                          peaks["bf16"], peaks),
            "bwd": _bound(3 * io + weights + grads, 48 * rows * c * c,
                          peaks["bf16"], peaks),
            "reduce": _bound((slots + 1) * slot * 4, slots * slot,
                             peaks["fp32"], peaks),
        }
        runs = {
            "fwd": (lambda: fm.fwd(*fwd_args),
                    lambda: fm.fwd_plain(*fwd_args), None),
            "bwd": (lambda: fm.bwd_partials(*bwd_args),
                    lambda: fm.bwd_plain(*bwd_args), None),
            "reduce": (lambda: fm.reduce_partials(ws),
                       lambda: fm.reduce_plain(ws),
                       lambda: torch.sum(ws, 0)),
        }
        if two_pass:
            _, inter = fm.bwd_rows(*bwd_args)
            inter_bytes = sum(t.numel() * t.element_size() for t in inter)
            vec = inter[-1]
            work["wgrad"] = _bound(inter_bytes + slots * slot * 4,
                                   16 * rows * c * c, peaks["bf16"], peaks)
            y1c, doc, gac, dac = (t.float() for t in inter[:4])
            runs["wgrad"] = (lambda: fm.wgrad_partials(inter),
                             lambda: (y1c.t() @ dac, gac.t() @ doc,
                                      vec.sum(0)), None)
        # The unfused schedule: forward, and its autograd backward.
        leaves = [t.detach().requires_grad_(True) for t in fwd_args]
        with torch.no_grad():
            unfused_fwd = _cuda_ms(lambda: _unfused_mlp(*fwd_args))
        graph = _unfused_mlp(*leaves)
        unfused_bwd = _cuda_ms(lambda: torch.autograd.grad(
            graph, leaves[1:], dout, retain_graph=True))
        del graph, leaves
        per_width[c] = {}
        for key, (kern, plain, lib) in runs.items():
            t = dict(work[key])
            t["ms"] = _cuda_ms(kern)
            t["plain_ms"] = _cuda_ms(plain, 3, 1)
            t["library_ms"] = _cuda_ms(lib) if lib else None
            t["bound_by"] = ("bytes" if t["t_bytes_ms"] >= t["t_ops_ms"]
                             else "operations")
            if key in ("fwd", "bwd"):
                t["unfused_schedule_ms"] = (unfused_fwd if key == "fwd"
                                            else unfused_bwd)
            if key == "bwd":
                t["workspace_bytes"] = slots * slot * 4
                t["workspace_write_ms"] = (t["workspace_bytes"]
                                           / peaks["bytes"] * 1e3)
                if two_pass:
                    t["intermediate_bytes"] = inter_bytes
            per_width[c][key] = t
        if two_pass:
            per_width[c]["bwd"]["wgrad_ms"] = per_width[c]["wgrad"]["ms"]
            del inter, y1c, doc, gac, dac, vec
        for key, t in per_width[c].items():
            print(json.dumps({"phase": "fused_kernel", "name":
                              f"fused_mlp.{key}", "card": card,
                              "shape": f"C={c} R={rows} bf16",
                              "splits": slots, **t}), flush=True)
        del ws
        torch.cuda.empty_cache()
    return per_width


def _fused_step_totals(per_width) -> dict:
    """Each fused kernel's numbers summed over the 18 blocks of one
    ConvNeXt-T train step (depth x the width's launch): ms, plain_ms,
    library_ms, bound_ms (the sum of each launch's own bound) and the
    kind that dominates that bound; for the forward and backward also
    the unfused schedule; for the backward its workspace's bytes and
    their time at HBM rate, the intermediates' bytes and the
    weight-gradient pass, beside the bound."""
    out = {}
    extra = {"fwd": ("unfused_schedule_ms",),
             "bwd": ("unfused_schedule_ms", "workspace_bytes",
                     "workspace_write_ms", "intermediate_bytes",
                     "wgrad_ms")}
    for key in per_width[_CONVNEXT_T[1][0]]:
        sums = ("ms", "plain_ms", "bound_ms") + tuple(
            k for k in extra.get(key, ())
            if k in per_width[_CONVNEXT_T[1][0]][key])
        tot = {"t_bytes": 0.0, "t_ops": 0.0, "library_ms": 0.0,
               **{k: 0.0 for k in sums}}
        for depth, c in zip(*_CONVNEXT_T):
            t = per_width[c][key]
            for k in sums:
                tot[k] += depth * t[k]
            tot["t_bytes"] += depth * t["t_bytes_ms"]
            tot["t_ops"] += depth * t["t_ops_ms"]
            if t["library_ms"] is None:
                tot["library_ms"] = None
            elif tot["library_ms"] is not None:
                tot["library_ms"] += depth * t["library_ms"]
        tot["bound_by"] = ("bytes" if tot.pop("t_bytes") >= tot.pop("t_ops")
                           else "operations")
        out[key] = tot
    return out


def _block_inputs(b, h, w, c, f, dtype, seed):
    """``[x, w1, b1, w3, b3, wc, bc]`` of one fused block: x from N(0, 1),
    the weights scaled by fan-in (x's dtype), the biases from N(0, 1) in
    fp32, so relu(b1) at a pixel outside the image would show."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x, w1, w3, wc = (mk(b, h, w, c), mk(c, f, scale=c ** -0.5),
                     mk(3, 3, f, f, scale=(9 * f) ** -0.5),
                     mk(f, c, scale=f ** -0.5))
    b1, b3, bc = mk(f), mk(f), mk(c)
    return [x.to(dtype), w1.to(dtype), b1, w3.to(dtype), b3, wc.to(dtype),
            bc]


def _block_err(name, got, want, tol) -> float:
    """max |got - want|, held elementwise to ``tol`` = (atol, rtol)."""
    import torch
    atol, rtol = tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max |err| {float(err.max()):.3e}")
    return float(err.max())


def _block_tile(fb, b, h, w, c, f, dtype, device) -> dict:
    """The launch ``fused_bottleneck`` makes: the output tile, the
    blocks per tile and the grid, and (bf16) each step's warps across
    the columns, from ``fb.tile`` where the package has it (a tree
    before the bf16 tensor-core kernel planned one tile rule for both
    dtypes, ``fb.plan``, one block a tile)."""
    if hasattr(fb, "tile"):
        th, tw, split, wn = fb.tile(b, h, w, c, f, dtype, device)
    else:
        (th, tw), split, wn = fb.plan(h, w, f, device), 1, None
    return {"tile": [th, tw], "blocks_per_tile": split,
            "grid": b * -(-h // th) * -(-w // tw) * split,
            "warps_n": list(wn) if wn and wn[0] else None}


def _block_compare(fb, shape, dtype, seed, repeat=False) -> float:
    """The kernel against ``reference_bottleneck`` on the same inputs;
    with ``repeat``, a second launch must be bitwise identical."""
    import torch
    b, h, w, c, f = shape
    dname = str(dtype).replace("torch.", "")
    args = _block_inputs(b, h, w, c, f, dtype, seed)
    got = fb.fused_bottleneck(*args)
    again = fb.fused_bottleneck(*args) if repeat else None
    torch.cuda.synchronize()
    tag = f"B={b} {h}x{w} C={c} F={f} {dname}"
    if repeat and not torch.equal(got, again):
        raise AssertionError(f"fused_block {tag}: two runs differ in "
                             f"{int((got != again).sum())} elements")
    err = _block_err(f"fused_block {tag}", got,
                     fb.reference_bottleneck(*args), _BLOCK_TOL[dname])
    atol, rtol = _BLOCK_TOL[dname]
    print(json.dumps({"phase": "block_compare", "shape": tag,
                      **_block_tile(fb, b, h, w, c, f, dtype, got.device),
                      "max_abs_err": err,
                      "tolerance": f"|err| <= {atol} + {rtol} * |plain|",
                      **({"bitwise_repeat": True} if repeat else {})}),
          flush=True)
    return err


def _unfused_schedule(x, w1, b1, w3_oihw, b3, wc, bc):
    """The unfused cuDNN/cuBLAS schedule in x's dtype, channels-last:
    1x1 as addmm, 3x3 conv2d, 1x1 addmm + residual (the yardstick the JAX
    package's own benchmark used, ``benchmarks/fused_block.py``)."""
    import torch
    import torch.nn.functional as F
    b, h, w, c = x.shape
    f = w1.shape[1]
    dt = x.dtype
    y = torch.relu(torch.addmm(b1.to(dt), x.reshape(-1, c), w1))
    y = F.conv2d(y.view(b, h, w, f).permute(0, 3, 1, 2), w3_oihw,
                 b3.to(dt), padding=1)
    y = torch.relu(y).permute(0, 2, 3, 1).reshape(-1, f)
    y = torch.addmm(bc.to(dt), y, wc) + x.reshape(-1, c)
    return torch.relu(y).view(b, h, w, c)


def _block_timings(fb, peaks, card) -> dict:
    """The kernel, its plain version and the unfused cuDNN/cuBLAS
    schedule at each ResNet-50 identity geometry at B=64 in bf16, and the
    bound: max(bytes / HBM rate, flops / bf16 peak), bytes = x read, out
    written, the weights and biases read once; flops = 2 B H W (2 C F +
    9 F^2); with the tile and the grid (blocks) it launched."""
    import torch
    out = {}
    for hw, c, f in _R50_BLOCKS:
        args = _block_inputs(_BATCH, hw, hw, c, f, torch.bfloat16, 11 + c)
        x, w1, b1, w3, b3, wc, bc = args
        w3_oihw = w3.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        pixels = _BATCH * hw * hw
        nbytes = (2 * pixels * c + c * f + 9 * f * f + f * c) * 2 \
            + (2 * f + c) * 4
        t = _bound(nbytes, 2 * pixels * (2 * c * f + 9 * f * f),
                   peaks["bf16"], peaks)
        t["ms"] = _cuda_ms(lambda: fb.fused_bottleneck(*args))
        t["plain_ms"] = _cuda_ms(lambda: fb.reference_bottleneck(*args), 3, 1)
        t["library_ms"] = _cuda_ms(lambda: _unfused_schedule(
            x, w1, b1, w3_oihw, b3, wc, bc))
        t["bound_by"] = ("bytes" if t["t_bytes_ms"] >= t["t_ops_ms"]
                         else "operations")
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t.update(_block_tile(fb, _BATCH, hw, hw, c, f, torch.bfloat16,
                             x.device))
        out[(hw, c, f)] = t
        print(json.dumps({"phase": "block_kernel", "name": "fused_block",
                          "card": card,
                          "shape": f"B={_BATCH} {hw}x{hw} C={c} F={f} bf16",
                          "library": "unfused cuDNN/cuBLAS bf16 schedule "
                                     "(addmm, conv2d, addmm)", **t}),
              flush=True)
    return out


# --block-plans: forced launches of the bf16 fused block per ResNet-50
# geometry, (th, tw, blocks per tile, warps across the columns in steps
# 1, 2, 3); the planned launch is timed beside them.
_BLOCK_PLANS = {
    56: ((14, 28, 1, (2, 2, 8)), (14, 28, 1, (2, 2, 2)),
         (14, 28, 1, (2, 2, 4)), (14, 14, 1, (2, 2, 8))),
    28: ((14, 14, 1, (4, 4, 8)), (14, 14, 1, (4, 4, 4)),
         (14, 14, 1, (4, 2, 8)), (14, 14, 1, (2, 2, 2)),
         (14, 14, 2, (4, 4, 8)), (7, 14, 1, (4, 4, 8))),
    14: ((7, 14, 1, (8, 8, 8)), (7, 14, 1, (4, 4, 4)),
         (7, 14, 1, (4, 4, 8)), (7, 14, 1, (2, 2, 2)),
         (7, 14, 2, (8, 8, 8)), (7, 7, 1, (8, 8, 8))),
    7: ((7, 7, 2, (8, 8, 8)), (7, 7, 2, (4, 4, 4)), (7, 7, 2, (8, 4, 4)),
        (7, 7, 2, (2, 2, 2)), (4, 7, 1, (8, 8, 8)), (7, 7, 1, (8, 8, 8))),
}


def _block_plans(fb, card) -> None:
    """``--block-plans``: the bf16 fused block at each ResNet-50 identity
    geometry (B=64) at forced launches and at the planned one, each held
    to the plain version and timed beside the plan model's terms
    (``fb.tc_terms``: waves, warp steps, KB staged, passes); then the
    least-squares fit of the model's three weights to all these times
    (how ``TC_STEP_NS``, ``TC_KB_NS`` and ``TC_PASS_NS`` are set) and its
    worst relative error."""
    import numpy as np
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    terms, times = [], []
    for hw, c, f in _R50_BLOCKS:
        args = _block_inputs(_BATCH, hw, hw, c, f, torch.bfloat16, 11 + c)
        want = fb.reference_bottleneck(*args)
        planned = fb.plan_tc(_BATCH, hw, hw, c, f, args[0].device)
        plans = [fb.TcPlan(th, tw, s, wn)
                 for th, tw, s, wn in _BLOCK_PLANS[hw]]
        plans += [planned] if planned not in plans else []
        for plan in plans:
            tag = f"fused_block {hw}x{hw} at {tuple(plan)}"
            _block_err(tag, fb.launch(plan, *args), want,
                       _BLOCK_TOL["bfloat16"])
            ms = _cuda_ms(lambda: fb.launch(plan, *args))
            waves, steps, kb, passes = fb.tc_terms(_BATCH, hw, hw, c, f,
                                                   plan, sms)
            terms.append([waves * steps, waves * kb, waves * passes])
            times.append(ms * 1e6)
            print(json.dumps({"phase": "block_plan", "card": card,
                              "shape": f"B={_BATCH} {hw}x{hw} C={c} F={f}",
                              "plan": list(plan), "planned": plan == planned,
                              "ms": ms, "waves": waves, "warp_steps": steps,
                              "kb": kb, "passes": passes}), flush=True)
    a, t = np.array(terms), np.array(times)
    coef = np.linalg.lstsq(a, t, rcond=None)[0]
    used = np.array([fb.TC_STEP_NS, fb.TC_KB_NS, fb.TC_PASS_NS])
    print(json.dumps({
        "phase": "block_plan_fit", "card": card, "points": len(t),
        "fit_ns": {"step": coef[0], "kb": coef[1], "pass": coef[2]},
        "fit_max_rel_err": float(np.max(np.abs(a @ coef - t) / t)),
        "plan_ns": {"step": used[0], "kb": used[1], "pass": used[2]},
        "plan_max_rel_err": float(np.max(np.abs(a @ used - t) / t))}),
        flush=True)


def _identity_blocks(model):
    """The stride-1 identity bottlenecks of a ResNet-50: j > 0 of every
    stage."""
    return [getattr(model, f"layer{i + 1}_block{j}")
            for i, n in enumerate(_R50_STAGES) for j in range(1, n)]


def _folded(block):
    """``(w1, b1, w3, b3, wc, bc)`` of an eval-mode Bottleneck with each
    BN folded into its conv (``fold_bn``) from its running statistics:
    w1 (C, F), w3 (3, 3, F, F) HWIO, wc (F, C)."""
    from imagent_tpu_torch.ops.fused_block import fold_bn

    def fold(conv, bn, kernel):
        return fold_bn(kernel, bn.weight, bn.bias, bn.running_mean,
                       bn.running_var)
    w1, b1 = fold(block.Conv_0, block.BatchNorm_0,
                  block.Conv_0.weight[:, :, 0, 0].t())
    w3, b3 = fold(block.Conv_1, block.BatchNorm_1,
                  block.Conv_1.weight.permute(2, 3, 1, 0))
    wc, bc = fold(block.Conv_2, block.BatchNorm_2,
                  block.Conv_2.weight[:, :, 0, 0].t())
    return [t.detach().contiguous() for t in (w1, b1, w3, b3, wc, bc)]


def _block_model_check(fb, trained_state, batch: int) -> dict:
    """The fused kernel against the 12 identity bottlenecks of the
    trained ResNet-50 (``trained_state``: its last checkpoint, after 2
    epochs), eval mode, fp32: each block's
    input and output captured by forward hooks on one synthetic batch,
    its BN folded from the trained running statistics; exactly 12
    launches; held to the block's fp32 output (``_MODEL_TOL``) and to its
    float64 output. Then bf16: the same inputs and folded weights cast to
    bf16, the kernel against ``reference_bottleneck`` (and, for the
    record only, against the fp32 module output)."""
    import torch
    from imagent_tpu_torch.models import create_model
    from imagent_tpu_torch.train import make_input_prep
    model = create_model("resnet50", 1000, bf16=False).cuda().eval()
    model.load_state_dict(trained_state, strict=True)
    blocks = _identity_blocks(model)
    seen = {}
    hooks = [blk.register_forward_hook(
        lambda m, inp, out, k=k: seen.__setitem__(k, (inp[0], out)))
        for k, blk in enumerate(blocks)]
    g = torch.Generator().manual_seed(9)
    images = torch.randint(0, 256, (batch, 224, 224, 3), generator=g,
                           dtype=torch.uint8).cuda()
    with torch.no_grad():
        model(make_input_prep((0.5,) * 3, (0.5,) * 3)(images))
    for h in hooks:
        h.remove()
    if len(seen) != 12:
        raise AssertionError(f"captured {len(seen)} identity blocks, not 12")
    weights = [_folded(blk) for blk in blocks]
    scales = [max(1.0, float(seen[k][0].abs().max())) for k in range(12)]
    fb.reset_launches()
    errs, got32 = [], []
    for k in range(12):
        x, want = seen[k]
        got = fb.fused_bottleneck(x, *weights[k])
        errs.append(_block_err(f"ResNet-50 identity block {k} fp32", got,
                               want, (_MODEL_TOL[0] * scales[k],
                                      _MODEL_TOL[1])))
        got32.append(got)
    torch.cuda.synchronize()
    vs_exact, module_vs_exact = [], []
    for k, blk in enumerate(blocks):  # the float64 block: the exact answer
        x, want = seen[k]
        with torch.no_grad():
            exact = copy.deepcopy(blk).double()(x.double())
        vs_exact.append(float((got32[k].double() - exact).abs().max()))
        module_vs_exact.append(float((want.double() - exact).abs().max()))
        if vs_exact[k] > 2 * module_vs_exact[k] + 1e-5:
            raise AssertionError(
                f"ResNet-50 identity block {k}: kernel {vs_exact[k]:.3e} "
                f"from the float64 block, more than twice the fp32 "
                f"module's {module_vs_exact[k]:.3e} (+1e-5)")
    del got32
    launches = fb.LAUNCHES["fused_block"]
    if launches != 12:
        raise AssertionError(f"fused_block launched {launches} times for "
                             "12 blocks")
    fb.reset_launches()
    bf_errs, vs_module = [], []
    for k in range(12):
        x, want = seen[k]
        args = [x.bfloat16()] + [t.bfloat16() if i % 2 == 0 else t
                                 for i, t in enumerate(weights[k])]
        got = fb.fused_bottleneck(*args)
        atol, rtol = _BLOCK_TOL["bfloat16"]
        bf_errs.append(_block_err(f"ResNet-50 identity block {k} bf16", got,
                                  fb.reference_bottleneck(*args),
                                  (atol * scales[k], rtol)))
        vs_module.append(float((got.float() - want).abs().max()))
    torch.cuda.synchronize()
    if fb.LAUNCHES["fused_block"] != 12:
        raise AssertionError(f"bf16 fused_block launched "
                             f"{fb.LAUNCHES['fused_block']} times for 12 "
                             "blocks")
    res = {"phase": "block_model_check", "blocks": 12,
           "launches_fp32": launches,
           "launches_bf16": fb.LAUNCHES["fused_block"],
           "max_abs_input": scales,
           "max_abs_err_fp32": errs, "tolerance_fp32":
               f"|err| <= {_MODEL_TOL[0]} * max(1, max|x|) + "
               f"{_MODEL_TOL[1]} * |module|",
           "fp32_vs_float64_block": vs_exact,
           "fp32_module_vs_float64_block": module_vs_exact,
           "tolerance_vs_float64": "kernel <= 2 * module + 1e-5",
           "max_abs_err_bf16": bf_errs, "tolerance_bf16":
               "|err| <= 0.03 * max(1, max|x|) + 0.03 * |plain bf16|",
           "bf16_vs_fp32_module_max_abs_err": vs_module,
           "max_abs_module_output": [float(seen[k][1].abs().max())
                                     for k in range(12)]}
    print(json.dumps(res), flush=True)
    return res


def _vit_check(fa) -> None:
    """ViT-B/16 fp32 logits with attn=flash (the kernels) against
    attn=full (plain attention) on the same random weights."""
    import torch
    from imagent_tpu_torch.models import create_model
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (2, 224, 224, 3), generator=g,
                      dtype=torch.uint8).cuda().float() / 255.0
    full = create_model("vit_b16", 1000, bf16=False, attn_impl="full",
                        generator=torch.Generator().manual_seed(0)).cuda()
    flash = create_model("vit_b16", 1000, bf16=False, attn_impl="flash",
                         generator=torch.Generator().manual_seed(1)).cuda()
    flash.load_state_dict(full.state_dict())
    with torch.no_grad():
        want = full(x)
        got = flash(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-3 * float(want.abs().max()) + 1e-4
    print(json.dumps({"phase": "vit_logits", "max_abs_err": err,
                      "tolerance": tol}), flush=True)
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"ViT-B/16 flash vs full logits: max |err| "
                             f"{err:.3e} > {tol:.3e}")


# The bf16 ViT-B/16 check, flash against full attention on the same
# weights: the logits and one backward's gradient of every attention
# parameter, each held normwise, max |flash - full| <= tol * max |full|.
# The kernels' own bf16 bound is two bf16 ulps of each element (rtol 1/64
# in _TOL); in the model, every layer's attention output may differ by
# that much, and the difference is carried through 12 layers of bf16
# activations, GEMMs and LayerNorms (full attention itself rounds P to
# bf16, the kernels split it), so the model-level bound is twice the
# kernel's, 1/32, over the tensor's largest magnitude. Chosen before the
# check's first run on the card.
_VIT_BF16_TOL = 1.0 / 32


def _vit_bf16_check(fa) -> dict:
    """ViT-B/16 in bf16 with attn=flash (the tensor-core kernels: the
    smoke's first run of them inside a model) against attn=full on the
    same random weights and images: logits, and the gradients of a
    cross-entropy loss with respect to each block's in_proj and out_proj
    parameters. The distance of both to the fp32 full model is reported
    beside it (the bf16 model's own rounding, for scale)."""
    import torch
    import torch.nn.functional as F
    from imagent_tpu_torch.models import create_model
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (2, 224, 224, 3), generator=g,
                      dtype=torch.uint8).cuda().float() / 255.0
    labels = torch.randint(0, 1000, (2,), generator=g).cuda()
    weights = None

    def run(attn, bf16):
        nonlocal weights
        model = create_model("vit_b16", 1000, bf16=bf16, attn_impl=attn,
                             generator=torch.Generator().manual_seed(0))
        model = model.cuda()
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        logits = model(x)
        params = {k: p for k, p in model.named_parameters()
                  if ".self_attention." in k}
        grads = torch.autograd.grad(F.cross_entropy(logits, labels),
                                    list(params.values()))
        torch.cuda.synchronize()
        return {"logits": logits.detach().float(), **dict(zip(params, grads))}

    full = run("full", True)
    fa.reset_launches()
    flash = run("flash", True)
    launches = dict(fa.LAUNCHES)
    ref = run("full", False)
    if any(n < 12 for n in launches.values()):
        raise AssertionError(f"bf16 ViT-B/16 flash check launched {launches}"
                             f"; expected >= 12 of each kernel")

    def norm_err(a, b):
        return float((a - b).abs().max() / b.abs().max())
    errs = {}
    for name, want in full.items():
        got = flash[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"bf16 ViT-B/16 flash {name}: non-finite")
        errs[name] = norm_err(got, want)
    worst = max((k for k in errs if k != "logits"), key=errs.get)
    res = {"phase": "vit_bf16", "batch": 2, "launches": launches,
           "logits_norm_err": errs["logits"],
           "grads_worst_norm_err": errs[worst], "grads_worst": worst,
           "grads_checked": len(errs) - 1,
           "tolerance": f"max |flash - full| <= {_VIT_BF16_TOL} * max |full|"
                        " (logits and each attention parameter's gradient)",
           "full_bf16_vs_fp32": {
               "logits": norm_err(full["logits"], ref["logits"]),
               "grads_worst": max(norm_err(full[k], ref[k])
                                  for k in errs if k != "logits")},
           "flash_bf16_vs_fp32": {
               "logits": norm_err(flash["logits"], ref["logits"]),
               "grads_worst": max(norm_err(flash[k], ref[k])
                                  for k in errs if k != "logits")}}
    print(json.dumps(res), flush=True)
    bad = {k: v for k, v in errs.items() if v > _VIT_BF16_TOL}
    if bad:
        raise AssertionError(f"bf16 ViT-B/16 flash vs full: normwise errors "
                             f"above {_VIT_BF16_TOL}: {bad}")
    return res


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out = out
        self.parts = []

    def write(self, s):
        self.out.write(s)
        self.parts.append(s)
        return len(s)

    def flush(self):
        self.out.flush()


_ADAMW_224 = ["--optimizer", "adamw", "--lr", "1e-4", "--weight-decay",
              "0.05", "--image-size", "224"]


def _train(arch, argv, counters, batch: int, epochs: int, steps: int,
           workers: int = 4, keep_last: bool = False) -> dict:
    """A main path through the CLI entry point with ``argv`` (the arch,
    optimizer and image-size flags; synthetic data for ``steps`` train
    steps per epoch is added here), its launch counters (``counters``:
    modules with ``LAUNCHES``/``reset_launches``) zeroed just before and
    read just after; returns its numbers, and with ``keep_last`` also the
    last checkpoint's model state_dict (on the card): the state after the
    run's last epoch. The last checkpoint must exist; a best one is
    written only when top-1 improves on 0 (as in the JAX engine), which
    random weights over 1000 classes need not do, so whether it exists
    is reported, not required."""
    import torch
    from imagent_tpu_torch.__main__ import main
    last_state = None
    with tempfile.TemporaryDirectory() as tmp:
        argv = [*argv, "--num-classes", "1000", "--dataset", "synthetic",
                "--batch-size", str(batch),
                "--synthetic-size", str(batch * steps),
                "--epochs", str(epochs), "--workers", str(workers),
                "--log-every", "1", "--seed", "0", "--save-model",
                "--ckpt-dir", os.path.join(tmp, "ckpt"),
                "--log-dir", os.path.join(tmp, "tb")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tee = _Tee(sys.stdout)
        for mod in counters:
            mod.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = main(argv)
        wall = time.perf_counter() - t0
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated()
        best = os.path.exists(os.path.join(tmp, "ckpt", "best.pt"))
        last = os.path.exists(os.path.join(tmp, "ckpt", "last.pt"))
        if last and keep_last:
            last_state = torch.load(os.path.join(tmp, "ckpt", "last.pt"),
                                    map_location="cuda",
                                    weights_only=True)["model"]
    text = "".join(tee.parts)
    if rc != 0:
        raise AssertionError(f"main exited {rc}")
    losses = [float(x) for x in re.findall(r"loss (\S+)", text)]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    times = [float(t) for t in
             re.findall(r"^Epoch \d+: .*? time ([\d.]+)s", text, re.M)]
    if len(times) != epochs:
        raise AssertionError(f"expected {epochs} epoch summaries, "
                             f"got {len(times)}")
    if not last:
        raise AssertionError("no last checkpoint written")
    res = {"phase": "train", "arch": arch, "steps": epochs * steps,
            "eval_steps": epochs * -(-max(batch * steps // 4, batch)
                                     // batch),
            "launches": launches, "losses": losses, "epoch_train_s": times,
            "img_per_s_last_epoch": batch * steps / times[-1],
            "wall_s": wall, "peak_mem_bytes": peak, "last_checkpoint": last,
            "best_checkpoint": best,
            "input_wait_s": [float(t) for t in re.findall(
                r"^Epoch \d+: .*? input_wait ([\d.]+)s", text, re.M)],
            "plan": re.findall(r"^fused-mlp .*$", text, re.M)}
    return (res, last_state) if keep_last else res


def _train_vit(fa, batch: int, epochs: int, steps: int) -> dict:
    res = _train("vit_b16", ["--arch", "vit_b16", "--attn", "flash",
                             *_ADAMW_224], [fa], batch, epochs, steps)
    for key in ("fwd", "dq", "dkv"):
        if res["launches"][key] < 12 * res["steps"]:
            raise AssertionError(f"{key} launched {res['launches'][key]} "
                                 f"times in {res['steps']} steps; expected "
                                 f">= {12 * res['steps']}")
    print(json.dumps(res), flush=True)
    return res


def _train_convnext(fm, batch: int, epochs: int, steps: int) -> dict:
    res = _train("convnext_tiny", ["--arch", "convnext_tiny", "--fused-mlp",
                                   "on", *_ADAMW_224], [fm], batch, epochs,
                 steps)
    blocks = sum(_CONVNEXT_T[0])
    if not any(f"({blocks}/{blocks} blocks fused)" in ln
               for ln in res["plan"]):
        raise AssertionError(f"plan line does not fuse every block: "
                             f"{res['plan']}")
    want = {"fwd": blocks * (res["steps"] + res["eval_steps"]),
            "bwd": blocks * res["steps"], "wgrad": blocks * res["steps"],
            "reduce": blocks * res["steps"]}
    if res["launches"] != want:
        raise AssertionError(f"fused launches {res['launches']} != "
                             f"{want} ({res['steps']} train and "
                             f"{res['eval_steps']} eval steps)")
    print(json.dumps(res), flush=True)
    return res


def _train_convnext_off(fm, batch: int, epochs: int, steps: int) -> dict:
    """The same ConvNeXt-T path with ``--fused-mlp off`` (cuBLAS GEMMs,
    the yardstick of the fused path in the same run): no fused launch."""
    res = _train("convnext_tiny (fused-mlp off)",
                 ["--arch", "convnext_tiny", "--fused-mlp", "off",
                  *_ADAMW_224], [fm], batch, epochs, steps)
    if any(res["launches"].values()):
        raise AssertionError(f"--fused-mlp off launched fused kernels: "
                             f"{res['launches']}")
    print(json.dumps(res), flush=True)
    return res


def _train_resnet(arch, argv, counters, batch: int, epochs: int,
                  steps: int, workers: int, keep_last: bool = False):
    """A ResNet main path: no kernel of the port may launch (no model
    path calls the fused block, and ResNet runs no flash or fused-MLP
    kernel)."""
    out = _train(arch, argv, counters, batch, epochs, steps, workers,
                 keep_last)
    res = out[0] if keep_last else out
    if any(res["launches"].values()):
        raise AssertionError(f"{arch} main path launched port kernels: "
                             f"{res['launches']}")
    print(json.dumps(res), flush=True)
    return out


@contextlib.contextmanager
def _slurm_world_of_one(**overrides):
    """The ``SLURM_*`` variables of a one-task job (with ``overrides``)
    and a free ``IMAGENT_COORDINATOR_PORT``, for the body only: the port
    then forms its NCCL group as every rank of a larger job does. The
    environment is restored after, and no process group may be left
    open."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"SLURM_JOB_NUM_NODES": "1", "SLURM_NTASKS": "1",
           "SLURM_PROCID": "0", "SLURM_NODEID": "0", "SLURM_LOCALID": "0",
           "SLURM_JOB_NODELIST": "127.0.0.1",
           "IMAGENT_COORDINATOR_PORT": str(port), **overrides}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if dist.is_initialized():
        raise AssertionError("a process group was left open")


def _ddp_step_check(batch: int, image_size: int, steps: int = 5) -> dict:
    """One train step of the same ResNet-18 state and batch (the default
    command's model, bf16, SGD) through the 1-rank NCCL group and with no
    group, under ``cudnn.deterministic`` for this check only: the params,
    the BatchNorm buffers and the metric vector must be bitwise equal (a
    1-rank sum and a division by 1 are exact), and the step must make
    exactly one ``pmean`` and one ``psum`` with the group, none without.
    Then ``steps`` more steps of each are timed (host clock around
    synchronized steps)."""
    import torch
    import torch.distributed as dist
    from imagent_tpu_torch import cluster
    from imagent_tpu_torch.models import create_model
    from imagent_tpu_torch.parallel import collectives
    from imagent_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step,
    )
    g = torch.Generator(device="cuda").manual_seed(7)
    images = torch.randint(0, 256, (batch, image_size, image_size, 3),
                           generator=g, device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 1000, (batch,), generator=g, device="cuda",
                           dtype=torch.int32)
    lr = torch.tensor(0.1, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        with _slurm_world_of_one():
            senv, device, group = cluster.initialize("gpu")
            try:
                backend, world = (dist.get_backend(group),
                                  dist.get_world_size(group))
                if (backend, world) != ("nccl", 1):
                    raise AssertionError(f"group is {backend} of {world}, "
                                         "expected nccl of 1")
                for name, grp in (("group", group), ("no_group", None)):
                    model = create_model(
                        "resnet18", 1000, bf16=True, image_size=image_size,
                        generator=torch.Generator().manual_seed(0)).to(device)
                    opt = make_optimizer(0.9, 1e-4, "sgd")
                    state = create_train_state(model, opt)
                    step = make_train_step(opt, (0.5,) * 3, (0.5,) * 3,
                                           group=grp)
                    collectives.reset_calls()
                    state, metrics = step(state, images, labels, lr)
                    calls = dict(collectives.CALLS)
                    torch.cuda.synchronize()
                    after = {k: v.clone() for k, v in
                             state.model.state_dict().items()}
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        step(state, images, labels, lr)
                    torch.cuda.synchronize()
                    runs[name] = {
                        "state": after, "metrics": metrics.clone(),
                        "calls": calls,
                        "step_ms": (time.perf_counter() - t0) * 1e3 / steps}
                    pmean_bytes = sum(t.numel() * t.element_size()
                                      for t in after.values())
                    del model, state, step
            finally:
                cluster.destroy(group)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = runs["group"], runs["no_group"]
    if (a["calls"], b["calls"]) != ({"psum": 1, "pmean": 1},
                                    {"psum": 0, "pmean": 0}):
        raise AssertionError(f"collectives per step: {a['calls']} with the "
                             f"group, {b['calls']} without")
    differ = [k for k in a["state"] if not torch.equal(a["state"][k],
                                                       b["state"][k])]
    if differ or not torch.equal(a["metrics"], b["metrics"]):
        raise AssertionError(f"1-rank NCCL step differs from the step with "
                             f"no group: {differ[:5]} metrics "
                             f"{a['metrics'].tolist()} vs "
                             f"{b['metrics'].tolist()}")
    return {"bitwise_equal": True, "tensors_compared": len(a["state"]),
            "pmean_bytes_per_step": pmean_bytes,
            "psum_bytes_per_train_step": 5 * 4,
            "step_ms_group": a["step_ms"], "step_ms_no_group": b["step_ms"],
            "timed_steps": steps, "cudnn_deterministic": True}


def _train_ddp(ports, resnet18, card, batch: int, epochs: int, steps: int,
               workers: int) -> dict:
    """Main path 5: the default command as a Slurm world of one over
    NCCL; the collective counter, zeroed just before, must read exactly
    one ``pmean`` and one ``psum`` per train step and one ``psum`` per
    eval step. Printed as the ``ddp`` line, beside main path 3."""
    import torch
    from imagent_tpu_torch.__main__ import main
    from imagent_tpu_torch.parallel import collectives
    check = _ddp_step_check(batch, 448)
    # A task whose local rank has no card of its own exits 78 before any
    # group forms: no shared card, no CPU or gloo fallback.
    cards = torch.cuda.device_count()
    refusal = io.StringIO()
    with _slurm_world_of_one(SLURM_LOCALID=str(cards)), \
            contextlib.redirect_stdout(refusal):
        rc = main(["--dataset", "synthetic", "--workers", "0"])
    if rc != 78 or "has no CUDA device of its own" not in refusal.getvalue():
        raise AssertionError(f"local rank {cards} of {cards} card(s) exited "
                             f"{rc}: {refusal.getvalue()}")
    tee = _Tee(sys.stdout)
    with _slurm_world_of_one(), contextlib.redirect_stdout(tee):
        collectives.reset_calls()
        res = _train_resnet("resnet18 (Slurm world of one, NCCL)", [],
                            ports, batch, epochs, steps, workers)
        calls = dict(collectives.CALLS)
    banner = re.findall(r"^\[rank 0/1\] .* world 1 over nccl .*$",
                        "".join(tee.parts), re.M)
    if not banner:
        raise AssertionError("no rank banner naming a world of 1 over nccl")
    want = {"pmean": res["steps"], "psum": res["steps"] + res["eval_steps"]}
    if calls != want:
        raise AssertionError(f"collectives {calls} != {want} "
                             f"({res['steps']} train and "
                             f"{res['eval_steps']} eval steps)")
    line = {"phase": "ddp", "card": card, "backend": "nccl", "world": 1,
            "banner": banner[0], "collectives": calls,
            "collectives_per_train_step": 2,
            "collectives_per_eval_step": 1,
            "bytes_per_gradient_reduce": check["pmean_bytes_per_step"],
            "img_per_s": res["img_per_s_last_epoch"],
            "img_per_s_main_path_3": resnet18["img_per_s_last_epoch"],
            "peak_mem_gib": res["peak_mem_bytes"] / 2**30,
            "peak_mem_gib_main_path_3": resnet18["peak_mem_bytes"] / 2**30,
            "local_rank_without_card_exit": rc, "step_check": check}
    print(json.dumps(line), flush=True)
    return res


_GROUPS = (  # kernel-name fragment -> group of the step breakdown
    ("mlp_fwd_tc_kernel<", "fused_mlp_fwd"),
    ("mlp_bwd_tc_kernel<", "fused_mlp_bwd"),
    ("mlp_wgrad_kernel", "fused_mlp_wgrad"),
    ("mlp_fwd_kernel<", "fused_mlp_fwd"), ("mlp_bwd_kernel<", "fused_mlp_bwd"),
    ("mlp_reduce_kernel", "fused_mlp_reduce"),
    ("bottleneck_kernel<", "fused_block"), ("block_tc_kernel<", "fused_block"),
    ("batch_norm", "batch_norm"),
    ("pool", "pooling"),
    ("fwd_tc_kernel<", "flash_fwd"), ("dq_tc_kernel<", "flash_dq"),
    ("dkv_tc_kernel<", "flash_dkv"),
    ("fwd_kernel<", "flash_fwd"), ("dq_kernel<", "flash_dq"),
    ("dkv_kernel<", "flash_dkv"), ("fprop", "conv"), ("dgrad", "conv"),
    ("wgrad", "conv"), ("implicit", "conv"), ("gemm", "gemm"),
    ("nvjet", "gemm"),
    ("xmma", "gemm"), ("cutlass", "gemm"), ("layer_norm", "layer_norm"),
    ("gammabeta", "layer_norm"),
    ("conv", "conv"), ("elementwise", "elementwise"), ("reduce", "reduce"))


def _profile(arch: str, overrides: dict, batch: int, steps: int = 3,
             image_size: int = 224, opt=("adamw", 1e-4, 0.05)) -> dict:
    """Where a main-path train step's device time goes: the same bf16
    step as the train phase of ``arch`` (``opt`` = optimizer, lr, weight
    decay), ``steps`` steps timed on the host clock without the
    profiler, then the same steps under ``torch.profiler`` with device
    time summed per kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from imagent_tpu_torch.models import create_model
    from imagent_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step,
    )
    g = torch.Generator().manual_seed(5)
    model = create_model(arch, 1000, bf16=True, **overrides,
                         generator=torch.Generator().manual_seed(0)).cuda()
    opt_name, lr_value, wd = opt
    opt = make_optimizer(0.9, wd, opt_name)
    state = create_train_state(model, opt)
    step = make_train_step(opt, (0.5,) * 3, (0.5,) * 3)
    images = torch.randint(0, 256, (batch, image_size, image_size, 3),
                           generator=g, dtype=torch.uint8).cuda()
    labels = torch.randint(0, 1000, (batch,), generator=g,
                           dtype=torch.int32).cuda()
    lr = torch.tensor(lr_value, device="cuda")

    def run():
        nonlocal state
        for _ in range(steps):
            state, _ = step(state, images, labels, lr)
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3 / steps, e.count / steps, e.key))
    kernels.sort(reverse=True)
    groups: dict = {}
    for ms, _, name in kernels:
        group = next((grp for frag, grp in _GROUPS
                      if frag in name.lower()), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(ms for ms, _, _ in kernels)
    res = {"phase": "profile", "arch": arch, "overrides": overrides,
           "batch": batch,
           "image_size": image_size, "optimizer": opt_name, "steps": steps,
           "step_ms": step_ms, "device_ms_per_step": busy,
           "idle_share": 1.0 - busy / step_ms if kernels else None,
           "launches_per_step": sum(c for _, c, _ in kernels),
           "by_group_ms": groups,
           "top": [{"ms": ms, "calls": c, "name": name[:90]}
                   for ms, c, name in kernels[:12]]}
    print(json.dumps(res), flush=True)
    return res


def _kernel_rows(card, timing, errs, train, fused, fused_errs, fused_train,
                 block, block_errs, block_check, resnet_trains, block_regs):
    rows = []
    for name, key, replaces in _KERNELS:
        t = timing[key]
        rows.append({"name": name, "route": "cuda", "source": _SOURCE,
                     "replaces": replaces,
                     "launches": train["launches"][key],
                     "max_abs_err": errs[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "bound_share": t["bound_share"],
                     "library_ms": t["library_ms"], "passed": True})
    tol = _fused_tol("bfloat16")
    for name, key, replaces in _FUSED_KERNELS:
        t = fused[key]
        row = {"name": name, "route": "cuda", "source": _FUSED_SOURCE,
               "replaces": replaces,
               "launches": fused_train["launches"][key],
               "max_abs_err": fused_errs[key], "tolerance": tol[key],
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "bound_share": t["bound_ms"] / t["ms"],
               "library_ms": t["library_ms"],
               "per": "one ConvNeXt-T train step (18 blocks, B=64)",
               "passed": True}
        if key in ("fwd", "bwd"):
            # No single PyTorch call computes the block: its yardstick is
            # the unfused --fused-mlp off schedule (cuBLAS bf16 GEMMs).
            row["unfused_schedule_ms"] = t["unfused_schedule_ms"]
        if key in ("bwd", "wgrad"):  # max_abs_err is dh's; the pass's
            # own error is that of the gradients it feeds
            row.update(grads_err=fused_errs["bwd_grads"],
                       grads_tolerance=tol["bwd_grads"])
        if key == "bwd":
            row.update(workspace_bytes=t["workspace_bytes"],
                       workspace_write_ms=t["workspace_write_ms"],
                       intermediate_bytes=t["intermediate_bytes"],
                       wgrad_ms=t["wgrad_ms"])
        rows.append(row)
    name, replaces = _BLOCK_KERNEL
    sums = {k: sum(t[k] for t in block.values())
            for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                      "t_bytes_ms", "t_ops_ms")}
    rows.append({
        "name": name, "route": "cuda", "source": _BLOCK_SOURCE,
        "replaces": replaces, "launches": block_check["launches_fp32"],
        "launches_bf16": block_check["launches_bf16"],
        "launches_per": "the model check: one eval forward's 12 identity "
                        "bottlenecks of the trained ResNet-50 (fp32), "
                        "counters zeroed just before",
        "main_path_launches": {res["arch"]: res["launches"][name]
                               for res in resnet_trains},
        "max_abs_err": max(block_errs.values()),
        "tolerance": "|err| <= 0.03 + 0.03 * |plain| (bf16, B=64 shapes)",
        "model_check_max_abs_err": max(block_check["max_abs_err_fp32"]),
        "model_check_tolerance": block_check["tolerance_fp32"],
        "ms": sums["ms"], "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": ("bytes" if sums["t_bytes_ms"] >= sums["t_ops_ms"]
                     else "operations"),
        "bound_share": sums["bound_ms"] / sums["ms"],
        # No single PyTorch call computes the block: its yardstick is the
        # unfused cuDNN/cuBLAS bf16 schedule (addmm, conv2d, addmm).
        "library_ms": None,
        "unfused_schedule_ms": sums["library_ms"],
        "per": "one launch at each of the 4 ResNet-50 identity geometries "
               "(B=64, bf16), summed",
        "per_geometry": {f"{hw}x{hw} C={c} F={f}": {
            k: t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "bound_share", "tile",
                              "blocks_per_tile", "grid", "warps_n")}
            for (hw, c, f), t in block.items()},
        "registers_spills": {k: block_regs[k] for k in _BLOCK_TC},
        "passed": True})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="first check of a kernel edit: print the "
                         "compiler's register/spill report, compare and "
                         "time the kernels, then stop (no train phase, no "
                         "result line)")
    ap.add_argument("--block-plans", action="store_true",
                    help="time the bf16 fused block at forced launch plans "
                         "per ResNet-50 geometry and fit the plan's cost "
                         "weights to the times, then stop")
    ap.add_argument("--timings-only", action="store_true",
                    help="A/B of a kernel edit against another tree's "
                         "package (PYTHONPATH=<tree> python3 -P "
                         "chip_smoke.py --timings-only): build, time the "
                         "flash and fused-MLP kernels as the kernel phases "
                         "do, print one ab_timings line and stop; no "
                         "comparison and no gate, since the other tree may "
                         "lack a kernel that this one checks")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke needs a CUDA card", file=sys.stderr)
        return 1
    from imagent_tpu_torch.ops import _cuda
    from imagent_tpu_torch.ops import flash_attention as fa
    from imagent_tpu_torch.ops import fused_block as fb
    from imagent_tpu_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = _peaks(card)

    t0 = time.perf_counter()
    sources = ("flash_attention", "fused_mlp", "fused_block")
    # Build from the sources every time, so that the compiler's report
    # below is this tree's (a library found already built has no log).
    for src in sources:
        for lib in _cuda.BUILD_DIR.glob(f"lib{src}_*.so"):
            lib.unlink()
    _cuda.build(sources)
    spills = {}
    for src in sources:
        log = _cuda.BUILD_LOG[src]["log"]
        spills[src] = [ln.strip() for ln in log.splitlines()
                       if "spill" in ln and
                       "0 bytes spill stores, 0 bytes spill loads" not in ln]
        if args.kernels_only:
            print(log, flush=True)
    print(json.dumps({"phase": "build",
                      "seconds": time.perf_counter() - t0,
                      "per_source_s": {k: v["seconds"] for k, v in
                                       _cuda.BUILD_LOG.items()},
                      "spill_lines": spills}), flush=True)
    if args.timings_only:
        _ab_timings(fa, fm, fb, peaks, card)
        return 0
    if args.block_plans:
        _block_plans(fb, card)
        return 0
    flash_regs = _ptxas_report(_cuda.BUILD_LOG["flash_attention"]["log"])
    print(json.dumps({"phase": "flash_ptxas", "kernels": flash_regs}),
          flush=True)
    fused_regs = _ptxas_report(_cuda.BUILD_LOG["fused_mlp"]["log"])
    print(json.dumps({"phase": "fused_ptxas", "kernels": fused_regs}),
          flush=True)
    block_regs = _ptxas_report(_cuda.BUILD_LOG["fused_block"]["log"])
    print(json.dumps({"phase": "block_ptxas", "kernels": block_regs}),
          flush=True)
    for regs_of, names in ((flash_regs, ("fwd_tc_kernel<bf16,64>",
                                         "dq_tc_kernel<bf16,64>",
                                         "dkv_tc_kernel<bf16,64>")),
                           (fused_regs, _FUSED_TC),
                           (block_regs, _BLOCK_TC)):
        for name in names:
            regs = regs_of.get(name)
            if regs is None or "spill_stores" not in regs:
                raise AssertionError(f"{name}: no register/spill report in "
                                     f"the build log (entries: "
                                     f"{sorted(regs_of)})")
            if regs["spill_stores"] or regs["spill_loads"]:
                raise AssertionError(f"{name} spills: {regs}")

    n, h, d = _VIT_SHAPE["N"], _VIT_SHAPE["H"], _VIT_SHAPE["D"]
    main_errs = _compare(fa, _BATCH, n, h, d, torch.bfloat16, 1)
    _compare(fa, _BATCH, n, h, d, torch.float32, 2)
    for dtype in (torch.bfloat16, torch.float32):
        for offset in (0, 1):
            _compare_fused_qkv(fa, _BATCH, n, h, d, dtype, 3 + offset, offset)
    for dim in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            _compare(fa, 2, 50, 3, dim, dtype, 10 + dim)
    timing = _timings(fa, _BATCH, peaks)
    for name, key, _ in _KERNELS:
        t = timing[key]
        print(json.dumps({
            "phase": "kernel", "name": name, "card": card,
            "shape": f"B={_BATCH} N={n} H={h} D={d} bf16",
            "max_abs_err": main_errs[key], "kernel_ms": t["ms"],
            "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
            "library": "sdpa forward" if key == "fwd" else
                       "sdpa backward (dq, dk, dv together)",
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "bound_share": t["bound_share"], "fp32_ms": t["fp32_ms"],
            "bytes": t["bytes"], "flops": t["flops"]}), flush=True)

    lib_smem = fm._kernels().fused_mlp_smem_bytes
    lib_rows = fm._kernels().fused_mlp_tc_rows
    for c in (16, 96, 192, 200, 384, 768):
        for dtype in (torch.float32, torch.bfloat16):
            got = lib_smem(c, int(dtype == torch.bfloat16))
            if got != fm.smem_bytes(c, dtype):
                raise AssertionError(f"smem at C={c} {dtype}: kernel {got} "
                                     f"!= plan {fm.smem_bytes(c, dtype)}")
        for backward in (False, True):
            if lib_rows(c, int(backward)) != fm.tc_rows(c, backward):
                raise AssertionError(
                    f"bf16 row tile at C={c} (backward={backward}): kernel "
                    f"{lib_rows(c, int(backward))} != plan "
                    f"{fm.tc_rows(c, backward)}")
    fused_errs = {"fwd": 0.0, "bwd": 0.0, "bwd_grads": 0.0, "reduce": 0.0}
    for c, rows in _ODD_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            _fused_compare(fm, c, rows, dtype, c + rows)
    for stage, c in enumerate(_CONVNEXT_T[1]):
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (_convnext_rows(stage), _RAGGED_ROWS):
                errs = _fused_compare(fm, c, rows, dtype, c + rows)
                if dtype == torch.bfloat16 and rows != _RAGGED_ROWS:
                    fused_errs = {k: max(v, errs[k])
                                  for k, v in fused_errs.items()}
    fused_errs["wgrad"] = fused_errs["bwd_grads"]
    fused_per_width = _fused_timings(fm, peaks, card)
    fused = _fused_step_totals(fused_per_width)
    print(json.dumps({"phase": "fused_step_totals", "card": card, **fused}),
          flush=True)

    lib_block_smem = fb._kernels().fused_block_smem_bytes
    tc_tiles = {tuple(fb.plan_tc(*shape)[:2]) for shape in
                [(_BATCH, hw, hw, c, f) for hw, c, f in _R50_BLOCKS]
                + [_RAGGED_BLOCK, _ODD_BLOCK, _SPLIT_BLOCK]}
    tc_tiles |= {(1, 1), (7, 7), (32, 32)}
    for dtype, tiles in ((torch.float32, fb.TILES),
                         (torch.bfloat16, sorted(tc_tiles))):
        for th, tw in tiles:
            for f in (36, 40, 64, 512):
                got = lib_block_smem(th, tw, f, int(dtype == torch.bfloat16))
                if got != fb.smem_bytes(th, tw, f, dtype):
                    raise AssertionError(
                        f"fused_block smem at {th}x{tw} F={f} {dtype}: "
                        f"kernel {got} != plan "
                        f"{fb.smem_bytes(th, tw, f, dtype)}")
    block_errs = {}
    for hw, c, f in _R50_BLOCKS:
        for dtype in (torch.bfloat16, torch.float32):
            err = _block_compare(fb, (_BATCH, hw, hw, c, f), dtype, hw + c,
                                 repeat=dtype == torch.bfloat16
                                 and hw in (56, 7))
            if dtype == torch.bfloat16:
                block_errs[(hw, c, f)] = err
    for shape in (_RAGGED_BLOCK, _ODD_BLOCK, _SPLIT_BLOCK):
        for dtype in (torch.bfloat16, torch.float32):
            _block_compare(fb, shape, dtype, 5,
                           repeat=dtype == torch.bfloat16
                           and shape == _SPLIT_BLOCK)
    block = _block_timings(fb, peaks, card)
    if args.kernels_only:
        return 0
    _vit_check(fa)
    _vit_bf16_check(fa)

    vit = _train_vit(fa, _BATCH, epochs=2, steps=4)
    convnext = _train_convnext(fm, _BATCH, epochs=2, steps=3)
    convnext_off = _train_convnext_off(fm, _BATCH, epochs=2, steps=3)
    ports = [fa, fm, fb]
    # Main path 3: the default command, no --arch (ResNet-18 at 448 px,
    # SGD lr 0.1 momentum 0.9 wd 1e-4, bf16): only the batch and the data.
    resnet18 = _train_resnet("resnet18 (default)", [], ports, 128, epochs=2,
                             steps=3, workers=8)
    # Main path 5: the same command as a Slurm world of one over NCCL.
    ddp = _train_ddp(ports, resnet18, card, 128, epochs=2, steps=3,
                     workers=8)
    # Main path 4: bench.py:263's ResNet-50 cell, batch 256 cut to 64.
    resnet50, last50 = _train_resnet(
        "resnet50", ["--arch", "resnet50", "--image-size", "224"], ports,
        _BATCH, epochs=2, steps=3, workers=8, keep_last=True)
    block_check = _block_model_check(fb, last50, _BATCH)
    del last50
    for res in (vit, convnext, convnext_off, resnet18, ddp, resnet50):
        print(json.dumps({"phase": "train_summary", "arch": res["arch"],
                          "card": card,
                          "img_per_s": res["img_per_s_last_epoch"],
                          "peak_mem_gib": res["peak_mem_bytes"] / 2**30}),
              flush=True)
    _profile("vit_b16", {"attn_impl": "flash"}, _BATCH)
    _profile("convnext_tiny", {"fused_mlp": "on"}, _BATCH)
    _profile("convnext_tiny", {"fused_mlp": "off"}, _BATCH)
    sgd = ("sgd", 0.1, 1e-4)
    _profile("resnet18", {}, 128, image_size=448, opt=sgd)
    _profile("resnet50", {}, _BATCH, opt=sgd)
    rows = _kernel_rows(card, timing, main_errs, vit, fused, fused_errs,
                        convnext, block, block_errs, block_check,
                        (resnet18, resnet50), block_regs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
