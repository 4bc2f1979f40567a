#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``imagent_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still builds and trains.

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Phases, in order (any failure raises and exits non-zero):

1. the card: name and power limit from ``nvidia-smi``;
2. the build: every CUDA kernel of the main paths, from
   ``imagent_tpu_torch/csrc`` (nvcc, one process per source, all started
   together);
3. the flash kernels: ``fwd``, ``dq`` and ``dkv`` against their plain
   PyTorch versions at ViT-B/16 shapes (N=197, H=12, D=64, the smoke's
   batch) in bf16 and fp32, and at small ragged shapes for every
   supported head dim; timings beside SDPA as a yardstick;
4. the fused-MLP kernels: ``fwd``, ``bwd`` and ``reduce`` against their
   plain versions at each ConvNeXt-T width (C = 96, 192, 384, 768) at
   its B=64, 224 px row count and at a ragged row count, in fp32 and
   bf16; two backward runs must be bitwise identical; timings at the
   B=64 shapes in bf16;
5. a ViT-B/16 forward with ``attn=flash`` against ``attn=full``;
6. main path 1: ``python -m imagent_tpu_torch`` in-process on ViT-B/16
   at 224 px with ``--attn flash --optimizer adamw`` (bf16, global
   batch 64, synthetic data sized for 4 train steps and one eval batch
   per epoch, 2 epochs, best checkpoint saved). The flash launch
   counters are zeroed just before and read just after: every kernel
   must have run at least 12 times per step taken;
7. main path 2: the same CLI on ConvNeXt-T at 224 px with
   ``--fused-mlp on --optimizer adamw`` (bf16, batch 64, 3 train steps
   and one eval batch per epoch, 2 epochs, best checkpoint saved). The
   plan line must fuse all 18 blocks, and the fused counters, zeroed
   just before, must read exactly 18 forward launches per train and
   eval step and 18 backward and reduce launches per train step;
8. a profile of each main path's train step (``torch.profiler``): host
   step time, device time per kernel group, the device's idle share;
9. the ``kernels`` JSON line, the card line, then the device JSON line
   last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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
    # the revisited-output accumulation of the TPU backward
    ("fused_mlp.reduce", "reduce", "imagent_tpu/ops/fused_mlp.py:163"),
)
_FUSED_SOURCE = "imagent_tpu_torch/csrc/fused_mlp.cu"
_VIT_SHAPE = dict(N=197, H=12, D=64)  # ViT-B/16 at 224 px: 196 patches + cls
_BATCH = 64  # global batch of the kernel and train phases
# ConvNeXt-T (depths, widths); stage i runs at 56 / 2^i px at 224 px.
_CONVNEXT_T = ((3, 3, 9, 3), (96, 192, 384, 768))
_RAGGED_ROWS = 333  # a row count that is no multiple of any row tile


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
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
    torch.cuda.synchronize()
    errs["dq"] = _max_err(f"dq {tag}", dq_k,
                          fa.dq_plain(q, k, v, do, lse_p, di), dname)
    dk_k, dv_k = fa.dkv(q, k, v, do, lse_p, di)
    torch.cuda.synchronize()
    dk_p, dv_p = fa.dkv_plain(q, k, v, do, lse_p, di)
    errs["dkv"] = max(_max_err(f"dk {tag}", dk_k, dk_p, dname),
                      _max_err(f"dv {tag}", dv_k, dv_p, dname))
    print(json.dumps({"phase": "compare", "shape": tag,
                      "max_abs_err": errs, "tolerance": _TOL[dname]}),
          flush=True)
    return errs


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
    return out_t


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
    errs["reduce"] = _norm_err(f"fused reduce {tag}", flat,
                               fm.reduce_plain(ws), "float32")[0]
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
    return {"fwd": elementwise, "bwd": elementwise,
            "bwd_grads": f"max |err| / max |plain| <= {_GRAD_TOL[dname]}",
            "reduce": f"max |err| / max |plain| <= "
                      f"{_GRAD_TOL['float32']}"}


def _bound(nbytes, flops, peak_flops, peaks) -> dict:
    t_bytes = nbytes / peaks["bytes"] * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes": nbytes,
            "flops": flops, "t_bytes_ms": t_bytes, "t_ops_ms": t_ops}


def _fused_timings(fm, peaks, card) -> dict:
    """Each fused kernel at each ConvNeXt-T width at its B=64 shape in
    bf16: kernel, plain and (reduce only) library times and the bound,
    the larger of bytes (inputs read once, outputs written once) over
    HBM bandwidth and flops over the peak for their type. The backward's
    bound is that of the function, dh and the gradients from h, dout and
    the weights: its partial-sum workspace exists only because of this
    design, so its traffic is reported beside the bound
    (``workspace_bytes``, ``workspace_write_ms``), not in it. No single
    PyTorch call computes the fused block or its backward, so their
    library_ms is null; the reduce's is ``torch.sum`` over the slots."""
    import torch
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
        per_width[c] = {}
        for key, (kern, plain, lib) in runs.items():
            t = dict(work[key])
            t["ms"] = _cuda_ms(kern)
            t["plain_ms"] = _cuda_ms(plain, 3, 1)
            t["library_ms"] = _cuda_ms(lib) if lib else None
            t["bound_by"] = ("bytes" if t["t_bytes_ms"] >= t["t_ops_ms"]
                             else "operations")
            if key == "bwd":
                t["workspace_bytes"] = slots * slot * 4
                t["workspace_write_ms"] = (t["workspace_bytes"]
                                           / peaks["bytes"] * 1e3)
            per_width[c][key] = t
            print(json.dumps({"phase": "fused_kernel", "name":
                              f"fused_mlp.{key}", "card": card,
                              "shape": f"C={c} R={rows} bf16",
                              "splits": slots, **t}), flush=True)
        del ws
    return per_width


def _fused_step_totals(per_width) -> dict:
    """Each fused kernel's numbers summed over the 18 blocks of one
    ConvNeXt-T train step (depth x the width's launch): ms, plain_ms,
    library_ms, bound_ms (the sum of each launch's own bound) and the
    kind that dominates that bound; for the backward also its
    workspace's bytes and their time at HBM rate, beside the bound."""
    out = {}
    for key in ("fwd", "bwd", "reduce"):
        sums = ("ms", "plain_ms", "bound_ms") + (
            ("workspace_bytes", "workspace_write_ms") if key == "bwd"
            else ())
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


def _train(arch_argv, counters, batch: int, epochs: int,
           steps: int) -> dict:
    """A main path through the CLI entry point, its launch counters
    (``counters``: modules with ``LAUNCHES``/``reset_launches``) zeroed
    just before and read just after; returns its numbers."""
    import torch
    from imagent_tpu_torch.__main__ import main
    with tempfile.TemporaryDirectory() as tmp:
        argv = [*arch_argv, "--optimizer", "adamw", "--lr", "1e-4",
                "--weight-decay", "0.05", "--image-size", "224",
                "--num-classes", "1000", "--dataset", "synthetic",
                "--batch-size", str(batch),
                "--synthetic-size", str(batch * steps),
                "--epochs", str(epochs), "--workers", "4",
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
    if not best:
        raise AssertionError("no best checkpoint written")
    return {"phase": "train", "arch": arch_argv[1], "steps": epochs * steps,
            "eval_steps": epochs * -(-max(batch * steps // 4, batch)
                                     // batch),
            "launches": launches, "losses": losses, "epoch_train_s": times,
            "img_per_s_last_epoch": batch * steps / times[-1],
            "wall_s": wall, "peak_mem_bytes": peak, "best_checkpoint": best,
            "plan": re.findall(r"^fused-mlp .*$", text, re.M)}


def _train_vit(fa, batch: int, epochs: int, steps: int) -> dict:
    res = _train(["--arch", "vit_b16", "--attn", "flash"], [fa], batch,
                 epochs, steps)
    for key in ("fwd", "dq", "dkv"):
        if res["launches"][key] < 12 * res["steps"]:
            raise AssertionError(f"{key} launched {res['launches'][key]} "
                                 f"times in {res['steps']} steps; expected "
                                 f">= {12 * res['steps']}")
    print(json.dumps(res), flush=True)
    return res


def _train_convnext(fm, batch: int, epochs: int, steps: int) -> dict:
    res = _train(["--arch", "convnext_tiny", "--fused-mlp", "on"], [fm],
                 batch, epochs, steps)
    blocks = sum(_CONVNEXT_T[0])
    if not any(f"({blocks}/{blocks} blocks fused)" in ln
               for ln in res["plan"]):
        raise AssertionError(f"plan line does not fuse every block: "
                             f"{res['plan']}")
    want = {"fwd": blocks * (res["steps"] + res["eval_steps"]),
            "bwd": blocks * res["steps"], "reduce": blocks * res["steps"]}
    if res["launches"] != want:
        raise AssertionError(f"fused launches {res['launches']} != "
                             f"{want} ({res['steps']} train and "
                             f"{res['eval_steps']} eval steps)")
    print(json.dumps(res), flush=True)
    return res


_GROUPS = (  # kernel-name fragment -> group of the step breakdown
    ("mlp_fwd_kernel<", "fused_mlp_fwd"), ("mlp_bwd_kernel<", "fused_mlp_bwd"),
    ("mlp_reduce_kernel", "fused_mlp_reduce"),
    ("fwd_kernel<", "flash_fwd"), ("dq_kernel<", "flash_dq"),
    ("dkv_kernel<", "flash_dkv"), ("gemm", "gemm"), ("nvjet", "gemm"),
    ("xmma", "gemm"), ("cutlass", "gemm"), ("layer_norm", "layer_norm"),
    ("gammabeta", "layer_norm"),
    ("conv", "conv"), ("elementwise", "elementwise"), ("reduce", "reduce"))


def _profile(arch: str, overrides: dict, batch: int, steps: int = 3) -> dict:
    """Where a main-path train step's device time goes: the same AdamW
    bf16 step as the train phase of ``arch``, ``steps`` steps timed on
    the host clock without the profiler, then the same steps under
    ``torch.profiler`` with device time summed per kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from imagent_tpu_torch.models import create_model
    from imagent_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step,
    )
    g = torch.Generator().manual_seed(5)
    model = create_model(arch, 1000, bf16=True, **overrides,
                         generator=torch.Generator().manual_seed(0)).cuda()
    opt = make_optimizer(0.9, 0.05, "adamw")
    state = create_train_state(model, opt)
    step = make_train_step(opt, (0.5,) * 3, (0.5,) * 3)
    images = torch.randint(0, 256, (batch, 224, 224, 3), generator=g,
                           dtype=torch.uint8).cuda()
    labels = torch.randint(0, 1000, (batch,), generator=g,
                           dtype=torch.int32).cuda()
    lr = torch.tensor(1e-4, device="cuda")

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
    res = {"phase": "profile", "arch": arch, "batch": batch, "steps": steps,
           "step_ms": step_ms, "device_ms_per_step": busy,
           "idle_share": 1.0 - busy / step_ms if kernels else None,
           "launches_per_step": sum(c for _, c, _ in kernels),
           "by_group_ms": groups,
           "top": [{"ms": ms, "calls": c, "name": name[:90]}
                   for ms, c, name in kernels[:12]]}
    print(json.dumps(res), flush=True)
    return res


def _kernel_rows(card, timing, errs, train, fused, fused_errs, fused_train):
    rows = []
    for name, key, replaces in _KERNELS:
        t = timing[key]
        rows.append({"name": name, "route": "cuda", "source": _SOURCE,
                     "replaces": replaces,
                     "launches": train["launches"][key],
                     "max_abs_err": errs[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
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
               "library_ms": t["library_ms"],
               "per": "one ConvNeXt-T train step (18 blocks, B=64)",
               "passed": True}
        if key == "bwd":  # max_abs_err is dh's
            row.update(grads_err=fused_errs["bwd_grads"],
                       grads_tolerance=tol["bwd_grads"],
                       workspace_bytes=t["workspace_bytes"],
                       workspace_write_ms=t["workspace_write_ms"])
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="first check of a kernel edit: print the "
                         "compiler's register/spill report, compare and "
                         "time the kernels, then stop (no train phase, no "
                         "result line)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke needs a CUDA card", file=sys.stderr)
        return 1
    from imagent_tpu_torch.ops import _cuda
    from imagent_tpu_torch.ops import flash_attention as fa
    from imagent_tpu_torch.ops import fused_mlp as fm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = _peaks(card)

    t0 = time.perf_counter()
    sources = ("flash_attention", "fused_mlp")
    _cuda.build(sources)
    spills = {}
    for src in sources:
        log = _cuda.BUILD_LOG.get(src, {}).get("log", "")
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

    n, h, d = _VIT_SHAPE["N"], _VIT_SHAPE["H"], _VIT_SHAPE["D"]
    main_errs = _compare(fa, _BATCH, n, h, d, torch.bfloat16, 1)
    _compare(fa, _BATCH, n, h, d, torch.float32, 2)
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
            "bytes": t["bytes"], "flops": t["flops"]}), flush=True)

    lib_smem = fm._kernels().fused_mlp_smem_bytes
    for c in (16, 96, 200, 384, 768):
        if lib_smem(c) != fm.smem_bytes(c):
            raise AssertionError(f"smem at C={c}: kernel {lib_smem(c)} != "
                                 f"plan {fm.smem_bytes(c)}")
    fused_errs = {"fwd": 0.0, "bwd": 0.0, "bwd_grads": 0.0, "reduce": 0.0}
    for stage, c in enumerate(_CONVNEXT_T[1]):
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (_convnext_rows(stage), _RAGGED_ROWS):
                errs = _fused_compare(fm, c, rows, dtype, c + rows)
                if dtype == torch.bfloat16 and rows != _RAGGED_ROWS:
                    fused_errs = {k: max(v, errs[k])
                                  for k, v in fused_errs.items()}
    fused_per_width = _fused_timings(fm, peaks, card)
    fused = _fused_step_totals(fused_per_width)
    print(json.dumps({"phase": "fused_step_totals", "card": card, **fused}),
          flush=True)
    if args.kernels_only:
        return 0
    _vit_check(fa)

    vit = _train_vit(fa, _BATCH, epochs=2, steps=4)
    convnext = _train_convnext(fm, _BATCH, epochs=2, steps=3)
    for res in (vit, convnext):
        print(json.dumps({"phase": "train_summary", "arch": res["arch"],
                          "card": card,
                          "img_per_s": res["img_per_s_last_epoch"],
                          "peak_mem_gib": res["peak_mem_bytes"] / 2**30}),
              flush=True)
    _profile("vit_b16", {"attn_impl": "flash"}, _BATCH)
    _profile("convnext_tiny", {"fused_mlp": "on"}, _BATCH)
    rows = _kernel_rows(card, timing, main_errs, vit, fused, fused_errs,
                        convnext)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
