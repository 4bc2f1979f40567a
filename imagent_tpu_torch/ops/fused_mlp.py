"""Fused ConvNeXt MLP: hand-written CUDA kernels for Hopper behind an
``autograd.Function``, with plain PyTorch versions of the same math.

Port of ``imagent_tpu/ops/fused_mlp.py``. One block's
LN -> C->4C -> GELU -> 4C->C -> layer-scale -> residual chain runs as one
kernel, so the 4C activation never reaches device memory; the backward
recomputes it from the block's inputs (FlashAttention's remat-in-kernel
discipline). The two Pallas TPU kernels become three CUDA kernels in
``csrc/fused_mlp.cu`` (see its header for the design and what bounds it
on an H100):

* ``fwd`` replaces ``_fwd_kernel`` (``_fused_fwd_impl``);
* ``bwd`` replaces ``_bwd_kernel`` (``_fused_core_bwd``): ``dh`` for its
  rows, and fp32 partial sums of the weight and vector gradients, one
  slot per CUDA block;
* ``reduce`` sums those slots in a fixed order. The TPU kernel
  accumulates the same sums in output blocks revisited by a sequential
  grid; CUDA blocks run in no order, so the reduction is a second pass,
  and no float atomics are used: a rerun is bitwise identical.

``db2 = sum(dout) * gamma`` stays a plain torch op, as it lies outside
the Pallas kernel in the JAX package.

Dtypes follow the JAX package: parameters are cast to the activation
dtype before the kernel (``fused_mlp_block``), LayerNorm statistics,
GEMM accumulation, GELU and the epilogues run in fp32, and the values
that feed a GEMM (``y1``, ``GELU(a)``, ``dout * gamma``, ``da``) are
rounded to the activation dtype first. Weight and vector gradients come
out of the kernels in fp32 and are cast to each parameter's dtype.

Where the kernel fits (``unfused_reason``): the TPU rule models VMEM
and leaves C=768 unfused; here the rule is the kernels' own shared
memory per block against the device's opt-in limit (227 KB on an H100).
W1 and W2 are streamed through shared memory in chunks of the 4C axis,
so every ConvNeXt-T width (96, 192, 384, 768) fits and all 18 blocks
fuse; C=1024 and C=1536 (ConvNeXt-B/L's last stage) do not.

Dispatch: a wrapper runs its plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises. ``LAUNCHES`` counts
kernel launches per entry point.
"""

from __future__ import annotations

import ctypes
import math

import torch

LAUNCHES = {"fwd": 0, "bwd": 0, "reduce": 0}

# Tile geometry of csrc/fused_mlp.cu (kBMF/kBNF, kBMB/kBNB, kMaxSplit).
FWD_ROWS, FWD_CHUNK = 32, 32
BWD_ROWS, BWD_CHUNK = 16, 16
# Backward blocks, one fp32 partial slot each: as many slots as fit
# WORKSPACE_BYTES, within [MIN_SPLITS, MAX_SPLITS] (a function of the
# shape alone, never of the device, so a rerun sums in the same order).
WORKSPACE_BYTES = 256 * 2 ** 20
MIN_SPLITS, MAX_SPLITS = 128, 1024
# Register-tile widths the kernels are instantiated for: a block of
# width C uses the smallest NJ with 32 * NJ >= C (columns past C are
# zero-padded in shared memory).
_NJ = (1, 2, 3, 4, 6, 8, 12, 16, 24)
MAX_DIM = 32 * _NJ[-1]
# Opt-in shared memory per block of an H100 (sm_90): the limit the plan
# uses when no CUDA device is given.
H100_SMEM_OPTIN = 232448
MODES = ("auto", "on", "off")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "fused_mlp_fwd": [_P] * 10 + [_I, _I, _F, _I, _P],
    "fused_mlp_bwd": [_P] * 11 + [_I, _I, _F, _I, _I, _P],
    "fused_mlp_reduce": [_P, _P, _I, ctypes.c_longlong, _P],
    "fused_mlp_smem_bytes": [_I],
}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from imagent_tpu_torch.ops import _cuda
        lib = _cuda.load("fused_mlp")
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


def _padded_dim(c: int) -> int:
    need = -(-c // 32)
    return 32 * next((nj for nj in _NJ if nj >= need), need)


def smem_bytes(c: int) -> int:
    """Dynamic shared memory per block of the larger of the forward and
    backward kernels at width ``c`` (``fwd_smem_floats`` and
    ``bwd_smem_floats`` of csrc/fused_mlp.cu, fp32 tiles in every
    dtype)."""
    cp = _padded_dim(c)
    fwd = FWD_ROWS * (cp + 1) + FWD_CHUNK * cp + FWD_ROWS * FWD_CHUNK
    bwd = ((2 * BWD_ROWS + 2 * BWD_CHUNK) * (cp + 4)
           + 3 * BWD_ROWS * BWD_CHUNK + 2 * BWD_ROWS)
    return 4 * max(fwd, bwd)


def _smem_limit(device) -> int:
    if device is not None and torch.device(device).type == "cuda":
        props = torch.cuda.get_device_properties(torch.device(device))
        return int(getattr(props, "shared_memory_per_block_optin",
                           H100_SMEM_OPTIN))
    return H100_SMEM_OPTIN


def kernel_fits(dim: int, device=None) -> bool:
    """The Hopper rule: the kernels take width ``dim`` (a multiple of 8
    up to ``MAX_DIM``) and their shared memory per block fits the
    device's opt-in limit (an H100's when ``device`` is not CUDA)."""
    return (dim % 8 == 0 and 0 < dim <= MAX_DIM
            and smem_bytes(dim) <= _smem_limit(device))


def unfused_reason(mode: str, dim: int, *, dropping: bool = False,
                   device=None) -> str | None:
    """None where ``--fused-mlp mode`` fuses a block of width ``dim``,
    else why not: ``off``, ``drop-path``, ``smem`` (the kernel does not
    fit) or ``device`` (``auto`` and the tensors are not on CUDA)."""
    if mode not in MODES:
        raise ValueError(
            f"--fused-mlp must be one of auto|on|off, got {mode!r}")
    if mode == "off":
        return "off"
    if dropping:
        return "drop-path"
    if not kernel_fits(dim, device):
        return "smem"
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if mode == "auto" and not on_cuda:
        return "device"
    return None


def fused_block_rows(mode: str, dim: int, *, dropping: bool = False,
                     device=None) -> int | None:
    """``unfused_reason`` in the JAX package's form: the forward
    kernel's row tile where the block fuses, else None.

    * ``off``: never fuse;
    * ``on``: fuse wherever the kernel fits (on the CPU the fused
      autograd path runs the plain versions: how the tests reach it);
    * ``auto``: fuse where the kernel fits and the tensors are on a CUDA
      device.

    An active stochastic-depth mask (``dropping``) never fuses. The
    shared-memory tiles are fp32 in every dtype, so unlike the TPU rule
    the decision takes no dtype."""
    if unfused_reason(mode, dim, dropping=dropping, device=device):
        return None
    return FWD_ROWS


def fused_mlp_plan(mode: str, dims, *, device=None) -> dict:
    """Per-stage-width decision map: ``{dim: block_rows | None}``."""
    return {int(d): fused_block_rows(mode, int(d), device=device)
            for d in dims}


def block_inputs(c: int, rows: int, dtype, seed: int, device="cuda"):
    """Random inputs of one fused block at unit scale, ``[resid, h, ls,
    lb, w1, b1, w2, b2, gamma, dout]``: the weights scaled by fan-in,
    gamma from N(0, 0.5) so a broken MLP shows (the model's 1e-6 layer
    scale would hide it). The kernels' checks on the card draw from
    here."""
    g = torch.Generator(device=device).manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=device)
    args = [mk(rows, c), mk(rows, c), 1 + 0.1 * mk(c), 0.1 * mk(c),
            mk(c, 4 * c) / c ** 0.5, 0.1 * mk(4 * c),
            mk(4 * c, c) / (2 * c ** 0.5), 0.1 * mk(c), 0.5 * mk(c),
            mk(rows, c)]
    return [a.to(dtype) for a in args]


# ---------------------------------------------------------------- plain

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gelu(a):
    """Exact (erf) GELU in fp32."""
    return 0.5 * a * (1.0 + torch.erf(a / _SQRT2))


def _gelu_grad(a):
    """d/da of exact GELU: Phi(a) + a * phi(a)."""
    phi = torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
    return 0.5 * (1.0 + torch.erf(a / _SQRT2)) + a * phi


def _ln_fwd(h32, eps):
    """fp32 LayerNorm core, two-pass variance: ``(xn, rsig)``."""
    mu = h32.mean(-1, keepdim=True)
    var = torch.square(h32 - mu).mean(-1, keepdim=True)
    rsig = torch.rsqrt(var + eps)
    return (h32 - mu) * rsig, rsig


def _mlp_chain(h, ls, lb, w1, b1, w2, b2, eps):
    """``_mlp_chain`` of the JAX package over all rows: fp32 statistics
    and epilogues, GEMM operands rounded to the compute dtype."""
    cd = w1.dtype
    xn, rsig = _ln_fwd(h.float(), eps)
    y1c = (xn * ls.float() + lb.float()).to(cd)
    a = y1c.float() @ w1.float() + b1.float()
    gac = _gelu(a).to(cd)
    o = gac.float() @ w2.float() + b2.float()
    return xn, rsig, y1c, a, gac, o


def fwd_plain(resid, h, ls, lb, w1, b1, w2, b2, gamma, eps=1e-6):
    """``resid + gamma * (GELU(LN(h) @ w1 + b1) @ w2 + b2)`` for
    ``(R, C)`` rows, in ``resid``'s dtype (``_fwd_kernel``)."""
    o = _mlp_chain(h, ls, lb, w1, b1, w2, b2, eps)[-1]
    return (resid.float() + gamma.float() * o).to(resid.dtype)


def bwd_plain(h, ls, lb, w1, b1, w2, b2, gamma, dout, eps=1e-6):
    """``(dh, dw1, db1, dw2, dgamma, dls, dlb)`` of ``_bwd_kernel``: dh in
    ``h``'s dtype, the rest fp32, step by step as the TPU kernel."""
    cd = w1.dtype
    xn, rsig, y1c, a, gac, o = _mlp_chain(h, ls, lb, w1, b1, w2, b2, eps)
    g = dout.float()
    do = g * gamma.float()
    dgamma = (g * o).sum(0)
    doc = do.to(cd).float()
    dw2 = gac.float().t() @ doc
    dga = doc @ w2.float().t()
    da = dga * _gelu_grad(a)
    db1 = da.sum(0)
    dac = da.to(cd).float()
    dw1 = y1c.float().t() @ dac
    dy1 = dac @ w1.float().t()
    dls = (dy1 * xn).sum(0)
    dlb = dy1.sum(0)
    dxn = dy1 * ls.float()
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    dh = (rsig * (dxn - m1 - xn * m2)).to(h.dtype)
    return dh, dw1, db1, dw2, dgamma, dls, dlb


def reduce_plain(ws):
    """The slots of a ``(S, n)`` workspace summed in slot order, as the
    reduce kernel sums them."""
    out = ws[0].clone()
    for s in range(1, ws.shape[0]):
        out += ws[s]
    return out


def reference_mlp_block(resid, h, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                        *, eps: float = 1e-6):
    """The same computation as unfused torch ops in the model's dtype
    discipline (params cast to the activation dtype, fp32 LayerNorm
    statistics, compute-dtype GEMM operands): the parity oracle."""
    cd = resid.dtype
    ls, lb, w1, b1, w2, b2, g = (t.to(cd) for t in
                                 (ln_scale, ln_bias, w1, b1, w2, b2, gamma))
    xn, _ = _ln_fwd(h.float(), eps)
    y = (xn * ls.float() + lb.float()).to(cd)
    y = y.float() @ w1.float() + b1.float()
    y = _gelu(y).to(cd)
    y = y.float() @ w2.float() + b2.float()
    return (resid.float() + g.float() * y).to(cd)


# -------------------------------------------------------------- kernels


def _on_cuda(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"fused MLP runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return True


def _check(h, *params):
    if h.dim() != 2:
        raise ValueError(f"rows must be 2-D (R, C), got {tuple(h.shape)}")
    r, c = h.shape
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused MLP takes float32 or bfloat16, got "
                         f"{h.dtype}")
    ls, lb, w1, b1, w2, b2, gamma = params
    want = {"ls": (c,), "lb": (c,), "w1": (c, 4 * c), "b1": (4 * c,),
            "w2": (4 * c, c), "b2": (c,), "gamma": (c,)}
    for (name, shape), t in zip(want.items(), params):
        if tuple(t.shape) != shape or t.dtype != h.dtype \
                or t.device != h.device:
            raise ValueError(f"{name} must be {h.dtype} {shape} on "
                             f"{h.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if r < 1:
        raise ValueError("fused MLP needs at least one row")


def _kernel_width(c: int, device) -> None:
    if not kernel_fits(c, device):
        raise ValueError(f"C={c} is outside the fused-MLP kernels (a "
                         f"multiple of 8 up to {MAX_DIM} whose "
                         f"{smem_bytes(c)} bytes of shared memory fit); "
                         "use --fused-mlp auto/off")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def fwd(resid, h, ls, lb, w1, b1, w2, b2, gamma, eps=1e-6):
    """The block output: the forward kernel on CUDA, ``fwd_plain`` on
    the CPU. All inputs share one dtype; ``resid``/``h`` are ``(R, C)``."""
    params = (ls, lb, w1, b1, w2, b2, gamma)
    _check(h, *params)
    if resid.shape != h.shape or resid.dtype != h.dtype:
        raise ValueError(f"resid {tuple(resid.shape)} {resid.dtype} does "
                         f"not match h {tuple(h.shape)} {h.dtype}")
    if not _on_cuda(h):
        return fwd_plain(resid, h, *params, eps=eps)
    lib = _kernels()
    r, c = h.shape
    _kernel_width(c, h.device)
    resid, h = resid.contiguous(), h.contiguous()
    params = [t.contiguous() for t in params]
    out = torch.empty_like(h)
    _raise_on(lib.fused_mlp_fwd(*_ptrs(resid, h, *params, out), r, c, eps,
                                int(h.dtype == torch.bfloat16), _stream(h)),
              "fused_mlp_fwd")
    LAUNCHES["fwd"] += 1
    return out


def slot_floats(c: int) -> int:
    """fp32 values in one backward partial slot: dW1, dW2, db1, dgamma,
    dls, dlb."""
    return 8 * c * c + 7 * c


def splits(rows: int, c: int) -> int:
    """Backward blocks (and partial slots) for ``rows`` rows of width
    ``c``: 902 at C=96 and 226 at C=192 (256 MiB of slots), 128 at C=384
    and C=768 (0.60 and 2.42 GB), never more than the row tiles."""
    fit = WORKSPACE_BYTES // (4 * slot_floats(c))
    return min(max(MIN_SPLITS, min(MAX_SPLITS, fit)), -(-rows // BWD_ROWS))


def bwd_partials(h, ls, lb, w1, b1, w2, b2, gamma, dout, eps=1e-6):
    """``(dh, ws)``: the backward kernel's dh and its ``(S, slot)`` fp32
    workspace of partial gradient sums (CUDA only)."""
    params = (ls, lb, w1, b1, w2, b2, gamma)
    _check(h, *params)
    if not _on_cuda(h):
        raise ValueError("bwd_partials is the CUDA kernel alone; use bwd")
    if dout.shape != h.shape or dout.dtype != h.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match h {tuple(h.shape)} {h.dtype}")
    lib = _kernels()
    r, c = h.shape
    _kernel_width(c, h.device)
    h, dout = h.contiguous(), dout.contiguous()
    params = [t.contiguous() for t in params]
    s = splits(r, c)
    dh = torch.empty_like(h)
    ws = torch.empty((s, slot_floats(c)), dtype=torch.float32,
                     device=h.device)
    _raise_on(lib.fused_mlp_bwd(*_ptrs(h, *params, dout, dh, ws), r, c, eps,
                                s, int(h.dtype == torch.bfloat16),
                                _stream(h)), "fused_mlp_bwd")
    LAUNCHES["bwd"] += 1
    return dh, ws


def reduce_partials(ws):
    """The reduce kernel: the workspace's slots summed in slot order,
    one fp32 vector (CUDA only)."""
    if not _on_cuda(ws) or ws.dtype != torch.float32 or ws.dim() != 2:
        raise ValueError("reduce_partials takes a CUDA fp32 (S, n) "
                         "workspace")
    ws = ws.contiguous()
    out = torch.empty(ws.shape[1], dtype=torch.float32, device=ws.device)
    _raise_on(_kernels().fused_mlp_reduce(ws.data_ptr(), out.data_ptr(),
                                          ws.shape[0], ws.shape[1],
                                          _stream(ws)), "fused_mlp_reduce")
    LAUNCHES["reduce"] += 1
    return out


def split_grads(flat, c):
    """``(dw1, db1, dw2, dgamma, dls, dlb)`` views of the reduced flat
    fp32 gradient vector."""
    h4 = 4 * c
    sizes = (c * h4, h4 * c, h4, c, c, c)
    dw1, dw2, db1, dgamma, dls, dlb = torch.split(flat, sizes)
    return dw1.view(c, h4), db1, dw2.view(h4, c), dgamma, dls, dlb


def bwd(h, ls, lb, w1, b1, w2, b2, gamma, dout, eps=1e-6):
    """``(dh, dw1, db1, dw2, dgamma, dls, dlb)``: the backward and reduce
    kernels on CUDA, ``bwd_plain`` on the CPU."""
    if not _on_cuda(h):
        _check(h, ls, lb, w1, b1, w2, b2, gamma)
        return bwd_plain(h, ls, lb, w1, b1, w2, b2, gamma, dout, eps=eps)
    dh, ws = bwd_partials(h, ls, lb, w1, b1, w2, b2, gamma, dout, eps=eps)
    return (dh, *split_grads(reduce_partials(ws), h.shape[1]))


class FusedMLP(torch.autograd.Function):
    """The fused block on ``(R, C)`` rows with the remat backward: saves
    the inputs only (``_fused_core`` of the JAX package)."""

    @staticmethod
    def forward(ctx, resid, h, ls, lb, w1, b1, w2, b2, gamma, eps):
        ctx.eps = eps
        ctx.save_for_backward(h, ls, lb, w1, b1, w2, b2, gamma)
        return fwd(resid, h, ls, lb, w1, b1, w2, b2, gamma, eps)

    @staticmethod
    def backward(ctx, dout):
        h, ls, lb, w1, b1, w2, b2, gamma = ctx.saved_tensors
        dh, dw1, db1, dw2, dgamma, dls, dlb = bwd(
            h, ls, lb, w1, b1, w2, b2, gamma, dout, ctx.eps)
        # d(out)/d(b2) = gamma per channel: one reduce over the
        # cotangent, outside the kernels (as in the JAX package).
        db2 = dout.float().sum(0) * gamma.float()
        # d(out)/d(resid) is the identity.
        return (dout, dh, dls.to(ls.dtype), dlb.to(lb.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), dgamma.to(gamma.dtype), None)


def fused_mlp_block(resid, h, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                    *, eps: float = 1e-6):
    """Fused [LN -> C->4C -> GELU -> 4C->C -> layer-scale -> residual].

    ``resid`` is the block input (the residual stream) and ``h`` the
    depthwise-conv output the LayerNorm reads, both ``(..., C)`` (rows
    are flattened; ragged row counts are masked in the kernels, not
    padded). Parameters are cast to the activation dtype first, as the
    JAX package does; their gradients flow back through the cast."""
    if resid.shape != h.shape:
        raise ValueError(f"resid/h shape mismatch: {tuple(resid.shape)} vs "
                         f"{tuple(h.shape)}")
    shape = h.shape
    c = shape[-1]
    cd = resid.dtype
    params = (t.to(cd) for t in (ln_scale, ln_bias, w1, b1, w2, b2, gamma))
    out = FusedMLP.apply(resid.reshape(-1, c), h.reshape(-1, c).to(cd),
                         *params, float(eps))
    return out.reshape(shape)
