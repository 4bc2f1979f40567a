"""Flash attention: hand-written CUDA kernels for Hopper behind an
``autograd.Function``, with plain PyTorch versions of the same math.

Port of ``imagent_tpu/ops/flash_attention.py``. The three Pallas TPU
kernels there become three CUDA kernels in ``csrc/flash_attention.cu``
(see its header for the design and what bounds it on an H100):

* ``fwd`` replaces ``_fwd_kernel`` (``_flash_fwd_impl``): O and the
  per-row logsumexp LSE = m + log(l), fp32, compact ``(B, H, N)``;
* ``dq`` replaces ``_dq_kernel`` (``_flash_bhd_bwd``);
* ``dkv`` replaces ``_dkv_kernel`` (``_flash_bhd_bwd``).

``Di = rowsum(dO * O)`` stays a plain torch op (``delta``), as it lies
outside the Pallas kernels in the JAX package.

Layout: the public function keeps the JAX layout ``(B, N, H, D)``. The
kernels read q, k and v through their strides (a slice of a fused QKV
projection is used in place) and write contiguous ``(B, N, H, D)``.

Dispatch: a wrapper runs its plain version only for a tensor on the
CPU; for a CUDA tensor it launches its kernel or raises. ``LAUNCHES``
counts kernel launches per entry point.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (8, 16, 32, 64, 80, 128)
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 4 + [_L] * 3 + [_I, _P],
    "flash_dq": [_P] * 7 + [_I] * 4 + [_L] * 3 + [_I, _P],
    "flash_dkv": [_P] * 8 + [_I] * 4 + [_L] * 3 + [_I, _P],
}
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from imagent_tpu_torch.ops import _cuda
        lib = _cuda.load("flash_attention")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------- plain


def _scores(q, k):
    """S = Q.K^T * D^-0.5 in fp32, ``(B, H, N, N)``: input-type operands
    upcast exactly, fp32 accumulation."""
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def fwd_plain(q, k, v):
    """``(O, LSE)`` for ``(B, N, H, D)`` inputs: O in the input type,
    LSE fp32 ``(B, H, N)``."""
    s = _scores(q, k)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_and_ds(q, k, v, do, lse, di):
    p = torch.exp(_scores(q, k) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None])


def dq_plain(q, k, v, do, lse, di):
    _, ds = _p_and_ds(q, k, v, do, lse, di)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def dkv_plain(q, k, v, do, lse, di):
    p, ds = _p_and_ds(q, k, v, do, lse, di)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * q.shape[-1] ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def delta(do, o):
    """Di = rowsum(dO * O) in fp32, ``(B, H, N)`` — the JAX backward's
    outside-the-kernel reduction (``_flash_bhd_bwd``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# -------------------------------------------------------------- kernels


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, N, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported by the "
                         f"kernels; one of {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


def _on_cuda(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {t.device}")
    return True


def _aligned(t) -> bool:
    """Pointer and strides are whole 16-byte units: the bf16 kernels
    stage rows with 16-byte ``cp.async`` copies."""
    size = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s * size % 16 == 0 for s in t.stride()[:-1])


def _shared_strides(q, k, v):
    """q, k, v with unit last stride, 16-byte alignment and one shared
    stride set (the kernels take a single (sB, sN, sH)); copies only when
    needed."""
    if q.stride() == k.stride() == v.stride() \
            and all(_aligned(t) for t in (q, k, v)):
        return q, k, v
    return tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in (q, k, v))


def _geometry(q):
    b, n, h, d = q.shape
    sb, sn, sh, _ = q.stride()
    return (b, h, n, d, sb, sn, sh, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def fwd(q, k, v):
    """``(O, LSE)``: the forward kernel on CUDA, ``fwd_plain`` on CPU."""
    _check(q, k, v)
    if not _on_cuda(q):
        return fwd_plain(q, k, v)
    lib = _kernels()
    q, k, v = _shared_strides(q, k, v)
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _raise_on(lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), *_geometry(q)),
              "flash_fwd")
    LAUNCHES["fwd"] += 1
    return o, lse


def _bwd_inputs(q, k, v, do, lse, di):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    b, n, h, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, n) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {(b, h, n)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    q, k, v = _shared_strides(q, k, v)
    if not (do.is_contiguous() and _aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    return q, k, v, do, lse.contiguous(), di.contiguous()


def dq(q, k, v, do, lse, di):
    """dQ: the dQ kernel on CUDA, ``dq_plain`` on CPU."""
    if not _on_cuda(q):
        _check(q, k, v)
        return dq_plain(q, k, v, do, lse, di)
    lib = _kernels()
    q, k, v, do, lse, di = _bwd_inputs(q, k, v, do, lse, di)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _raise_on(lib.flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                           out.data_ptr(), *_geometry(q)), "flash_dq")
    LAUNCHES["dq"] += 1
    return out


def dkv(q, k, v, do, lse, di):
    """``(dK, dV)``: the dK/dV kernel on CUDA, ``dkv_plain`` on CPU."""
    if not _on_cuda(q):
        _check(q, k, v)
        return dkv_plain(q, k, v, do, lse, di)
    lib = _kernels()
    q, k, v, do, lse, di = _bwd_inputs(q, k, v, do, lse, di)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _raise_on(lib.flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), *_geometry(q)),
              "flash_dkv")
    LAUNCHES["dkv"] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """O = softmax(Q.K^T * D^-0.5).V with the flash backward: saves
    ``(q, k, v, o, lse)`` and recomputes P from the LSE (the JAX
    package's ``_flash_bhd`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        di = delta(do, o)
        dq_ = dq(q, k, v, do, lse, di)
        dk_, dv_ = dkv(q, k, v, do, lse, di)
        return dq_, dk_, dv_


def flash_attention(q, k, v):
    """Fused attention, drop-in for ``ops.attention.dot_product_attention``:
    ``(B, N, H, D)`` -> ``(B, N, H, D)``."""
    return FlashAttention.apply(q, k, v)
