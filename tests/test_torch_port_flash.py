"""The port's flash attention (imagent_tpu_torch/ops/flash_attention.py)
against the JAX package's: the plain versions of the three kernels and
the autograd.Function, on the CPU, from the same numpy inputs.

JAX side: ``flash_attention`` and ``_flash_fwd_impl`` in interpret mode
(the Pallas kernels run on the CPU, as tests/test_flash_attention.py runs
them) and the einsum ``dot_product_attention``. Tolerances are the JAX
package's own for its kernel: 2e-5 forward, 5e-5 gradients.

The CUDA kernels themselves run only on a card (``cuda`` marker):
chip_smoke.py holds them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagent_tpu.ops.attention import dot_product_attention as jax_dpa
from imagent_tpu.ops.flash_attention import _flash_fwd_impl
from imagent_tpu.ops.flash_attention import flash_attention as jax_flash
from imagent_tpu_torch.ops import flash_attention as fa
from imagent_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(2)

FWD_TOL = 2e-5   # tests/test_flash_attention.py:27
GRAD_TOL = 5e-5  # tests/test_flash_attention.py:53


def _qkvo(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32)
            for _ in range(4)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,block", [(64, 32), (50, 16)])
def test_forward_and_lse_match_jax_kernel(n, block):
    q, k, v, _ = _qkvo(0, 2, n, 3, 16)
    want = np.asarray(jax_flash(q, k, v, block_q=block, block_k=block,
                                interpret=True))
    o, lse = fa.fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_dpa(q, k, v)),
                               atol=FWD_TOL, rtol=FWD_TOL)

    def bhd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, n, 16)

    _, lse_want = _flash_fwd_impl(bhd(q), bhd(k), bhd(v), block_q=block,
                                  block_k=block, interpret=True)
    np.testing.assert_allclose(lse.reshape(-1, n).numpy(),
                               np.asarray(lse_want), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("n,block", [(64, 32), (50, 16)])
def test_backward_kernels_and_function_match_jax(n, block):
    q, k, v, g = _qkvo(1, 2, n, 2, 16)

    def loss(q, k, v):  # the cotangent of O is g
        return jnp.sum(jax_flash(q, k, v, block_q=block, block_k=block,
                                 interpret=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want_ref = jax.grad(lambda q, k, v: jnp.sum(jax_dpa(q, k, v) * g),
                        argnums=(0, 1, 2))(q, k, v)

    # The three plain kernels, called as the backward calls them.
    tq, tk, tv, tg = map(_t, (q, k, v, g))
    o, lse = fa.fwd(tq, tk, tv)
    di = fa.delta(tg, o)
    dq = fa.dq(tq, tk, tv, tg, lse, di)
    dk, dv = fa.dkv(tq, tk, tv, tg, lse, di)
    # And the autograd.Function end to end.
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    (fa.flash_attention(*leaves) * tg).sum().backward()
    for name, got, fn_got, w, w_ref in zip(
            "qkv", (dq, dk, dv), (x.grad for x in leaves), want, want_ref):
        for arr in (got, fn_got):
            np.testing.assert_allclose(arr.numpy(), np.asarray(w),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(arr.numpy(), np.asarray(w_ref),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=name)


def test_plain_attention_matches_jax_and_flash():
    q, k, v, _ = _qkvo(2, 2, 50, 4, 8)
    got = dot_product_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_dpa(q, k, v)),
                               atol=FWD_TOL, rtol=FWD_TOL)
    flash = fa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(flash, got, atol=FWD_TOL, rtol=FWD_TOL)


def test_strided_inputs_and_cpu_dispatch():
    """A fused-QKV slice (strided, not contiguous) gives the same result
    as contiguous inputs; CPU tensors take the plain path and never
    count a kernel launch."""
    rng = np.random.default_rng(3)
    qkv = _t(rng.normal(size=(2, 33, 3 * 4 * 16)).astype(np.float32))
    q, k, v = (qkv[..., i * 64:(i + 1) * 64].unflatten(-1, (4, 16))
               for i in range(3))
    assert not q.is_contiguous()
    fa.reset_launches()
    o, lse = fa.fwd(q, k, v)
    o2, lse2 = fa.fwd(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(o, o2, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse2, atol=0, rtol=0)
    assert fa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


def test_bf16_plain_types():
    q, k, v, _ = _qkvo(4, 1, 20, 2, 8)
    o, lse = fa.fwd(*(_t(x).bfloat16() for x in (q, k, v)))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = np.asarray(jax_dpa(q, k, v))
    np.testing.assert_allclose(o.float().numpy(), ref, atol=3e-2)


@pytest.mark.parametrize("bad", ["dim", "dtype"])
def test_rejects_unsupported_inputs(bad):
    shape = (1, 8, 2, 24 if bad == "dim" else 16)
    dtype = torch.float16 if bad == "dtype" else torch.float32
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError):
        fa.fwd(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(197, 64), (50, 16), (33, 80), (40, 128)])
def test_cuda_kernels_match_plain(n, d, dtype):
    """Each CUDA kernel against its plain version on the card (the same
    check chip_smoke.py makes); fp32 at 1e-4, bf16 within two ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-3, 1 / 64)
    g = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v, do = (torch.randn((2, n, 3, d), generator=g, device="cuda")
                   .to(dt) for _ in range(4))
    o, lse = fa.fwd(q, k, v)
    o_p, lse_p = fa.fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    di = fa.delta(do, o_p)
    torch.testing.assert_close(fa.dq(q, k, v, do, lse_p, di).float(),
                               fa.dq_plain(q, k, v, do, lse_p, di).float(),
                               atol=atol, rtol=rtol)
    for got, want in zip(fa.dkv(q, k, v, do, lse_p, di),
                         fa.dkv_plain(q, k, v, do, lse_p, di)):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
