"""The bf16 tensor-core fused-block kernel's decomposition
(``block_tc_kernel`` of imagent_tpu_torch/csrc/fused_block.cu), emulated
in torch on the CPU and held to the JAX package's ``fused_bottleneck``
(Pallas in interpret mode) on numpy-seeded inputs:

* output tiles of ``th`` x ``tw`` pixels (the plan's, a ragged one and a
  whole image), each with its one-pixel halo;
* step 1 over the halo rows, y1 set to 0 at pixels outside the image;
* step 2 as the 9-tap implicit GEMM: output pixel q of a tile reads y1's
  halo row (q // tw + dy) * (tw + 2) + q % tw + dx;
* K summed chunk by chunk in the kernel's order (``TC_KC`` channels of
  x, then of y1 tap by tap, then of y2), F and C zero-padded to whole
  chunks (``tc_fp``);
* y1 and y2 rounded to the working dtype before the next product.

At B=2, 9 x 7 px, C=40 and F=24 (neither a multiple of 16), at the JAX
package's bounds (``tests/test_fused_block.py:38``): fp32 1e-5, bf16
3e-2 + 3e-2 |ref|. The kernel itself runs on the card
(``test_torch_port_fused_block.py``, ``cuda`` marker, and
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagent_tpu.ops.fused_block import fused_bottleneck as jax_fused
from imagent_tpu_torch.ops import fused_block as fb

torch.set_num_threads(2)

B, H, W, C, F = 2, 9, 7, 40, 24


def _args(seed):
    """``[x, w1, b1, w3, b3, wc, bc]`` as numpy fp32: weights scaled by
    fan-in, biases from N(0, 1) (so relu(b1) outside the image would
    show)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * k for s, k in (
        ((B, H, W, C), 1.0), ((C, F), C ** -0.5), ((F,), 1.0),
        ((3, 3, F, F), (9 * F) ** -0.5), ((F,), 1.0), ((F, C), F ** -0.5),
        ((C,), 1.0))]


def _padded(t, *sizes):
    """``t`` widened to fp32 and zero-padded at the end of each dim to
    ``sizes``."""
    out = torch.zeros(sizes)
    out[tuple(slice(0, n) for n in t.shape)] = t.float()
    return out


def _chunked(a, w, kc):
    """a @ w summed in fp32 chunk by chunk over K (the kernel's order of
    the chunks; within a chunk the tensor core's)."""
    acc = torch.zeros(a.shape[:-1] + w.shape[-1:])
    for k0 in range(0, a.shape[-1], kc):
        acc += a[..., k0:k0 + kc] @ w[k0:k0 + kc]
    return acc


def emulate(x, w1, b1, w3, b3, wc, bc, th, tw):
    """The kernel's bf16 plan on the CPU, tile by tile (see the module
    docstring); every product in fp32 on operands of ``x``'s dtype."""
    dt = x.dtype
    b, h, w, c = x.shape
    f = w1.shape[1]
    fp, cp, kc = fb.tc_fp(f), fb.tc_fp(c), fb.TC_KC
    xp = _padded(x, b, h, w, cp)
    w1p, w3p = _padded(w1, cp, fp), _padded(w3, 3, 3, fp, fp)
    wcp = _padded(wc, fp, c)
    b1p, b3p = _padded(b1, fp), _padded(b3, fp)
    out = torch.empty(b, h, w, c)
    pw = tw + 2
    q = torch.arange(th * tw)
    base = (q // tw) * pw + q % tw  # halo row of output q at tap (0, 0)
    for h0 in range(0, h, th):
        for w0 in range(0, w, tw):
            ih = torch.arange(h0 - 1, h0 + th + 1)
            iw = torch.arange(w0 - 1, w0 + tw + 1)
            inside = (((ih >= 0) & (ih < h))[:, None]
                      & ((iw >= 0) & (iw < w))[None, :]).reshape(-1)
            halo = xp[:, ih.clamp(0, h - 1)][:, :, iw.clamp(0, w - 1)]
            halo = halo.reshape(b, -1, cp) * inside[None, :, None]
            y1 = torch.relu(_chunked(halo, w1p, kc) + b1p)
            y1 = (y1 * inside[None, :, None]).to(dt).float()
            acc = torch.zeros(b, th * tw, fp)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                acc += _chunked(y1[:, base + dy * pw + dx], w3p[dy, dx], kc)
            y2 = torch.relu(acc + b3p).to(dt).float()
            y3 = _chunked(y2, wcp, kc) + bc
            y3 = y3.reshape(b, th, tw, c)[:, :min(th, h - h0),
                                          :min(tw, w - w0)]
            res = x[:, h0:h0 + th, w0:w0 + tw].float()
            out[:, h0:h0 + th, w0:w0 + tw] = torch.relu(y3 + res)
    return out.to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_tc_plan_matches_jax_kernel(dtype):
    args = _args(7)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    cast = [0, 1, 3, 5]  # x and the weights in dtype, the biases fp32
    targs = [torch.from_numpy(a).to(td) if i in cast else torch.from_numpy(a)
             for i, a in enumerate(args)]
    jargs = [jnp.asarray(a, jd) if i in cast else jnp.asarray(a)
             for i, a in enumerate(args)]
    want = np.asarray(jax_fused(*jargs, batch_tile=B, interpret=True),
                      np.float32)
    tol = 1e-5 if dtype == "float32" else 3e-2
    plan = fb.plan_tc(B, H, W, C, F)
    # the planned tile, a ragged one and the whole image
    for tile in ((plan.th, plan.tw), (4, 5), (H, W)):
        got = emulate(*targs, *tile)
        assert got.dtype == td and got.shape == (B, H, W, C)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol, err_msg=f"tile {tile}")
