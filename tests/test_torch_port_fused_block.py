"""The port's fused bottleneck (imagent_tpu_torch/ops/fused_block.py)
against the JAX package on the CPU, on numpy-seeded inputs:

* the plain ``reference_bottleneck`` against JAX's ``fused_bottleneck``
  (Pallas in interpret mode) and JAX's ``reference_bottleneck``, at the
  JAX package's own bounds (fp32 1e-5, bf16 3e-2,
  ``tests/test_fused_block.py:38``), H != W, biases from N(0, 1) so that
  a relu(b1) halo outside the image would show;
* ``fold_bn`` exactness, and the port's eval-mode ``Bottleneck`` equal to
  ``reference_bottleneck`` with its BN folded, at 2e-4
  (``tests/test_fused_block.py:96``);
* the kernel's tile plan at each ResNet-50 identity geometry, for the
  fp32 kernel (``plan``) and the bf16 tensor-core kernel (``plan_tc``),
  with their shared-memory formulas, and the wrapper's refusal of CPU
  tensors (the kernel has no CPU mode).

The CUDA kernel itself runs only on a card (``cuda`` marker); there it is
held to the plain version here, and two bf16 runs must be bitwise
identical. ``test_torch_port_fused_block_tc.py`` emulates the bf16
kernel's decomposition on the CPU.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagent_tpu.ops.fused_block import fold_bn as jax_fold_bn
from imagent_tpu.ops.fused_block import fused_bottleneck as jax_fused
from imagent_tpu.ops.fused_block import reference_bottleneck as jax_reference
from imagent_tpu_torch.models.resnet import Bottleneck
from imagent_tpu_torch.ops import fused_block as fb

torch.set_num_threads(2)

B, H, W, C, F = 4, 6, 9, 32, 16


def _args(seed, b=B, h=H, w=W, c=C, f=F):
    """``[x, w1, b1, w3, b3, wc, bc]`` as numpy fp32: weights scaled by
    fan-in, biases from N(0, 1)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * k for s, k in (
        ((b, h, w, c), 1.0), ((c, f), c ** -0.5), ((f,), 1.0),
        ((3, 3, f, f), (9 * f) ** -0.5), ((f,), 1.0), ((f, c), f ** -0.5),
        ((c,), 1.0))]


def _cast(args, dtype):
    """x and the weights in ``dtype``, the biases fp32 (torch or JAX
    arrays)."""
    return [(a.to(dtype) if torch.is_tensor(a) else a.astype(dtype))
            if i in (0, 1, 3, 5) else a for i, a in enumerate(args)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_jax_kernel_and_reference(dtype):
    args = _args(0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = _cast([jnp.asarray(a) for a in args], jd)
    got = fb.reference_bottleneck(*_cast([torch.from_numpy(a)
                                          for a in args], td))
    assert got.dtype == td and got.shape == (B, H, W, C)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for want in (jax_fused(*jargs, batch_tile=2, interpret=True),
                 jax_reference(*jargs)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_fold_bn_exactness():
    """conv + eval-BN == folded conv + bias, and the same fold as JAX's."""
    rng = np.random.default_rng(1)
    k = rng.normal(size=(C, F)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, F).astype(np.float32)
    bias = rng.normal(size=F).astype(np.float32)
    mean = rng.normal(size=F).astype(np.float32)
    var = rng.uniform(0.1, 2.0, F).astype(np.float32)
    x = rng.normal(size=(5, C)).astype(np.float32)
    want = (x @ k - mean) / np.sqrt(var + 1e-5) * scale + bias
    kf, bf = fb.fold_bn(*map(torch.from_numpy, (k, scale, bias, mean, var)))
    np.testing.assert_allclose((torch.from_numpy(x) @ kf + bf).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    jk, jb = jax_fold_bn(*map(jnp.asarray, (k, scale, bias, mean, var)))
    np.testing.assert_allclose(kf.numpy(), np.asarray(jk), rtol=1e-6)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_eval_bottleneck_equals_folded_reference():
    """The port's eval-mode stride-1 identity Bottleneck == the plain
    fused computation with each BN folded from its running statistics."""
    torch.manual_seed(2)
    block = Bottleneck(4 * F, F).eval()
    with torch.no_grad():
        for m in block.modules():
            if hasattr(m, "running_var"):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape))
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.copy_(0.2 * torch.randn(m.bias.shape))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, H, W, 4 * F)).astype(np.float32))
    with torch.no_grad():
        want = block(x)

        def fold(conv, bn, kernel):
            return fb.fold_bn(kernel, bn.weight, bn.bias, bn.running_mean,
                              bn.running_var)
        w1, b1 = fold(block.Conv_0, block.BatchNorm_0,
                      block.Conv_0.weight[:, :, 0, 0].t())
        w3, b3 = fold(block.Conv_1, block.BatchNorm_1,
                      block.Conv_1.weight.permute(2, 3, 1, 0))
        wc, bc = fold(block.Conv_2, block.BatchNorm_2,
                      block.Conv_2.weight[:, :, 0, 0].t())
        got = fb.reference_bottleneck(x, w1, b1, w3, b3, wc, bc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_fused_bottleneck_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _args(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fb.fused_bottleneck(*args)
    with pytest.raises(ValueError, match="b1 must be"):
        fb.fused_bottleneck(*_cast(args, torch.bfloat16)[:2],
                            args[2].bfloat16(), *args[3:])


# A bf16 case of the plan test: the batch, C, and the launch plan_tc must
# choose (tile, blocks per tile, warps across the columns per step).
_TC = collections.namedtuple("_TC", "b c th tw split wn")


@pytest.mark.parametrize("hw,f,tile", [
    (56, 64, (4, 8)), (28, 128, (6, 6)), (14, 256, (4, 8)), (7, 512, (4, 8)),
    (9, 40, (6, 6)),
    pytest.param(56, 64, _TC(64, 256, 14, 28, 1, (2, 2, 8)),
                 id="bfloat16-56-64"),
    pytest.param(28, 128, _TC(64, 512, 14, 14, 1, (4, 2, 2)),
                 id="bfloat16-28-128"),
    pytest.param(14, 256, _TC(64, 1024, 7, 14, 1, (8, 4, 4)),
                 id="bfloat16-14-256"),
    pytest.param(7, 512, _TC(64, 2048, 7, 7, 2, (4, 8, 8)),
                 id="bfloat16-7-512")])
def test_plan_at_resnet50_geometries(hw, f, tile):
    """fp32: the fewest tiles whose shared memory fits an H100 (232,448
    bytes opt-in): the halo of every tile is one 64-row GEMM pass. bf16
    (``_TC`` cases, B=64): the launch of least ``tc_cost`` on 132 SMs,
    within the same limit (the fastest of ``chip_smoke.py
    --block-plans``' timed launches, or within 0.5% of it); at 7x7 a
    whole image shared by a cluster of two blocks."""
    if isinstance(tile, _TC):
        assert fb.plan_tc(tile.b, hw, hw, tile.c, f) == tile[2:]
        assert fb.tile(tile.b, hw, hw, tile.c, f, torch.bfloat16) == tile[2:]
        assert fb.smem_bytes(tile.th, tile.tw, f, torch.bfloat16) \
            <= fb.H100_SMEM_OPTIN
        # the geometry table, y1 over the 9 x 9 halo and y2 over the 7 x 7
        # tile (512 channels + 8 of pitch), two stages of 23,040 elements
        assert fb.smem_bytes(7, 7, 512, torch.bfloat16) == \
            128 + 2 * ((81 + 49) * 520 + 2 * 23040)
        return
    assert fb.plan(hw, hw, f) == tile
    th, tw = tile
    assert (th + 2) * (tw + 2) <= fb.ROWS
    assert fb.smem_bytes(th, tw, f) <= fb.H100_SMEM_OPTIN
    assert fb.smem_bytes(6, 6, 512) == 4 * (512 * 65 + 512 * 37 + 32 * 65
                                            + 32 * 64)


def test_plan_refuses_a_width_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        fb.plan(7, 7, 8192)
    with pytest.raises(ValueError, match="does not fit"):
        fb.plan_tc(1, 7, 7, 64, 16384)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 11, 96, 40), (3, 7, 7, 256, 64),
                                   (2, 14, 14, 128, 32), (2, 7, 7, 100, 36),
                                   (3, 7, 9, 512, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, w, c, f = shape
    args = _cast([torch.from_numpy(a).cuda()
                  for a in _args(5, b, h, w, c, f)], getattr(torch, dtype))
    before = fb.LAUNCHES["fused_block"]
    got = fb.fused_bottleneck(*args)
    assert fb.LAUNCHES["fused_block"] == before + 1
    want = fb.reference_bottleneck(*args)
    # bf16: y1 and y2 are rounded inside the chain (chip_smoke.py's
    # _BLOCK_TOL, the JAX package's 3e-2).
    tol = 1e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 9, 11, 96, 40), (2, 7, 7, 100, 36),
                                   (3, 7, 9, 512, 200)])
def test_cuda_bf16_kernel_is_bitwise_repeatable(shape):
    """Every output is written once, with no atomics, also where two
    blocks of a cluster share a tile ((3, 7, 9, 512, 200) plans a split)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, w, c, f = shape
    args = _cast([torch.from_numpy(a).cuda()
                  for a in _args(6, b, h, w, c, f)], torch.bfloat16)
    assert torch.equal(fb.fused_bottleneck(*args), fb.fused_bottleneck(*args))
