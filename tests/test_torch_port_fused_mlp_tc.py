"""The bf16 fused-MLP backward's decomposition against the JAX package on
the CPU.

On the card the bf16 backward is two tensor-core kernels
(``csrc/fused_mlp.cu``): a row pass that writes dh, the bf16 operands of
the weight products (y1, dout * gamma, GELU(a), da) and per-row-tile
partial sums of db1, dgamma, dls and dlb; then a weight-gradient pass
that computes dW1 = y1^T da and dW2 = GELU(a)^T do in 64 x 64 output
tiles over fixed row ranges, each range writing one workspace slot that
also carries the sum of its row tiles' vector partials; then the reduce
sums the slots in order. Here that decomposition is emulated in plain
torch with the wrapper's own geometry (``tc_rows``, ``row_ranges``,
``slot_floats``, ``reduce_plain``, ``split_grads``), put behind the
autograd Function in place of ``bwd``, and its gradients are held to
JAX's interpret-mode ``fused_mlp_block`` VJP on the same cotangent, at
the tolerances of ``tests/test_torch_port_convnext.py``: max-relative
1e-4 in fp32 compute, 3e-2 in bf16. The geometry tests pin that the
ranges and the workspace depend on the shape alone and that the plan
still fuses every ConvNeXt-T block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagent_tpu.ops.fused_mlp import fused_mlp_block as jax_fused_block
from imagent_tpu_torch.config import Config
from imagent_tpu_torch.engine import _fused_mlp_plan_line
from imagent_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(2)

NAMES = "resid h ln_scale ln_bias w1 b1 w2 b2 gamma".split()
SHAPE = (3, 7, 11)  # 231 rows: ragged at the 128-row tiles and ranges
# ConvNeXt-T at 224 px, B=64: (width, rows) of its four stages.
CONVNEXT_T = ((96, 200704), (192, 50176), (384, 12544), (768, 3136))


def _block_args(seed, c):
    rng = np.random.default_rng(seed)
    sizes = [(*SHAPE, c), (*SHAPE, c), (c,), (c,), (c, 4 * c), (4 * c,),
             (4 * c, c), (c,), (c,)]
    return [(rng.normal(size=s) * 0.5).astype(np.float32) for s in sizes]


def _tiled_atb(x, y):
    """x^T y (fp32) computed tile by tile over WGRAD_TILE^2 output
    tiles, as the weight-gradient pass does."""
    t = fm.WGRAD_TILE
    out = torch.empty(x.shape[1], y.shape[1])
    for m0 in range(0, x.shape[1], t):
        for n0 in range(0, y.shape[1], t):
            out[m0:m0 + t, n0:n0 + t] = (x[:, m0:m0 + t].float().t()
                                         @ y[:, n0:n0 + t].float())
    return out


def emulated_bwd(h, ls, lb, w1, b1, w2, b2, gamma, dout, eps=1e-6):
    """``bwd``'s outputs computed the way the tensor-core kernels
    decompose them: operands rounded to the compute dtype at the TPU
    kernel's points, vector partials per row tile of ``tc_rows(c)``
    rows, dW1/dW2 per row range and output tile, one workspace slot per
    range, ``reduce_plain``, ``split_grads``."""
    cd = w1.dtype
    r, c = h.shape
    xn, rsig = fm._ln_fwd(h.float(), eps)
    y1c = (xn * ls.float() + lb.float()).to(cd)
    a = y1c.float() @ w1.float() + b1.float()
    gac = fm._gelu(a).to(cd)
    o = gac.float() @ w2.float() + b2.float()
    g = dout.float()
    doc = (g * gamma.float()).to(cd)
    da = (doc.float() @ w2.float().t()) * fm._gelu_grad(a)
    dac = da.to(cd)
    dy1 = dac.float() @ w1.float().t()
    dxn = dy1 * ls.float()
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    dh = (rsig * (dxn - m1 - xn * m2)).to(h.dtype)

    bm = fm.tc_rows(c)  # the row pass: one vector partial per row tile
    vec = torch.stack([torch.cat([
        da[t:t + bm].sum(0), (g * o)[t:t + bm].sum(0),
        (dy1 * xn)[t:t + bm].sum(0), dy1[t:t + bm].sum(0)])
        for t in range(0, r, bm)])
    s, length = fm.row_ranges(r, c)  # the weight-gradient pass
    ws = torch.empty(s, fm.slot_floats(c))
    for k in range(s):
        rows = slice(k * length, min(r, (k + 1) * length))
        tiles = vec[k * length // bm:-(-min(r, (k + 1) * length) // bm)]
        vsum = tiles[0].clone()
        for t in tiles[1:]:
            vsum += t
        ws[k] = torch.cat([_tiled_atb(y1c[rows], dac[rows]).flatten(),
                           _tiled_atb(gac[rows], doc[rows]).flatten(), vsum])
    return (dh, *fm.split_grads(fm.reduce_plain(ws), c))


@pytest.mark.parametrize("c", [16, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_tc_backward_matches_jax_vjp(c, dtype, monkeypatch):
    args = _block_args(200 + c, c)
    cot = np.random.default_rng(c).normal(size=(*SHAPE, c)).astype(
        np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jargs = [jnp.asarray(args[0], jd), jnp.asarray(args[1], jd),
             *map(jnp.asarray, args[2:])]
    _, vjp = jax.vjp(lambda *a: jax_fused_block(*a, block_rows=16), *jargs)
    want = vjp(jnp.asarray(cot, jd))

    monkeypatch.setattr(fm, "bwd", emulated_bwd)
    ts = [torch.from_numpy(args[0]).to(td).requires_grad_(True),
          torch.from_numpy(args[1]).to(td).requires_grad_(True),
          *(torch.from_numpy(a).requires_grad_(True) for a in args[2:])]
    out = fm.fused_mlp_block(*ts)
    out.backward(torch.from_numpy(cot).to(td))
    tol = 1e-4 if dtype == "float32" else 3e-2
    for name, t, w in zip(NAMES, ts, want):
        w = np.asarray(w, np.float32)
        got = t.grad.float().numpy()
        err = np.max(np.abs(got - w)) / (np.max(np.abs(w)) + 1e-6)
        assert err < tol, (name, err)


def test_row_ranges_depend_on_the_shape_alone():
    """22 / 8 / 2 / 1 ranges at the ConvNeXt-T stages, multiples of
    RANGE_ROWS, covering every row; the same for fp32's slots as
    before; no argument names a device."""
    got = [fm.row_ranges(r, c) for c, r in CONVNEXT_T]
    assert got == [(22, 9216), (8, 6272), (2, 6272), (1, 3200)]
    for (c, r), (s, length) in zip(CONVNEXT_T, got):
        assert length % fm.RANGE_ROWS == 0
        assert length % fm.tc_rows(c) == 0
        assert (s - 1) * length < r <= s * length
        assert fm.splits(r, c, torch.bfloat16) == s
        assert fm.wgrad_tiles(c) * s >= fm.WGRAD_BLOCKS  # fills the SMs
    assert [fm.splits(r, c) for c, r in CONVNEXT_T] == [902, 226, 128, 128]
    assert fm.row_ranges(231, 16) == (2, 128)
    assert fm.row_ranges(1, 768) == (1, 128)


def test_bf16_workspace_is_tens_of_mb():
    """The bf16 workspace per launch at the ConvNeXt-T stages, and per
    train step (depths 3/3/9/3), against the fp32 design's slots."""
    depths = (3, 3, 9, 3)
    ws = [fm.splits(r, c, torch.bfloat16) * fm.slot_floats(c) * 4
          for c, r in CONVNEXT_T]
    assert max(ws) < 20e6
    step = sum(d * b for d, b in zip(depths, ws))
    old = sum(d * fm.splits(r, c) * fm.slot_floats(c) * 4
              for d, (c, r) in zip(depths, CONVNEXT_T))
    assert step < 0.2e9 < 14e9 < old


@pytest.mark.parametrize("c,rows", [(96, 128), (192, 64), (384, 32),
                                    (768, 16), (16, 128), (200, 32)])
def test_tc_geometry_fits_and_fuses(c, rows):
    """Backward row tiles shrink with the width so o and dy1 stay within
    96 registers a lane; both dtypes' shared memory fits an H100; the
    plan fuses every ConvNeXt-T block and refuses widths past MAX_DIM."""
    assert fm.tc_rows(c) == rows
    assert fm.tc_rows(c, backward=False) >= rows
    assert fm.smem_bytes(c, torch.bfloat16) <= fm.H100_SMEM_OPTIN
    assert fm.smem_bytes(c) <= fm.H100_SMEM_OPTIN
    assert fm.unfused_reason("on", c) is None
    cfg = Config(arch="convnext_tiny", fused_mlp="on")
    assert _fused_mlp_plan_line(cfg, torch.device("cpu")).endswith(
        "(18/18 blocks fused)")
    assert fm.unfused_reason("on", fm.MAX_DIM + 8) == "smem"
