"""The port's ConvNeXt slice against the JAX package on the CPU, on
numpy-seeded inputs:

* ``ops/fused_mlp.py``: the plain forward against JAX's
  ``fused_mlp_block`` (Pallas in interpret mode) at ragged row counts,
  at JAX's own tolerances (fp32 1e-5, bf16 3e-2,
  ``tests/test_fused_mlp.py``); the autograd Function's gradients for
  all nine inputs against JAX's custom VJP (fp32, max-relative 1e-4);
  the --fused-mlp plan rule;
* ``models/convnext.py`` + ``compat``: the Flax weight carry and its
  round trip, the published parameter counts, two-stage model logits
  (fp32, 2e-4: ``tests/test_torch_compat.py:161``) in every fused mode;
* ``train.py``: one AdamW step with ``--fused-mlp on`` against JAX's
  step (metric vector and every parameter at 1e-4, as the ViT step).

Layer scale starts at 1e-6, which would hide a broken MLP: every
comparison uses O(1) layer scales. The CUDA kernels run only on a card
(``cuda`` marker); there they are held to the plain versions here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagent_tpu.cluster import make_mesh
from imagent_tpu.models.convnext import (
    CONVNEXT_PARAM_COUNTS as JAX_COUNTS, ConvNeXt as JaxConvNeXt,
)
from imagent_tpu.ops.fused_mlp import fused_mlp_block as jax_fused_block
from imagent_tpu.ops.fused_mlp import reference_mlp_block as jax_reference
from imagent_tpu.train import (
    create_train_state as jax_state, make_optimizer as jax_optimizer,
    make_train_step as jax_step, replicate_state, shard_batch,
)
from imagent_tpu_torch.compat import (
    convnext_params_from_jax, convnext_params_to_jax,
)
from imagent_tpu_torch.config import Config
from imagent_tpu_torch.engine import _fused_mlp_plan_line
from imagent_tpu_torch.models import create_model
from imagent_tpu_torch.models.convnext import (
    CONVNEXT_DEFS, CONVNEXT_PARAM_COUNTS, ConvNeXt,
)
from imagent_tpu_torch.ops import fused_mlp as fm
from imagent_tpu_torch.train import (
    create_train_state, make_optimizer, make_train_step,
)

torch.set_num_threads(2)

DEPTHS, DIMS = (1, 1), (16, 32)
CLASSES = 10
LOGIT_TOL = 2e-4
STEP_TOL = 1e-4
MEAN = STD = (0.5, 0.5, 0.5)
NAMES = "resid h ln_scale ln_bias w1 b1 w2 b2 gamma".split()


def _block_args(seed, c, shape=(2, 5, 5)):
    """The nine block inputs as numpy fp32, N(0, 0.5) as the JAX
    package's kernel tests draw them (so gamma is O(1))."""
    rng = np.random.default_rng(seed)
    sizes = [(*shape, c), (*shape, c), (c,), (c,), (c, 4 * c), (4 * c,),
             (4 * c, c), (c,), (c,)]
    return [(rng.normal(size=s) * 0.5).astype(np.float32) for s in sizes]


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_plain_matches_jax_kernel(c, dtype):
    args = _block_args(c, c)  # 2 x 5 x 5 = 50 rows: ragged at both tiles
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = jax_fused_block(jnp.asarray(args[0], jd), jnp.asarray(args[1], jd),
                           *map(jnp.asarray, args[2:]), block_rows=16)
    rows = [torch.from_numpy(a).reshape(-1, c).to(td) for a in args[:2]]
    params = [torch.from_numpy(a).to(td) for a in args[2:]]
    got = fm.fwd_plain(*rows, *params)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(
        got.float().numpy().reshape(want.shape),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_block_matches_jax_reference(dtype):
    """The unfused oracles agree (fp32 parameters cast to the activation
    dtype inside both)."""
    args = _block_args(5, 32, shape=(3, 7))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_reference(jnp.asarray(args[0], jd), jnp.asarray(args[1], jd),
                         *map(jnp.asarray, args[2:]))
    td = getattr(torch, dtype)
    got = fm.reference_mlp_block(torch.from_numpy(args[0]).to(td),
                                 torch.from_numpy(args[1]).to(td),
                                 *map(torch.from_numpy, args[2:]))
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("c", [16, 32])
def test_autograd_grads_match_jax_custom_vjp(c):
    args = _block_args(100 + c, c)

    def jax_loss(a):
        return jnp.sum(jnp.square(jax_fused_block(*a, block_rows=16)))

    want = jax.grad(jax_loss)([jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fm.fused_mlp_block(*ts)
    torch.sum(torch.square(out)).backward()
    for name, t, w in zip(NAMES, ts, want):
        w = np.asarray(w)
        err = np.max(np.abs(t.grad.numpy() - w)) / (np.max(np.abs(w)) + 1e-6)
        assert err < 1e-4, (name, err)


def test_autograd_grads_cast_like_jax_in_bf16():
    """bf16 activations with fp32 parameters: every gradient comes back
    in its input's dtype, dresid is dout itself."""
    args = _block_args(7, 16)
    resid, h = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                for a in args[:2])
    params = [torch.from_numpy(a).requires_grad_(True) for a in args[2:]]
    out = fm.fused_mlp_block(resid, h, *params)
    assert out.dtype == torch.bfloat16
    dout = torch.ones_like(out)
    out.backward(dout)
    assert resid.grad.dtype == h.grad.dtype == torch.bfloat16
    assert torch.equal(resid.grad, dout)
    assert all(p.grad.dtype == torch.float32 for p in params)


def test_plan_rule():
    for dim in (96, 192, 384, 768):
        assert fm.fused_block_rows("off", dim) is None
        assert fm.fused_block_rows("on", dim, dropping=True) is None
        assert fm.fused_block_rows("auto", dim) is None
        assert fm.fused_block_rows("auto", dim, device="cpu") is None
        assert fm.fused_block_rows("on", dim) == fm.FWD_ROWS
        assert fm.fused_block_rows("on", dim, device="cpu") == fm.FWD_ROWS
        assert fm.smem_bytes(dim) <= fm.H100_SMEM_OPTIN
    assert fm.fused_mlp_plan("on", (96, 192, 384, 768)) == {
        96: fm.FWD_ROWS, 192: fm.FWD_ROWS, 384: fm.FWD_ROWS,
        768: fm.FWD_ROWS}
    assert fm.fused_mlp_plan("auto", (96, 1024)) == {96: None, 1024: None}
    assert fm.unfused_reason("auto", 768, device="cpu") == "device"
    for dim in (1024, 1536):  # ConvNeXt-B/L's last stage
        assert fm.unfused_reason("on", dim) == "smem"
    assert fm.smem_bytes(768) == 200832
    with pytest.raises(ValueError, match="auto\\|on\\|off"):
        fm.fused_block_rows("always", 96)
    cfg = Config(arch="convnext_tiny", fused_mlp="on")
    assert _fused_mlp_plan_line(cfg, torch.device("cpu")) == (
        "fused-mlp on: C=96 fused, C=192 fused, C=384 fused, C=768 fused "
        "(18/18 blocks fused)")
    cfg = Config(arch="convnext_base", fused_mlp="auto")
    assert _fused_mlp_plan_line(cfg, torch.device("cpu")).endswith(
        "C=1024 unfused (smem) (0/36 blocks fused)")
    assert _fused_mlp_plan_line(Config(arch="convnext_tiny"),
                                torch.device("cpu")) is None


def test_param_counts_match_published():
    assert CONVNEXT_PARAM_COUNTS == JAX_COUNTS
    for arch, (depths, dims) in CONVNEXT_DEFS.items():
        with torch.device("meta"):
            model = ConvNeXt(depths, dims, num_classes=1000)
        n = sum(p.numel() for p in model.parameters())
        assert n == CONVNEXT_PARAM_COUNTS[arch], arch


def test_drop_path_refused():
    with pytest.raises(ValueError, match="not yet ported"):
        create_model("convnext_tiny", drop_path_rate=0.1)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The two-stage JAX model's params with O(1) layer scales."""
    model = JaxConvNeXt(depths=DEPTHS, dims=DIMS, num_classes=CLASSES)
    x = np.zeros((2, 16, 16, 3), np.float32)
    params = jax.device_get(model.init(jax.random.key(0), x,
                                       train=False)["params"])
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(np.asarray, params)
    for i, dim in enumerate(DIMS):
        params[f"stage{i}_block0"]["layer_scale"] = (
            rng.normal(size=dim) * 0.5).astype(np.float32)
    return params


def _images(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, 16, 16, 3)).astype(np.uint8),
            rng.integers(0, CLASSES, size=(n,)).astype(np.int32))


def _port_model(params, fused):
    model = ConvNeXt(DEPTHS, DIMS, num_classes=CLASSES, fused_mlp=fused)
    model.load_state_dict(convnext_params_from_jax(params), strict=True)
    return model


def test_weight_carry_round_trip_is_exact():
    params = _jax_init()
    back = convnext_params_to_jax(convnext_params_from_jax(params))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    sd = convnext_params_from_jax(params)
    assert sd["stage0_block0.dwconv.weight"].shape == (16, 1, 7, 7)
    assert sd["stage0_block0.pwconv1.kernel"].shape == (16, 64)
    assert sd["downsample1_conv.weight"].shape == (32, 16, 2, 2)
    assert sd["head.weight"].shape == (CLASSES, 32)


@pytest.mark.parametrize("fused", ["on", "off", "auto"])
def test_logits_match_jax(fused):
    params = _jax_init()
    x = np.random.default_rng(3).normal(size=(3, 16, 16, 3)).astype(
        np.float32)
    jm = JaxConvNeXt(depths=DEPTHS, dims=DIMS, num_classes=CLASSES,
                     fused_mlp="on")
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    fm.reset_launches()
    with torch.no_grad():
        got = _port_model(params, fused)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert fm.LAUNCHES == {"fwd": 0, "bwd": 0, "reduce": 0}  # CPU: plain


@functools.lru_cache(maxsize=None)
def _jax_step_run():
    params = _jax_init()
    mesh = make_mesh(devices=jax.devices()[:1])
    model = JaxConvNeXt(depths=DEPTHS, dims=DIMS, num_classes=CLASSES,
                        fused_mlp="on")
    opt = jax_optimizer(0.9, 0.05, "adamw")
    state = jax_state(model, jax.random.key(0), 16, opt)
    state = replicate_state(state.replace(params=params), mesh)
    step = jax_step(model, opt, mesh, mean=MEAN, std=STD,
                    health_stats=True, weight_decay=0.05)
    gi, gl = shard_batch(mesh, *_images())
    state, m = step(state, gi, gl, np.float32(1e-3))
    return np.asarray(m), jax.device_get(state.params)


def test_adamw_step_matches_jax():
    want_m, want_p = _jax_step_run()
    model = _port_model(_jax_init(), "on")
    opt = make_optimizer(0.9, 0.05, "adamw")
    state = create_train_state(model, opt)
    step = make_train_step(opt, MEAN, STD, health_stats=True)
    images, labels = (torch.from_numpy(a) for a in _images())
    state, m = step(state, images, labels, torch.tensor(1e-3))
    np.testing.assert_allclose(m.numpy(), want_m, atol=STEP_TOL,
                               rtol=STEP_TOL)
    want = convnext_params_from_jax(want_p)
    for name, t in state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=name)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", [(16, 50), (96, 333), (200, 77),
                                    (768, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(c, rows, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    td = getattr(torch, dtype)
    *fwd_args, dout = fm.block_inputs(c, rows, td, c + rows)
    # bf16: GEMM operands rounded inside the chain may land a bf16 ulp
    # apart in the two versions (chip_smoke.py's _FUSED_TOL).
    atol = rtol = 1e-4 if dtype == "float32" else 3e-2
    got = fm.fwd(*fwd_args)
    want = fm.fwd_plain(*fwd_args)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    bwd_args = fwd_args[1:] + [dout]
    got = fm.bwd(*bwd_args)
    again = fm.bwd(*bwd_args)
    want = fm.bwd_plain(*bwd_args)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    norm_tol = 1e-4 if dtype == "float32" else 1e-3
    for g, a, w in zip(got[1:], again[1:], want[1:]):
        assert torch.equal(g, a)  # bitwise-identical rerun
        assert float((g - w).abs().max()) <= norm_tol * float(w.abs().max())
