"""The port's ResNet slice against the JAX package on the CPU, on
numpy-seeded inputs and weights carried from the JAX ``init`` by
``resnet_params_from_jax``:

* ``models/resnet.py``: logits in eval mode (fp32, BN statistics moved
  away from (0, 1)) and in train mode, for resnet18 with both stems,
  resnet50 and resnext50_32x4d, at 2e-4 (``tests/test_torch_compat.py:
  161``); the BatchNorm alone against ``flax.linen.BatchNorm`` (fp32 and
  bf16 inputs, output and updated statistics); the published parameter
  counts of all nine archs;
* ``train.py``: one SGD step (params, ``batch_stats`` and the metric
  vector) against the JAX step, on a batch with 8 samples per channel in
  the last stage, where torch's unbiased running-variance update would
  be off by 8/7; the same with ``--grad-accum 2`` (the statistics chain
  through the micro-batches), and on the first batch of both packages'
  image-folder loaders (8 JPEGs, byte-equal); a non-finite step leaves
  every BN buffer bitwise unchanged;
* ``compat``: the weight carry both ways.

Train-mode logits are compared with both sides computing in float64:
in fp32 the batch variance ``E[x^2] - E[x]^2`` (Flax's fast variance,
which the port repeats) is ill-conditioned on few samples per channel,
and the two frameworks' different summation orders alone moved ResNet-50
logits by 7e-4 (resnet18 at 8 images of 32 px: 4e-5). The fp32 train
step holds at 1e-5 on resnet18.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagent_tpu.cluster import make_mesh
from imagent_tpu.models.resnet import (
    PARAM_COUNTS as JAX_COUNTS, RESNET_REGISTRY,
)
from imagent_tpu.train import TrainState as JaxTrainState
from imagent_tpu.train import (
    make_optimizer as jax_optimizer, make_train_step as jax_step,
    replicate_state, shard_batch,
)
from imagent_tpu_torch.compat import (
    resnet_params_from_jax, resnet_params_to_jax,
)
from imagent_tpu_torch.models import create_model
from imagent_tpu_torch.models.resnet import (
    ARCH_DEFS, PARAM_COUNTS, BatchNorm, ResNet, create_resnet,
)
from imagent_tpu_torch.train import (
    create_train_state, make_optimizer, make_train_step,
)

torch.set_num_threads(2)

CLASSES = 10
LOGIT_TOL = 2e-4
STEP_TOL = 1e-5
MEAN = STD = (0.5, 0.5, 0.5)
MODELS = [("resnet18", "v1"), ("resnet18", "s2d"), ("resnet50", "v1"),
          ("resnext50_32x4d", "v1")]


@functools.lru_cache(maxsize=None)
def _jax_vars(arch, stem, size=32):
    """Flax ``(params, batch_stats)`` of ``arch`` (numpy), BN statistics
    moved away from (0, 1) so that eval mode exercises them."""
    model = RESNET_REGISTRY[arch](num_classes=CLASSES, stem=stem)
    v = jax.device_get(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3)), train=False))(jax.random.key(0)))
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    return v["params"], stats


def _images(seed, n, size=32):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _port(arch, stem, params, stats, dtype=torch.float32):
    model = create_resnet(arch, CLASSES, dtype=dtype, stem=stem)
    model.load_state_dict(resnet_params_from_jax(params, stats), strict=True)
    return model


@pytest.mark.parametrize("arch,stem", MODELS)
def test_eval_logits_match_jax(arch, stem):
    params, stats = _jax_vars(arch, stem)
    x = _images(2, 2)
    jm = RESNET_REGISTRY[arch](num_classes=CLASSES, stem=stem)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x))
    model = _port(arch, stem, params, stats).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch,stem", MODELS)
def test_train_logits_and_stats_match_jax(arch, stem):
    """Train mode: the batch statistics normalise and the running ones
    update with the biased variance (float64 compute on both sides; see
    the module docstring)."""
    params, stats = _jax_vars(arch, stem)
    x = _images(3, 2)
    with jax.enable_x64(True):
        jm = RESNET_REGISTRY[arch](num_classes=CLASSES, stem=stem,
                                   dtype=jnp.float64)
        want, mut = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(
                {"params": params, "batch_stats": stats},
                x.astype(np.float64))
        want = np.asarray(want)
        new_stats = jax.device_get(mut["batch_stats"])
    model = _port(arch, stem, params, stats, torch.float64).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _, got_stats = resnet_params_to_jax(model.state_dict())
    for path, w in jax.tree_util.tree_leaves_with_path(new_stats):
        g = got_stats
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax(dtype):
    """Flax's BatchNorm (momentum 0.9, eps 1e-5, ``dtype`` compute):
    fp32 statistics of a bf16 input, the biased variance in the running
    update, the output in the compute type; then eval mode."""
    import flax.linen as nn
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 3, 3, 8)) * 2 + 1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jd)
    v = jax.device_get(bn.init(jax.random.key(0), x))
    scale = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": v["batch_stats"]}
    want, mut = bn.apply(v, jnp.asarray(x, jd), mutable=["batch_stats"])
    tb = BatchNorm(8).train()
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(scale))
        tb.bias.copy_(torch.from_numpy(bias))
        got = tb(torch.from_numpy(x).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)
    xs = np.asarray(jnp.asarray(x, jd), np.float32).reshape(-1, 8)
    biased = 0.9 + 0.1 * xs.var(0)  # n = 18 samples per channel
    np.testing.assert_allclose(tb.running_var.numpy(), biased, rtol=1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tb, name).numpy(),
                                   mut["batch_stats"][key], rtol=1e-6,
                                   atol=1e-7)
    v["batch_stats"] = jax.device_get(mut["batch_stats"])
    bn_eval = nn.BatchNorm(use_running_average=True, momentum=0.9,
                           epsilon=1e-5, dtype=jd)
    want = bn_eval.apply(v, jnp.asarray(x, jd))
    with torch.no_grad():
        got = tb.eval()(torch.from_numpy(x).to(td))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", sorted(ARCH_DEFS))
def test_param_counts(arch):
    stages, bottleneck, groups, base_width = ARCH_DEFS[arch]
    with torch.device("meta"):
        model = ResNet(stages, bottleneck, groups=groups,
                       base_width=base_width)
    n = sum(p.numel() for p in model.parameters())
    assert n == PARAM_COUNTS[arch] == JAX_COUNTS[arch]
    buffers = [name for name, _ in model.named_buffers()]
    assert all(b.endswith(("running_mean", "running_var"))
               for b in buffers)


@pytest.mark.parametrize("arch,stem", [("resnext50_32x4d", "v1"),
                                       ("resnet18", "s2d")])
def test_weight_round_trip(arch, stem):
    params, stats = _jax_vars(arch, stem)
    sd = resnet_params_from_jax(params, stats)
    model = create_model(arch, CLASSES, stem=stem)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back_p, back_s = resnet_params_to_jax(model.state_dict())
    for tree, back in ((params, back_p), (stats, back_s)):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert set(flat) == set(got)
        for k, w in flat.items():
            np.testing.assert_array_equal(got[k], w,
                                          err_msg=jax.tree_util.keystr(k))
    if arch.startswith("resnext"):  # grouped 3x3: (3, 3, F/g, F) HWIO
        k = params["layer1_block0"]["Conv_1"]["kernel"]
        assert k.shape == (3, 3, 4, 128)
        assert tuple(sd["layer1_block0.Conv_1.weight"].shape) == (128, 4, 3,
                                                                  3)


def _batch(seed=0, n=8, size=32):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, size, size, 3)).astype(np.uint8)
    labels = rng.integers(0, CLASSES, size=(n,)).astype(np.int32)
    return images, labels


def _poisoned():
    images, labels = _batch()
    images = images.astype(np.float32)
    images[0, 0, 0, 0] = np.nan
    return images, labels


@functools.lru_cache(maxsize=None)
def _jax_step(accum):
    """``(mesh, opt, step)``: the JAX SGD step of resnet18 (lr 0.1,
    momentum 0.9, wd 1e-4), the model computing in float64 (see the
    module docstring), built once per ``accum``: each batch it runs
    costs one execution and no new compile."""
    with jax.enable_x64(True):
        mesh = make_mesh(devices=jax.devices()[:1])
        model = RESNET_REGISTRY["resnet18"](num_classes=CLASSES,
                                            dtype=jnp.float64)
        opt = jax_optimizer(0.9, 1e-4, "sgd")
        step = jax_step(model, opt, mesh, grad_accum=accum, mean=MEAN,
                        std=STD, health_stats=True, weight_decay=1e-4)
    return mesh, opt, step


def _jax_step_on(accum, images, labels):
    """(params0, stats0, metrics, params1, stats1) of one JAX step from
    the ``_jax_vars`` state (fp32 parameters) on ``(images, labels)``."""
    params0, stats0 = _jax_vars("resnet18", "v1")
    mesh, opt, step = _jax_step(accum)
    with jax.enable_x64(True):
        # float64 statistics: the micro-batch scan carries them, and its
        # carry keeps one dtype.
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params0,
            batch_stats=jax.tree.map(lambda a: a.astype(np.float64), stats0),
            opt_state=opt.init(params0))
        state = replicate_state(state, mesh)
        gi, gl = shard_batch(mesh, images, labels)
        state, m = step(state, gi, gl, np.float32(0.1))
        return (params0, stats0, np.asarray(m),
                jax.device_get(state.params),
                jax.device_get(state.batch_stats))


@functools.lru_cache(maxsize=None)
def _jax_step_run(accum):
    return _jax_step_on(accum, *_batch())


def _port_step(accum, params0, stats0, poison=False, batch=None):
    model = _port("resnet18", "v1", params0, stats0, torch.float64)
    opt = make_optimizer(0.9, 1e-4, "sgd")
    state = create_train_state(model, opt)
    step = make_train_step(opt, MEAN, STD, grad_accum=accum,
                           health_stats=True)
    images, labels = batch or (_poisoned() if poison else _batch())
    state, m = step(state, torch.from_numpy(images),
                    torch.from_numpy(labels), torch.tensor(0.1))
    return state, m.numpy()


def _assert_step_matches(state, got_m, want_m, want_p, want_s):
    np.testing.assert_allclose(got_m, want_m, rtol=1e-4, atol=1e-4)
    got = state.model.state_dict()
    want = resnet_params_from_jax(want_p, want_s)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=name)
    return got, want


@pytest.mark.parametrize("accum", [1, 2])
def test_sgd_step_params_and_batch_stats_match_jax(accum):
    params0, stats0, want_m, want_p, want_s = _jax_step_run(accum)
    state, got_m = _port_step(accum, params0, stats0)
    got, want = _assert_step_matches(state, got_m, want_m, want_p, want_s)
    # The check can tell the two updates apart: torch's unbiased running
    # variance (n / (n - 1), n = 8 / accum samples per channel in the
    # last stage, 1 x 1 px at 32 px) would miss the JAX value by far
    # more than the tolerance.
    name = "layer4_block1.BatchNorm_1.running_var"
    n = 8 // accum
    v0 = resnet_params_from_jax(params0, stats0)[name].numpy()
    biased = got[name].numpy()
    if accum == 1:
        unbiased = 0.9 * v0 + (biased - 0.9 * v0) * n / (n - 1)
        assert np.abs(unbiased - want[name].numpy()).max() > 100 * STEP_TOL


def test_nonfinite_step_leaves_bn_buffers_bitwise_unchanged():
    """The JAX step skips such a step whole (``_skip_if_bad`` over params,
    optimizer slots and ``batch_stats``, ``imagent_tpu/train.py:677``)."""
    params0, stats0 = _jax_vars("resnet18", "v1")
    model_sd = resnet_params_from_jax(params0, stats0)
    state, got_m = _port_step(1, params0, stats0, poison=True)
    np.testing.assert_array_equal(got_m[:4], 0.0)
    got = state.model.state_dict()
    for name, w in model_sd.items():
        assert torch.equal(got[name], w), name
    assert int(state.step) == 1


def test_sgd_step_on_the_first_image_folder_batch_matches_jax(tmp_path):
    """The slice end to end on the host side: the first train batch of
    the JAX package's image-folder loader and of the port's (PIL path,
    8 JPEGs of 40 px read at 32 px, 4 classes), byte-equal, then one
    SGD step on it in both packages from the same weights."""
    from imagent_tpu.config import Config as JaxConfig
    from imagent_tpu.data.imagefolder import ImageFolderLoader as JaxLoader
    from imagent_tpu_torch.config import Config
    from imagent_tpu_torch.data.imagefolder import ImageFolderLoader
    from imagent_tpu_torch.data.texturegen import generate_imagefolder

    root = generate_imagefolder(str(tmp_path), n_classes=4,
                                train_per_class=2, val_per_class=1, img=40)
    kw = dict(data_root=root, image_size=32, workers=0, native_io=False)
    batches = []
    for cls, cfg in ((JaxLoader, JaxConfig(**kw)),
                     (ImageFolderLoader, Config(**kw))):
        loader = cls(cfg, 0, 1, 8, "train")
        try:
            batches.append(next(iter(loader.epoch(0))))
        finally:
            loader.close()
    want_b, got_b = batches
    images, labels = _batch()
    assert got_b.images.shape == images.shape
    assert got_b.images.dtype == images.dtype
    np.testing.assert_array_equal(got_b.images, want_b.images)
    np.testing.assert_array_equal(got_b.labels, want_b.labels)
    assert got_b.labels.max() < CLASSES and len(set(got_b.labels)) == 4
    params0, stats0, want_m, want_p, want_s = _jax_step_on(
        1, want_b.images, want_b.labels)
    state, got_m = _port_step(1, params0, stats0,
                              batch=(got_b.images, got_b.labels))
    _assert_step_matches(state, got_m, want_m, want_p, want_s)
