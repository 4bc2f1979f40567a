"""The port's train step (imagent_tpu_torch/train.py) against the JAX
package's ``make_train_step`` on a one-device mesh: the same vit_debug
weights (carried by ``vit_params_from_jax``), the same uint8 batch, the
same lr. Compared in fp32 after every step: the metric vector
``[loss_sum, top1, top5, n]`` and the ``HEALTH_FIELDS`` tail, and every
parameter after the last step, all at 1e-4 (atol and rtol: the two
frameworks sum gradients and norms in different orders).

The port runs ``attn=flash`` (its plain path on the CPU, through the
autograd.Function) against the JAX einsum attention: the same function,
so the comparison also covers the flash backward inside a real step.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from imagent_tpu.cluster import make_mesh
from imagent_tpu.models.vit import VIT_REGISTRY, VisionTransformer
from imagent_tpu.train import (
    HEALTH_FIELDS as JAX_HEALTH_FIELDS, create_train_state as jax_state,
    make_optimizer as jax_optimizer, make_train_step as jax_step,
    masked_eval_metrics as jax_masked_metrics, replicate_state, shard_batch,
)
from imagent_tpu_torch.compat import vit_params_from_jax
from imagent_tpu_torch.models.vit import VisionTransformer as TorchViT
from imagent_tpu_torch.train import (
    HEALTH_FIELDS, create_train_state, make_eval_step, make_optimizer,
    make_train_step, masked_eval_metrics,
)

torch.set_num_threads(2)

TOL = 1e-4
MEAN = STD = (0.5, 0.5, 0.5)
CLASSES = 4
LR = {"sgd": 0.05, "adamw": 1e-3}


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, 16, 16, 3)).astype(np.uint8)
    labels = rng.integers(0, CLASSES, size=(n,)).astype(np.int32)
    return images, labels


@functools.lru_cache(maxsize=None)
def _jax_run(opt_name, accum, steps, poison):
    """(initial params, per-step metric vectors, final params) of the
    JAX step; ``poison`` feeds a float batch holding a NaN."""
    mesh = make_mesh(devices=jax.devices()[:1])
    model = VisionTransformer(**VIT_REGISTRY["vit_debug"],
                              num_classes=CLASSES)
    opt = jax_optimizer(0.9, 0.05, opt_name)
    state = jax_state(model, jax.random.key(0), 16, opt)
    params0 = jax.device_get(state.params)
    state = replicate_state(state, mesh)
    step = jax_step(model, opt, mesh, grad_accum=accum, mean=MEAN,
                    std=STD, health_stats=True, weight_decay=0.05)
    images, labels = _poisoned() if poison else _batch()
    gi, gl = shard_batch(mesh, images, labels)
    metrics = []
    for _ in range(steps):
        state, m = step(state, gi, gl, np.float32(LR[opt_name]))
        metrics.append(np.asarray(m))
    return params0, metrics, jax.device_get(state.params)


def _poisoned():
    images, labels = _batch()
    images = images.astype(np.float32)
    images[0, 0, 0, 0] = np.nan
    return images, labels


def _port_run(opt_name, accum, steps, poison, params0):
    model = TorchViT(16, **VIT_REGISTRY["vit_debug"], num_classes=CLASSES,
                     attn_impl="flash")
    model.load_state_dict(vit_params_from_jax(params0), strict=True)
    opt = make_optimizer(0.9, 0.05, opt_name)
    state = create_train_state(model, opt)
    step = make_train_step(opt, MEAN, STD, grad_accum=accum,
                           health_stats=True)
    images, labels = _poisoned() if poison else _batch()
    images, labels = torch.from_numpy(images), torch.from_numpy(labels)
    lr = torch.tensor(LR[opt_name], dtype=torch.float32)
    metrics = []
    for _ in range(steps):
        state, m = step(state, images, labels, lr)
        metrics.append(m.numpy())
    return metrics, state


def _assert_params(state, params, tol=TOL, key_bias_bound=None):
    """Every parameter at ``tol``. With ``key_bias_bound`` the attention
    KEY bias is held only to |p - p0| <= bound on both sides: its exact
    gradient is zero (a per-query constant added to every logit of a row
    leaves the softmax unchanged), so each framework sees rounding noise
    of ~1e-9 there, and Adam normalises noise to a step of +-lr whose
    sign is the noise's. Both sides must still stay within that step."""
    want = vit_params_from_jax(params)
    got = state.model.state_dict()
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if key_bias_bound is not None and name.endswith("in_proj_bias"):
            d = w.shape[0] // 3
            start = key_bias_bound[0][name].numpy()[d:2 * d]
            for side in (g[d:2 * d], w[d:2 * d]):
                assert np.abs(side - start).max() <= key_bias_bound[1], name
            g = np.concatenate([g[:d], g[2 * d:]])
            w = np.concatenate([w[:d], w[2 * d:]])
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("opt_name,accum,steps", [
    ("sgd", 1, 3), ("adamw", 1, 3), ("adamw", 2, 1)])
def test_steps_match_jax(opt_name, accum, steps):
    params0, want_m, want_p = _jax_run(opt_name, accum, steps, False)
    got_m, state = _port_run(opt_name, accum, steps, False, params0)
    assert HEALTH_FIELDS == JAX_HEALTH_FIELDS
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        assert g.shape == w.shape == (4 + len(HEALTH_FIELDS),)
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                   err_msg=f"metrics of step {i}")
    assert int(state.step) == steps
    bound = None
    if opt_name == "adamw":
        bound = (vit_params_from_jax(params0), steps * LR[opt_name] * 1.01)
    _assert_params(state, want_p, key_bias_bound=bound)


def test_nonfinite_batch_is_skipped_like_jax():
    params0, want_m, want_p = _jax_run("adamw", 1, 1, True)
    got_m, state = _port_run("adamw", 1, 1, True, params0)
    np.testing.assert_array_equal(want_m[0][:4], 0.0)
    np.testing.assert_array_equal(got_m[0][:4], 0.0)
    _assert_params(state, params0, tol=0.0)  # untouched, bit for bit
    _assert_params(state, want_p, tol=0.0)
    assert int(state.opt_state["count"]) == 0
    assert all(float(t.abs().max()) == 0.0
               for t in state.opt_state["mu"].values())
    assert int(state.step) == 1  # the batch was consumed


def test_eval_step_matches_jax_masked_metrics():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(6, 7)).astype(np.float32)
    logits[0] = 1.0  # all tied: rank 0 for any target
    logits[1, :] = np.arange(7)
    labels = np.array([3, 2, 6, 0, 1, 5], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.uint8)  # padded tail
    want = np.asarray(jax_masked_metrics(logits, labels, mask))
    got = masked_eval_metrics(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert got[3] == 4 and got[1] >= 1  # tied row counts as top-1

    model = TorchViT(16, **VIT_REGISTRY["vit_debug"], num_classes=CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(name="sgd"))
    images, labels = _batch(1, 4)
    m = make_eval_step(MEAN, STD)(state, torch.from_numpy(images),
                                  torch.from_numpy(labels),
                                  torch.tensor([1, 1, 1, 0], dtype=torch.uint8))
    assert m.shape == (4,) and float(m[3]) == 3.0


def test_unported_optimizers_refused():
    for name in ("nadam", "lars", "lamb"):
        with pytest.raises(ValueError, match="not yet ported"):
            make_optimizer(name=name)
