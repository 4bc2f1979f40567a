"""The port's ViT (imagent_tpu_torch/models/vit.py) against the JAX
package's Flax ViT: weights carried from a JAX init by
``vit_params_from_jax``, the same numpy batch through both, fp32 logits
at 2e-4 (the cross-framework bound of tests/test_torch_compat.py:161).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from imagent_tpu.models.vit import VIT_PARAM_COUNTS as JAX_COUNTS
from imagent_tpu.models.vit import VIT_REGISTRY as JAX_REGISTRY
from imagent_tpu.models.vit import VisionTransformer as JaxViT
from imagent_tpu_torch.compat import vit_params_from_jax, vit_params_to_jax
from imagent_tpu_torch.config import PORTED_ARCHS
from imagent_tpu_torch.models import create_model
from imagent_tpu_torch.models.convnext import CONVNEXT_DEFS
from imagent_tpu_torch.models.resnet import ARCH_DEFS as RESNET_DEFS
from imagent_tpu_torch.models.vit import (
    VIT_PARAM_COUNTS, VIT_REGISTRY, VisionTransformer,
)

torch.set_num_threads(2)

LOGIT_TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _jax_init(attn, **extra):
    model = JaxViT(**JAX_REGISTRY["vit_debug"], num_classes=10,
                   attn_impl=attn, **extra)
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(
        np.float32)
    variables = model.init(jax.random.key(0), x, train=False)
    return model, variables, x


@pytest.mark.parametrize("attn,extra", [
    ("full", {}),
    ("flash", {}),
    ("flash", {"fused_qkv": True, "register_tokens": 3}),
])
def test_logits_match_jax(attn, extra):
    jm, variables, x = _jax_init(attn, **extra)
    want = np.asarray(jm.apply(variables, x, train=False))
    tm = create_model("vit_debug", 10, bf16=False, image_size=16,
                      attn_impl=attn, **extra)
    tm.load_state_dict(vit_params_from_jax(jax.device_get(
        variables["params"])), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_weight_roundtrip_is_exact():
    _, variables, _ = _jax_init("full", register_tokens=2)
    params = jax.device_get(variables["params"])
    back = vit_params_to_jax(vit_params_from_jax(params), num_heads=4)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = {jax.tree_util.keystr(p): v
           for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)],
                                      np.asarray(leaf))


def test_registry_and_param_counts_match_jax():
    assert VIT_REGISTRY == JAX_REGISTRY
    assert VIT_PARAM_COUNTS == JAX_COUNTS
    assert set(PORTED_ARCHS) == (set(VIT_REGISTRY) | set(CONVNEXT_DEFS)
                                 | set(RESNET_DEFS))
    for arch, count in VIT_PARAM_COUNTS.items():
        with torch.device("meta"):
            m = VisionTransformer(224, **VIT_REGISTRY[arch], num_classes=1000)
        assert sum(p.numel() for p in m.parameters()) == count, arch


def test_init_matches_jax_distributions():
    """Not bit-equal (different generators), but every tensor has the
    JAX init's shape and law: lecun-normal kernels truncated at 2 std,
    zero biases and class token, N(0, 0.02) position embedding. Checked
    per tensor on std (within 25%: the smallest tensors hold 160 values)
    and on the truncation bound."""
    _, variables, _ = _jax_init("full")
    want = vit_params_from_jax(jax.device_get(variables["params"]))
    tm = VisionTransformer(16, **VIT_REGISTRY["vit_debug"], num_classes=10)
    tm.reset_parameters(torch.Generator().manual_seed(1))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if float(w.std()) == 0.0:
            assert torch.equal(g, w), name  # zeros and ones
            continue
        ratio = float(g.std()) / float(w.std())
        assert 0.75 < ratio < 1.25, (name, ratio)
        if name.endswith("pos_embedding"):
            continue  # plain normal, not truncated
        bound = 2.0 * float(w.std()) / 0.87962566103423978 * 1.2
        assert float(g.abs().max()) <= bound, name


def test_bf16_placement():
    """bf16 compute over fp32 params: the residual stream is bf16, the
    head fp32; parameters never change type."""
    tm = create_model("vit_debug", 4, bf16=True, image_size=16,
                      generator=torch.Generator().manual_seed(0))
    out = tm(torch.zeros(2, 16, 16, 3))
    assert out.dtype == torch.float32 and out.shape == (2, 4)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_unported_families_and_overrides_refused():
    with pytest.raises(ValueError, match="not yet ported"):
        create_model("resnet18", remat=True)
    with pytest.raises(ValueError, match="not yet ported"):
        create_model("vit_debug", image_size=16, remat=True)
    with pytest.raises(ValueError, match="not yet ported"):
        create_model("vit_debug", image_size=16, attn_impl="ring")
