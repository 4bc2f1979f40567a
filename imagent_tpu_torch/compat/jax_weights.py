"""Carry ResNet, ViT and ConvNeXt weights between the JAX package's Flax
param trees and this port's modules.

``params`` is the Flax tree of ``imagent_tpu/models/vit.py`` as nested
dicts of numpy arrays (``jax.device_get`` of a ``TrainState.params``);
no JAX is imported here. ``vit_params_from_jax`` returns a state_dict
the port's ``VisionTransformer`` takes with ``load_state_dict(strict=
True)``; ``vit_params_to_jax`` inverts it. The layout mapping is the one
``imagent_tpu/compat/torch_weights.py`` (``vit_from_torch`` /
``vit_to_torch``) uses, copied here:

* conv kernel HWIO <-> torch OIHW;
* Dense kernel [in, out] <-> Linear weight [out, in];
* query/key/value DenseGeneral kernels [D, H, hd] <-> rows of the fused
  ``in_proj_weight`` [3D, D] (q, k, v order), biases [H, hd] <-> [3D];
* the out DenseGeneral [H, hd, D] <-> ``out_proj.weight`` [D, H*hd];
* LayerNorm scale/bias <-> weight/bias.

ConvNeXt (``convnext_params_from_jax`` / ``convnext_params_to_jax``):
the port keeps the Flax module names (``stem_conv``,
``stage{i}_block{j}.dwconv``, ...), so the mapping is per leaf: conv
kernels HWIO <-> OIHW (the depthwise ``(7, 7, 1, C)`` <-> ``(C, 1, 7,
7)``), LayerNorm scale/bias <-> weight/bias, the head's Dense kernel
``[in, out]`` <-> ``nn.Linear`` weight ``[out, in]``; ``pwconv1``/
``pwconv2`` keep Flax's ``kernel``/``bias`` as they are, and
``layer_scale`` carries across.

ResNet (``resnet_params_from_jax`` / ``resnet_params_to_jax``): the
port keeps the Flax module names too (``conv1``, ``bn1``,
``layer{i}_block{j}.Conv_{k}`` / ``.BatchNorm_{k}``, ``downsample_conv``
/ ``downsample_bn``, ``fc``), and the layout is that of
``imagent_tpu/compat/torch_weights.py`` (``resnet_from_torch`` /
``resnet_to_torch``): conv kernels HWIO <-> OIHW (a grouped kernel
``(3, 3, F / g, F)`` <-> ``(F, F / g, 3, 3)``), the head's Dense
``[in, out]`` <-> ``nn.Linear`` ``[out, in]``, BatchNorm scale/bias <->
weight/bias from ``params`` and mean/var <-> running_mean/running_var
from ``batch_stats``.
"""

from __future__ import annotations

import numpy as np
import torch

_QKV = ("query", "key", "value")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _ln(p: dict) -> tuple:
    return p["scale"], p["bias"]


def vit_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax ViT params -> the port's state_dict (fp32 tensors)."""
    if "encoder_layer_0" not in params:
        raise ValueError("expected the per-layer ViT param tree "
                         "(encoder_layer_i keys); stacked/pipelined "
                         "params are not supported")
    d = np.asarray(params["class_token"]).shape[-1]
    conv = np.asarray(params["conv_proj"]["kernel"])
    sd = {
        "conv_proj.weight": conv.transpose(3, 2, 0, 1),
        "conv_proj.bias": params["conv_proj"]["bias"],
        "class_token": np.asarray(params["class_token"]).reshape(1, 1, d),
        "encoder.pos_embedding": params["pos_embedding"],
        "encoder.ln.weight": params["ln"]["scale"],
        "encoder.ln.bias": params["ln"]["bias"],
        "heads.head.weight": np.asarray(params["head"]["kernel"]).T,
        "heads.head.bias": params["head"]["bias"],
    }
    if "register_tokens" in params:
        sd["register_tokens"] = params["register_tokens"]
    i = 0
    while f"encoder_layer_{i}" in params:
        src = params[f"encoder_layer_{i}"]
        dst = f"encoder.layers.encoder_layer_{i}"
        att = src["self_attention"]
        sd[f"{dst}.self_attention.in_proj_weight"] = np.concatenate(
            [np.asarray(att[n]["kernel"]).reshape(d, -1).T for n in _QKV])
        sd[f"{dst}.self_attention.in_proj_bias"] = np.concatenate(
            [np.asarray(att[n]["bias"]).reshape(-1) for n in _QKV])
        out = np.asarray(att["out"]["kernel"])
        sd[f"{dst}.self_attention.out_proj.weight"] = out.reshape(-1, d).T
        sd[f"{dst}.self_attention.out_proj.bias"] = att["out"]["bias"]
        for ln in ("ln_1", "ln_2"):
            sd[f"{dst}.{ln}.weight"], sd[f"{dst}.{ln}.bias"] = _ln(src[ln])
        sd[f"{dst}.mlp.0.weight"] = np.asarray(src["mlp_0"]["kernel"]).T
        sd[f"{dst}.mlp.0.bias"] = src["mlp_0"]["bias"]
        sd[f"{dst}.mlp.3.weight"] = np.asarray(src["mlp_1"]["kernel"]).T
        sd[f"{dst}.mlp.3.bias"] = src["mlp_1"]["bias"]
        i += 1
    return {k: _t(v) for k, v in sd.items()}


def vit_params_to_jax(state_dict: dict, num_heads: int) -> dict:
    """The port's ViT state_dict -> the Flax param tree (numpy fp32)."""
    sd = {k: v.detach().cpu().float().numpy() if torch.is_tensor(v)
          else np.asarray(v, np.float32) for k, v in state_dict.items()}
    d = sd["class_token"].shape[-1]
    hd = d // num_heads
    params = {
        "conv_proj": {"kernel": sd["conv_proj.weight"].transpose(2, 3, 1, 0),
                      "bias": sd["conv_proj.bias"]},
        "class_token": sd["class_token"].reshape(1, 1, d),
        "pos_embedding": sd["encoder.pos_embedding"],
        "ln": {"scale": sd["encoder.ln.weight"],
               "bias": sd["encoder.ln.bias"]},
        "head": {"kernel": sd["heads.head.weight"].T,
                 "bias": sd["heads.head.bias"]},
    }
    if "register_tokens" in sd:
        params["register_tokens"] = sd["register_tokens"]
    i = 0
    while f"encoder.layers.encoder_layer_{i}.ln_1.weight" in sd:
        src = f"encoder.layers.encoder_layer_{i}"
        w = np.split(sd[f"{src}.self_attention.in_proj_weight"], 3)
        b = np.split(sd[f"{src}.self_attention.in_proj_bias"], 3)
        att = {n: {"kernel": w[j].T.reshape(d, num_heads, hd),
                   "bias": b[j].reshape(num_heads, hd)}
               for j, n in enumerate(_QKV)}
        att["out"] = {
            "kernel": sd[f"{src}.self_attention.out_proj.weight"].T.reshape(
                num_heads, hd, d),
            "bias": sd[f"{src}.self_attention.out_proj.bias"]}
        params[f"encoder_layer_{i}"] = {
            "ln_1": {"scale": sd[f"{src}.ln_1.weight"],
                     "bias": sd[f"{src}.ln_1.bias"]},
            "ln_2": {"scale": sd[f"{src}.ln_2.weight"],
                     "bias": sd[f"{src}.ln_2.bias"]},
            "self_attention": att,
            "mlp_0": {"kernel": sd[f"{src}.mlp.0.weight"].T,
                      "bias": sd[f"{src}.mlp.0.bias"]},
            "mlp_1": {"kernel": sd[f"{src}.mlp.3.weight"].T,
                      "bias": sd[f"{src}.mlp.3.bias"]},
        }
        i += 1
    return params


def convnext_params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax ConvNeXt params -> the port's state_dict (fp32 tensors)."""
    sd = {}

    def walk(node: dict, prefix: str, module: str) -> None:
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.", name)
            elif name == "kernel" and module == "head":
                sd[f"{prefix}weight"] = np.asarray(leaf).T
            elif name == "kernel" and module.endswith("conv"):
                sd[f"{prefix}weight"] = np.asarray(leaf).transpose(3, 2, 0, 1)
            elif name == "scale":
                sd[f"{prefix}weight"] = leaf
            else:  # biases, the Dense kernels, layer_scale
                sd[f"{prefix}{name}"] = leaf

    walk(params, "", "")
    return {k: _t(v) for k, v in sd.items()}


def convnext_params_to_jax(state_dict: dict) -> dict:
    """The port's ConvNeXt state_dict -> the Flax param tree (numpy
    fp32)."""
    params: dict = {}
    for key, value in state_dict.items():
        value = value.detach().cpu().float().numpy() if torch.is_tensor(
            value) else np.asarray(value, np.float32)
        *path, leaf = key.split(".")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        module = path[-1]
        if module == "head" and leaf == "weight":
            node["kernel"] = value.T
        elif module.endswith("conv") and leaf == "weight":
            node["kernel"] = value.transpose(2, 3, 1, 0)
        elif module.endswith("norm") and leaf == "weight":
            node["scale"] = value
        else:  # biases, the Dense kernels, layer_scale
            node[leaf] = value
    return params


def resnet_params_from_jax(params: dict,
                           batch_stats: dict) -> dict[str, torch.Tensor]:
    """Flax ResNet ``params`` and ``batch_stats`` -> the port's
    state_dict (fp32 tensors, BN running statistics included)."""
    sd = {}

    def walk(node: dict, prefix: str, module: str) -> None:
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.", name)
            elif name == "kernel" and module == "fc":
                sd[f"{prefix}weight"] = np.asarray(leaf).T
            elif name == "kernel":  # conv1, Conv_k, downsample_conv
                sd[f"{prefix}weight"] = np.asarray(leaf).transpose(3, 2, 0, 1)
            elif name == "scale":
                sd[f"{prefix}weight"] = leaf
            elif name in ("mean", "var"):
                sd[f"{prefix}running_{name}"] = leaf
            else:  # BN and head biases
                sd[f"{prefix}{name}"] = leaf

    walk(params, "", "")
    walk(batch_stats, "", "")
    return {k: _t(v) for k, v in sd.items()}


def resnet_params_to_jax(state_dict: dict) -> tuple[dict, dict]:
    """The port's ResNet state_dict -> ``(params, batch_stats)``, the
    Flax trees (numpy fp32)."""
    params: dict = {}
    stats: dict = {}
    for key, value in state_dict.items():
        value = value.detach().cpu().float().numpy() if torch.is_tensor(
            value) else np.asarray(value, np.float32)
        *path, leaf = key.split(".")
        tree = stats if leaf.startswith("running_") else params
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        if path[-1] == "fc" and leaf == "weight":
            node["kernel"] = value.T
        elif leaf == "weight" and value.ndim == 4:
            node["kernel"] = value.transpose(2, 3, 1, 0)
        elif leaf == "weight":  # BatchNorm
            node["scale"] = value
        elif leaf.startswith("running_"):
            node[leaf[len("running_"):]] = value
        else:
            node[leaf] = value
    return params, stats
