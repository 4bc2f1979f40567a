"""Best/last checkpoints and ``--resume`` (a minimal PyTorch port of
``imagent_tpu/checkpoint.py``).

A checkpoint ``<ckpt_dir>/<name>.pt`` is one ``torch.save`` of the train
state (model ``state_dict``, optimizer slots, step) beside a
``<name>_meta.json`` sidecar (epoch, best metrics, the batch geometry).
Both are written to a temporary file and renamed into place, so a crash
leaves the previous generation whole. ``best`` is saved on a val top-1
improvement, ``last`` after every epoch; ``--resume`` restores ``last``.

Not ported in this slice: async commits, keep-last-k rotation,
integrity manifests, the fallback restore chain, emergency salvage and
sharded snapshots.
"""

from __future__ import annotations

import json
import os

import torch

from imagent_tpu_torch.train import TrainState

BEST = "best"
LAST = "last"


def _paths(ckpt_dir: str, name: str) -> tuple[str, str]:
    return (os.path.join(ckpt_dir, f"{name}.pt"),
            os.path.join(ckpt_dir, f"{name}_meta.json"))


def _replace_into(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save(ckpt_dir: str, name: str, state: TrainState, meta: dict) -> None:
    """Write ``name``'s state, then its meta sidecar."""
    os.makedirs(ckpt_dir, exist_ok=True)
    pt, meta_path = _paths(ckpt_dir, name)
    payload = {"model": state.model.state_dict(),
               "opt_state": state.opt_state, "step": state.step}
    _replace_into(pt, lambda p: torch.save(payload, p))

    def write_meta(p):
        with open(p, "w") as f:
            json.dump(meta, f, sort_keys=True)
    _replace_into(meta_path, write_meta)


def _load_into(dst, src):
    """Copy a nested dict of tensors into ``dst``'s tensors in place."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError("checkpoint optimizer state does not match "
                             "this run's optimizer (different --optimizer "
                             "or --arch?)")
        for k in dst:
            _load_into(dst[k], src[k])
    else:
        dst.copy_(src)


def restore(ckpt_dir: str, name: str, state: TrainState) -> dict | None:
    """Load ``name`` into ``state`` in place; returns its meta, or None
    when there is no such checkpoint."""
    pt, meta_path = _paths(ckpt_dir, name)
    if not (os.path.exists(pt) and os.path.exists(meta_path)):
        return None
    device = state.step.device
    payload = torch.load(pt, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    _load_into(state.opt_state, payload["opt_state"])
    state.step.copy_(payload["step"])
    with open(meta_path) as f:
        return json.load(f)
