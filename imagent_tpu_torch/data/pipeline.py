"""Input pipeline contract + factory (PyTorch port of
``imagent_tpu/data/pipeline.py``).

Loaders yield host-local numpy batches on the uint8 NHWC wire;
``data/prefetch.py`` stages them onto the device, where the train step
dequantizes and normalizes (``train.make_input_prep``). Sample order is
the deterministic stream of ``data/stream.py``: every epoch a
permutation seeded by ``seed + epoch``, process ``p`` of ``P`` takes
rows ``p::P``, train drops the global remainder, eval pads the tail
batch and marks the padding in a uint8 ``mask``.

This slice ports the synthetic loader only (``make_loaders``); the
imagefolder and tar loaders are refused by ``config.check_ported``.
numpy only, no torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from imagent_tpu_torch.config import Config


@dataclasses.dataclass
class Batch:
    """Host-local shard of one global batch: ``images`` NHWC on the raw
    [0, 255] pixel scale (uint8), ``labels`` int32, ``mask`` uint8 0/1
    (eval padding validity)."""

    images: np.ndarray
    labels: np.ndarray
    mask: np.ndarray  # uint8: 1 = real sample, 0 = eval padding


def pad_batch(images: np.ndarray, labels: np.ndarray,
              rows: int) -> Batch:
    """Pad a short (eval tail) batch up to ``rows`` with masked samples."""
    k = images.shape[0]
    mask = np.zeros((rows,), np.uint8)  # 0/1 semantics: 1 byte on the wire
    mask[:k] = 1
    if k < rows:
        pad_img = np.zeros((rows - k,) + images.shape[1:], images.dtype)
        pad_lbl = np.zeros((rows - k,), labels.dtype)
        images = np.concatenate([images, pad_img], 0)
        labels = np.concatenate([labels, pad_lbl], 0)
    return Batch(images=images, labels=labels, mask=mask)


def make_loaders(cfg: Config, process_index: int, process_count: int,
                 global_batch: int):
    """``(train_loader, val_loader)`` for ``cfg.dataset``."""
    if cfg.dataset != "synthetic":
        raise ValueError(f"--dataset {cfg.dataset} is not yet ported to "
                         "imagent_tpu_torch (this slice supports synthetic)")
    from imagent_tpu_torch.data.synthetic import SyntheticLoader
    return (SyntheticLoader(cfg, process_index, process_count,
                            global_batch, train=True),
            SyntheticLoader(cfg, process_index, process_count,
                            global_batch, train=False))
