"""Input pipeline contract + factory (PyTorch port of
``imagent_tpu/data/pipeline.py``).

Loaders yield host-local numpy batches on the uint8 NHWC wire;
``data/prefetch.py`` stages them onto the device, where the train step
dequantizes and normalizes (``train.make_input_prep``). Sample order is
the deterministic stream of ``data/stream.py``: every epoch a
permutation seeded by ``seed + epoch``, process ``p`` of ``P`` takes
rows ``p::P``, train drops the global remainder, eval pads the tail
batch and marks the padding in a uint8 ``mask``.

``make_loaders`` builds the synthetic, image-folder or tar-shard
loaders. numpy only, no torch: spawned decode workers import this
module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from imagent_tpu_torch.config import Config


@dataclasses.dataclass
class Batch:
    """Host-local shard of one global batch: ``images`` NHWC on the raw
    [0, 255] pixel scale in the wire dtype (``to_wire``), ``labels``
    int32, ``mask`` uint8 0/1 (eval padding validity)."""

    images: np.ndarray
    labels: np.ndarray
    mask: np.ndarray  # uint8: 1 = real sample, 0 = eval padding


WIRE_DTYPES = ("uint8", "bf16", "float32")


def to_wire(images_u8: np.ndarray, transfer_dtype: str) -> np.ndarray:
    """Cast the canonical uint8 batch to the configured wire dtype: 1, 2
    or 4 bytes per pixel, the values on the raw [0, 255] scale in every
    case, so the in-step dequantize and normalize see identical fp32
    values whichever dtype crossed the wire.

    ``bf16`` travels as ``uint16`` bf16 bit patterns (numpy has no
    bfloat16): every integer 0..255 is exact in bf16, so the top 16 bits
    of its fp32 value are its bf16 value. ``data/prefetch.py`` views a
    ``uint16`` image array as ``torch.bfloat16``."""
    if transfer_dtype == "uint8":
        return images_u8
    if transfer_dtype == "bf16":
        f32 = np.ascontiguousarray(images_u8, np.float32)
        return (f32.view(np.uint32) >> 16).astype(np.uint16)
    if transfer_dtype == "float32":
        return images_u8.astype(np.float32)
    raise ValueError(f"unknown --transfer-dtype {transfer_dtype!r}; "
                     f"one of {'|'.join(WIRE_DTYPES)}")


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
    """``(train_loader, val_loader)`` for ``cfg.dataset``: rank
    ``process_index`` of ``process_count`` reads (and decodes) only its
    own rows of each global batch."""
    if cfg.dataset == "synthetic":
        from imagent_tpu_torch.data.synthetic import SyntheticLoader
        return (SyntheticLoader(cfg, process_index, process_count,
                                global_batch, train=True),
                SyntheticLoader(cfg, process_index, process_count,
                                global_batch, train=False))
    if cfg.dataset == "tar":
        from imagent_tpu_torch.data.tarshards import TarShardLoader as Cls
    elif cfg.dataset == "imagefolder":
        from imagent_tpu_torch.data.imagefolder import (
            ImageFolderLoader as Cls,
        )
    else:
        raise ValueError(f"unknown --dataset {cfg.dataset!r}")
    train = Cls(cfg, process_index, process_count, global_batch,
                split="train")
    try:
        val = Cls(cfg, process_index, process_count, global_batch,
                  split="val")
    except BaseException:
        train.close()
        raise
    return train, val
