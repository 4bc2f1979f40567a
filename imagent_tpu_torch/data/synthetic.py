"""Synthetic dataset: deterministic, learnable, no disk.

The reference has nothing here (its only data path is the real ImageNet
tree, ``imagenet.py:287-296``); SURVEY §7 step 3 adds a synthetic mode as
the hardware-free CI path. Images carry a label-dependent low-frequency
pattern plus noise, so a classifier genuinely learns — loss-decrease
tests are meaningful, not vacuous.

Sample order follows the shared deterministic stream contract
(``data/stream.py``): ``epoch(e, start_step=s)`` opens the stream at
``(e, s)``, so a mid-epoch resume generates nothing for the
already-trained prefix. ``--workers`` carries the same semantics as
the decode loaders — ``0`` = in-process serial, ``N`` = a spawn-context
pool of N generator processes (the per-sample output is a pure
function of ``(seed, row)``, so the pooled and serial paths are
bit-identical).

Copy of ``imagent_tpu/data/synthetic.py``: for the same ``(seed, epoch,
step)`` both packages yield bit-identical uint8 batches
(tests/test_torch_port_data.py). numpy only, no torch.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from imagent_tpu_torch.config import Config
from imagent_tpu_torch.data import stream
from imagent_tpu_torch.data.pipeline import Batch, pad_batch


def _quantize_u8(img: np.ndarray) -> np.ndarray:
    """Float pattern (≈[-1.3, 1.3], zero-centered) → raw uint8 pixels on
    the wire contract's [0, 255] scale. The affine map targets [0, 1]
    so the in-graph (x/255 - 0.5)/0.5 normalization lands the model
    input back near the pattern's native zero-centered range; the clip
    costs only the noise tails, so the class signal survives."""
    return np.clip(np.rint((img * 0.5 + 0.5) * 255.0), 0, 255
                   ).astype(np.uint8)


def _gen_one(fy: float, fx: float, size: int, rng_seed: int) -> np.ndarray:
    """One sample, a pure function of (class frequencies, size, seed) —
    module-level so a spawn-context pool worker can run it. The fp32
    arithmetic mirrors the historical in-class body operation-for-
    operation, so pooled, serial, and pre-refactor outputs are
    bit-identical."""
    fy = np.float32(fy)
    fx = np.float32(fx)
    rng = np.random.default_rng(rng_seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    pattern = np.sin(2 * np.pi * (fy * yy + fx * xx)).astype(np.float32)
    img = pattern[:, :, None] * 0.5 + rng.normal(
        0, 0.3, size=(size, size, 3)).astype(np.float32)
    return _quantize_u8(img)


class SyntheticLoader:
    def __init__(self, cfg: Config, process_index: int, process_count: int,
                 global_batch: int, train: bool):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.global_batch = global_batch
        self.train = train
        self.num_examples = cfg.synthetic_size if train else max(
            cfg.synthetic_size // 4, global_batch)
        if train:
            self.steps_per_epoch = self.num_examples // global_batch
        else:
            self.steps_per_epoch = -(-self.num_examples // global_batch)
        self.local_rows = global_batch // process_count
        # Per-class pattern bank: identical on every host AND between
        # train/val (same classification task); only sample noise differs.
        rng = np.random.default_rng(cfg.seed)
        n_classes = cfg.num_classes
        freqs = rng.uniform(1.0, 4.0, size=(n_classes, 2)).astype(np.float32)
        self._freqs = freqs
        self._pool = None

    def _stream_key(self) -> stream.StreamKey:
        return stream.StreamKey(
            num_examples=self.num_examples,
            global_batch=self.global_batch, seed=self.cfg.seed,
            process_index=self.process_index,
            process_count=self.process_count, shuffle=self.train,
            drop_remainder=self.train)

    def _ensure_pool(self):
        if self._pool is None and self.cfg.workers > 0:
            import multiprocessing as mp
            # spawn, not fork: the process is multithreaded by loader
            # time (torch, the prefetch thread). Workers import numpy
            # only.
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.cfg.workers)

    def epoch(self, epoch: int, start_step: int = 0,
              stats=None) -> Iterator[Batch]:
        """``stats`` is accepted for loader-API uniformity and unused:
        generation is demand-driven in the caller's thread (no staging
        queue of its own to wait on)."""
        cfg = self.cfg
        self._ensure_pool()
        labels_all = (np.arange(self.num_examples, dtype=np.int64)
                      % cfg.num_classes)
        for step, rows in stream.open_stream(self._stream_key(), epoch,
                                             start_step):
            valid = rows[rows != stream.PAD_ROW]
            labels = labels_all[valid].astype(np.int32)
            # Distinct noise draws for train vs val rows (same class
            # patterns, different samples → a real generalization split).
            off = 0 if self.train else 10_000_019
            args = [(float(self._freqs[int(lb)][0]),
                     float(self._freqs[int(lb)][1]), cfg.image_size,
                     cfg.seed * 1000003 + int(r) + off)
                    for lb, r in zip(labels, valid)]
            if not args:
                images = np.zeros(
                    (0, cfg.image_size, cfg.image_size, 3), np.uint8)
            elif self._pool is not None:
                images = np.stack(
                    self._pool.starmap(_gen_one, args, chunksize=8))
            else:
                images = np.stack([_gen_one(*a) for a in args])
            yield pad_batch(images, labels, self.local_rows)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
