"""Deterministic sample streams: the seed-and-position-keyed contract
every loader draws its per-epoch sample order from.

The reference's ``DistributedSampler`` + ``set_epoch`` semantics
(``imagenet.py:346-347,375``) made the order a function of
``(seed, epoch)`` — but only implicitly, scattered through each
loader's ``epoch()``. This module makes the contract explicit and
POSITIONAL: a :class:`StreamKey` names everything the order is a
function of, and :func:`open_stream` opens the stream at any
``(epoch, step)`` — so a mid-epoch ``--resume`` (or an elastic-pod
restart later) re-enters the exact sample sequence WITHOUT decoding
and discarding the already-trained prefix, and a decode-offload host
can compute the same rows a training host will ask for without any
coordination (shared-nothing: the stream is pure math).

Contract (pinned for the JAX package's four loader paths by
tests/test_stream.py):

* every epoch, a permutation of the dataset seeded by ``seed + epoch``;
* process ``p`` of ``P`` takes rows ``p::P`` of the permutation;
* train drops the global remainder; eval pads with :data:`PAD_ROW`
  sentinels so every process yields the same batch count (the SPMD
  collective invariant);
* ``open_stream(key, epoch, start_step=s)`` yields exactly the batches
  ``s, s+1, ...`` of ``open_stream(key, epoch)`` — position-keyed, so
  no sample is replayed and none skipped across an interruption.

Copy of ``imagent_tpu/data/stream.py`` for the PyTorch port, which
imports nothing of the JAX package: the same key gives the same rows in
both packages (tests/test_torch_port_data.py). numpy only, no torch, so
spawned generator workers import it cheaply.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

PAD_ROW = -1  # sentinel: padded slot, contributes mask 0


@dataclasses.dataclass(frozen=True)
class StreamKey:
    """Everything the per-epoch sample order is a function of — and
    NOTHING else. Two stream opens with equal keys yield identical
    ``(step, rows)`` sequences on any host, any time; the engine's
    mid-epoch-resume topology guard (``engine._resume_point``) is
    exactly the check that a checkpoint's recorded key fields still
    match the resuming run's."""

    num_examples: int
    global_batch: int
    seed: int
    process_index: int
    process_count: int
    shuffle: bool         # train: epoch-seeded permutation
    drop_remainder: bool  # train: full global batches only; eval: pad

    @property
    def local_rows(self) -> int:
        return self.global_batch // self.process_count

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.num_examples // self.global_batch
        return -(-self.num_examples // self.global_batch)


def epoch_order(key: StreamKey, epoch: int) -> np.ndarray:
    """This host's slot array for one epoch (``PAD_ROW`` marks eval
    padding). Mirrors ``DistributedSampler`` + ``set_epoch``: the
    global permutation is seeded by ``seed + epoch``, every process
    receives the SAME number of slots (unequal per-host batch counts
    would deadlock the eval step's collective — the invariant
    DistributedSampler keeps by padding)."""
    n = key.num_examples
    order = (np.random.default_rng(key.seed + epoch).permutation(n)
             if key.shuffle else np.arange(n, dtype=np.int64))
    if key.drop_remainder:
        usable = (n // key.global_batch) * key.global_batch
        order = order[:usable]
    else:
        padded = -(-n // key.global_batch) * key.global_batch
        order = np.concatenate(
            [order, np.full(padded - n, PAD_ROW, np.int64)])
    return np.asarray(order[key.process_index::key.process_count],
                      np.int64)


def open_stream(key: StreamKey, epoch: int, start_step: int = 0,
                ) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(step, rows)`` batches from ``start_step`` on.

    Position-keyed: the skipped prefix is never materialized per batch,
    let alone decoded — opening at step 10k of a 1.28M-image epoch
    costs one permutation draw and an array slice, not 10k batch
    decodes (what the engine's old skip-and-discard resume paid).
    """
    if start_step < 0:
        raise ValueError(f"start_step must be >= 0, got {start_step}")
    idx = epoch_order(key, epoch)
    rows = key.local_rows
    for start in range(start_step * rows, len(idx), rows):
        chunk = idx[start:start + rows]
        if len(chunk) == rows:
            yield start // rows, chunk
