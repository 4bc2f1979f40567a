"""The port's host-side data path and step math against the JAX
package's: synthetic batches bit for bit, the sample stream, the loss
(with label smoothing), rank-based top-k on ties, the LR schedule, the
Slurm parser, and the device staging of uint8 batches."""

import dataclasses

import numpy as np
import pytest
import torch
from mp_launch import free_port

from imagent_tpu import cluster as jax_cluster
from imagent_tpu import schedule as jax_schedule
from imagent_tpu.config import Config as JaxConfig
from imagent_tpu.data import stream as jax_stream
from imagent_tpu.data.synthetic import SyntheticLoader as JaxSynthetic
from imagent_tpu.ops.cross_entropy import softmax_cross_entropy as jax_ce
from imagent_tpu.utils.metrics import topk_correct as jax_topk
from imagent_tpu_torch import cluster, schedule
from imagent_tpu_torch.config import Config
from imagent_tpu_torch.data import stream
from imagent_tpu_torch.data.prefetch import Prefetcher
from imagent_tpu_torch.data.synthetic import SyntheticLoader
from imagent_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from imagent_tpu_torch.utils.metrics import topk_correct

torch.set_num_threads(2)


def _pair(**kw):
    return JaxConfig(**kw), Config(**kw)


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_batches_bit_identical_for_two_epochs(train):
    jcfg, tcfg = _pair(dataset="synthetic", image_size=16, num_classes=5,
                       synthetic_size=40, workers=0, seed=3)
    want = JaxSynthetic(jcfg, 0, 1, 8, train=train)
    got = SyntheticLoader(tcfg, 0, 1, 8, train=train)
    assert got.steps_per_epoch == want.steps_per_epoch
    for epoch in (0, 1):
        pairs = list(zip(want.epoch(epoch), got.epoch(epoch), strict=True))
        assert pairs
        for w, g in pairs:
            assert g.images.dtype == np.uint8
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.labels, w.labels)
            np.testing.assert_array_equal(g.mask, w.mask)


def test_stream_rows_identical_incl_mid_epoch_open():
    for shuffle, drop in ((True, True), (False, False)):
        kw = dict(num_examples=37, global_batch=8, seed=5, process_index=1,
                  process_count=2, shuffle=shuffle, drop_remainder=drop)
        jk, tk = jax_stream.StreamKey(**kw), stream.StreamKey(**kw)
        for start in (0, 2):
            w = list(jax_stream.open_stream(jk, 3, start))
            g = list(stream.open_stream(tk, 3, start))
            assert [s for s, _ in g] == [s for s, _ in w]
            for (_, a), (_, b) in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(6,)).astype(np.int32)
    want = np.asarray(jax_ce(logits, labels, smoothing))
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), smoothing).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_topk_by_rank_on_ties_matches_jax():
    logits = np.zeros((4, 8), np.float32)
    logits[1, 5] = 1.0          # target 0 has 1 logit strictly above
    logits[2, :6] = 2.0         # target 3 tied with 5 others: rank 0
    logits[3] = np.arange(8)    # target 1: 6 strictly above
    labels = np.array([2, 0, 3, 1], np.int32)
    want = [float(x) for x in jax_topk(logits, labels)]
    got = [float(x) for x in topk_correct(torch.from_numpy(logits),
                                          torch.from_numpy(labels))]
    assert got == want == [2.0, 3.0]


def test_schedule_matches_jax():
    for kw in ({}, {"schedule": "cosine", "warmup_epochs": 2},
               {"lr_decay_period": 3, "lr_decay_factor": 0.5}):
        jcfg, tcfg = _pair(epochs=9, lr=0.3, **kw)
        assert ([schedule.lr_for_epoch(tcfg, e) for e in range(9)]
                == [jax_schedule.lr_for_epoch(jcfg, e) for e in range(9)])


def test_slurm_parsing_matches_jax():
    env = {"SLURM_JOB_NUM_NODES": "2", "SLURM_NODEID": "1",
           "SLURM_LOCALID": "0", "SLURM_PROCID": "1", "SLURM_NTASKS": "2",
           "SLURM_JOB_NODELIST": "ener[021-022]"}
    assert (dataclasses.astuple(cluster.parse_slurm_env(env))
            == dataclasses.astuple(jax_cluster.parse_slurm_env(env))[:6])
    for nodes in ("n[1,3,5-7]b", "a01,b[09-10]"):
        assert (cluster.expand_nodelist(nodes)
                == jax_cluster.expand_nodelist(nodes))
    # The JAX package's refusal of a port that is not a number, before
    # any group is formed.
    with pytest.raises(ValueError, match="' x' is not a port number"):
        cluster.initialize("cpu", {**env, "IMAGENT_COORDINATOR_PORT": " x"})
    # A Slurm world of one forms its group too (gloo on the CPU), at the
    # nodelist's first host; "gloo" is the reference's name for cpu.
    one = {**env, "SLURM_NTASKS": "1", "SLURM_JOB_NUM_NODES": "1",
           "SLURM_PROCID": "0", "SLURM_NODEID": "0",
           "SLURM_JOB_NODELIST": "127.0.0.1",
           "IMAGENT_COORDINATOR_PORT": str(free_port())}
    senv, device, group = cluster.initialize("gloo", one)
    try:
        assert device.type == "cpu" and group is not None
        assert torch.distributed.get_backend(group) == "gloo"
        assert ("[rank 0/1] node 0/1 local_rank 0 coordinator 127.0.0.1 "
                "world 1 over gloo device=cpu") in cluster.rank_banner(
                    senv, device, group)
    finally:
        cluster.destroy(group)
    assert not torch.distributed.is_initialized()
    assert cluster.initialize("cpu", {})[2] is None


def test_cpu_staging_keeps_the_uint8_wire():
    cfg = Config(dataset="synthetic", image_size=16, num_classes=3,
                 synthetic_size=24, workers=0)
    loader = SyntheticLoader(cfg, 0, 1, 8, train=False)
    pf = Prefetcher(torch.device("cpu"), loader.epoch(0), with_mask=True)
    batches = list(pf)
    pf.close()
    assert len(batches) == loader.steps_per_epoch
    images, labels, mask = batches[0]
    assert images.dtype == torch.uint8 and images.shape == (8, 16, 16, 3)
    assert labels.dtype == torch.int32 and mask.dtype == torch.uint8
    assert pf.stats.batches == len(batches)
    assert pf.stats.bytes_staged == sum(
        x.numel() * x.element_size() for b in batches for x in b)
