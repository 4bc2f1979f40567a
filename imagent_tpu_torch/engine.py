"""The orchestrator: config -> device -> data -> model -> epoch loop ->
summary (the main-path half of ``imagent_tpu/engine.py``, ported to
PyTorch).

One process per device, synchronous data parallelism across a Slurm
world (``cluster.initialize`` forms the group; the steps reduce over
it): the ResNet, ViT and ConvNeXt families through the synthetic,
image-folder or tar-shard loader (the decode path, native or PIL, named
on one start-up line; rank ``r`` of ``W`` takes rows ``r::W`` of each
global batch of ``batch_size x W x grad_accum``, or of
``--global-batch``, which fixes the batch and derives ``grad_accum``),
train and eval steps from
``train.py`` (which put the model in train or eval mode themselves, so
BatchNorm normalises by batch statistics in training and by its running
ones in ``evaluate``), best/last checkpoints written by rank 0 while the
other ranks wait at a barrier (BatchNorm's running statistics included:
every rank restores them on a rollback or ``--resume``; BEST only when
top-1 strictly improves on the best so far, which starts at 0, as in the
JAX engine, so a run whose top-1 stays 0 writes none), epoch summaries
and TensorBoard scalars on rank 0. Every decision that must agree across
ranks (BEST, rollback) is taken from the reduced metric vectors, which
are the same on every rank, so it costs no collective of its own.
Host-sync discipline
follows the JAX engine: steps are dispatched asynchronously and the
per-step metric vectors are read ``_GUARD_LAG`` steps behind the dispatch
(``_LaggedMetrics``), so the host reads only vectors whose step has
almost always retired. The non-finite guard's verdicts ride the same
vectors (``n == 0`` marks a skipped step); ``--max-bad-steps``
consecutive skips roll the state back to the last checkpoint.

Not ported in this slice: preemption signals, watchdog, deadman,
elastic pods, telemetry, status files, compile cache, torch
import/export. The start-up line of ``config.skipped_line`` names the
ones the JAX package runs by default.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from imagent_tpu_torch import checkpoint as ckpt_lib
from imagent_tpu_torch import cluster
from imagent_tpu_torch.config import Config, check_ported, skipped_line
from imagent_tpu_torch.data import make_loaders
from imagent_tpu_torch.data.pipeline import WIRE_DTYPES
from imagent_tpu_torch.data.prefetch import Prefetcher, PrefetchStats
from imagent_tpu_torch.models import create_model
from imagent_tpu_torch.resilience import exitcodes
from imagent_tpu_torch.schedule import lr_for_epoch
from imagent_tpu_torch.train import (
    create_train_state, make_eval_step, make_optimizer, make_train_step,
)
from imagent_tpu_torch.utils.logging import TrainLogger
from imagent_tpu_torch.utils.metrics import AverageMeter

_GUARD_LAG = 2  # steps behind the dispatch the lagged frontier reads
# Consecutive rollbacks before the run gives up (the fault reproduces
# on every replay).
_MAX_ROLLBACKS = 3


class _LaggedMetrics:
    """Per-step ``[loss_sum, top1, top5, n, ...]`` vectors consumed
    ``lag`` steps behind the dispatch. Each read copies a vector whose
    step has (almost always) finished, so the loop never waits on the
    step it just queued; ``drain()`` reads the last ``lag``. The
    non-finite guard (``bad``/``tripped``) and the ``--log-every``
    readout (``last``) ride the same consumed stream."""

    def __init__(self, lag: int = _GUARD_LAG, max_bad: int = 0,
                 is_master: bool = False):
        self._pending: collections.deque = collections.deque()
        self.lag = lag
        self.max_bad = max_bad
        self.is_master = is_master
        self._sums = np.zeros(4, np.float64)
        self.steps = 0
        self.bad_steps = 0
        self.consec_bad = 0
        self.tripped = False
        self.last: np.ndarray | None = None  # newest consumed vector

    def _consume(self, m) -> None:
        v = m.cpu().numpy().astype(np.float64)
        self._sums += v[:4]
        self.steps += 1
        self.last = v
        if v[3] == 0:  # n == 0: the in-step guard skipped this step
            self.bad_steps += 1
            self.consec_bad += 1
            if self.is_master and self.max_bad:
                print(f"WARNING: non-finite step skipped "
                      f"({self.consec_bad} consecutive; rollback at "
                      f"{self.max_bad})", flush=True)
            if self.max_bad and self.consec_bad >= self.max_bad:
                self.tripped = True
        else:
            self.consec_bad = 0

    def push(self, m) -> None:
        """Record a just-dispatched step's vector; consume the one now
        ``lag`` steps old."""
        self._pending.append(m)
        if len(self._pending) > self.lag:
            self._consume(self._pending.popleft())

    def drain(self) -> bool:
        """Consume the tail; True if the consecutive-bad budget tripped."""
        while self._pending:
            self._consume(self._pending.popleft())
        return self.tripped

    def summary(self) -> dict:
        loss_sum, c1, c5, n = [float(x) for x in self._sums]
        n = max(n, 1.0)
        return {"loss": loss_sum / n, "top1": c1 * 100.0 / n,
                "top5": c5 * 100.0 / n,
                "n": int(n) if self.steps else 0,
                "bad_steps": self.bad_steps}


def train_one_epoch(cfg: Config, device, train_step, state, loader,
                    epoch: int, lr: float, is_master: bool,
                    prefetch: Prefetcher | None = None):
    """One training epoch (reference ``train()``, ``imagenet.py:97-151``).
    Returns ``(state, metrics, seconds, rollback, warm)``: ``rollback``
    is True when ``--max-bad-steps`` consecutive steps were skipped;
    ``warm`` is the next epoch's already-running ``Prefetcher``."""
    t0 = time.time()
    data_time = AverageMeter("data")
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    acc = _LaggedMetrics(max_bad=max(cfg.max_bad_steps, 0),
                         is_master=is_master)
    rollback = False
    it = prefetch if prefetch is not None else Prefetcher(
        device, loader.epoch(epoch), depth=cfg.prefetch_depth)
    try:
        t_fetch = time.time()
        for step_i, (images, labels) in enumerate(it):
            data_time.update(time.time() - t_fetch)
            state, metrics = train_step(state, images, labels, lr_t)
            acc.push(metrics)
            if acc.tripped:
                rollback = True
                break
            if is_master and cfg.log_every \
                    and (step_i + 1) % cfg.log_every == 0 \
                    and acc.last is not None:
                # The printed loss lags the step counter by <= _GUARD_LAG.
                m = acc.last
                print(f"  epoch {epoch + 1} step {step_i + 1}/"
                      f"{loader.steps_per_epoch} loss "
                      f"{m[0] / max(m[3], 1):.4f} "
                      f"data_time {data_time.avg:.3f}s", flush=True)
            t_fetch = time.time()
    finally:
        it.close()
    stats = it.stats
    # Warm the next epoch's staging before draining this epoch's tail.
    warm = None
    if not rollback and epoch + 1 < cfg.epochs:
        warm = Prefetcher(device, loader.epoch(epoch + 1),
                          depth=cfg.prefetch_depth)
    if acc.drain():
        rollback = True
        if warm is not None:
            warm.close()
            warm = None
    metrics = acc.summary()
    metrics["host_blocked_s"] = round(stats.wait_s, 3)
    metrics["h2d_bytes"] = int(stats.bytes_staged)
    return state, metrics, time.time() - t0, rollback, warm


def evaluate(cfg: Config, device, eval_step, state, loader, epoch: int):
    """Validation epoch (reference ``validate()``, ``imagenet.py:166-210``),
    exact under padding via the mask; every batch is dispatched before
    the lagged frontier reads its vector."""
    t0 = time.time()
    stats = PrefetchStats()
    acc = _LaggedMetrics()
    it = Prefetcher(device, loader.epoch(epoch), with_mask=True,
                    depth=cfg.prefetch_depth, stats=stats)
    try:
        for images, labels, mask in it:
            acc.push(eval_step(state, images, labels, mask))
    finally:
        it.close()
    acc.drain()
    metrics = acc.summary()
    metrics["host_blocked_s"] = round(stats.wait_s, 3)
    metrics["h2d_bytes"] = int(stats.bytes_staged)
    return metrics, time.time() - t0


def _validate(cfg: Config) -> None:
    check_ported(cfg)
    if cfg.grad_accum < 1:
        raise ValueError("--grad-accum must be >= 1")
    if cfg.dp < 0:
        raise ValueError("--dp must be >= 0 (0 = unset)")
    if cfg.global_batch < 0:
        raise ValueError("--global-batch must be >= 0 (0 = "
                         "batch_size x dp x grad_accum)")
    if cfg.global_batch and cfg.grad_accum > 1:
        raise ValueError(
            "--grad-accum is DERIVED under the --global-batch contract "
            "(global_batch / (batch_size x dp)); drop --grad-accum, or "
            "drop --global-batch to size the global batch from it")
    if cfg.batch_size < 1:
        raise ValueError("--batch-size must be >= 1")
    if cfg.prefetch_depth < 1:
        raise ValueError("--prefetch-depth must be >= 1")
    if cfg.workers < 0:
        raise ValueError("--workers must be >= 0 (0 = in-process)")
    if cfg.eval_every < 1:
        raise ValueError("--eval-every must be >= 1")
    if cfg.transfer_dtype not in WIRE_DTYPES:
        raise ValueError(f"--transfer-dtype must be one of "
                         f"{'|'.join(WIRE_DTYPES)}, "
                         f"got {cfg.transfer_dtype!r}")


def batch_geometry(cfg: Config, world: int) -> tuple[int, int]:
    """``(global_batch, grad_accum)`` at ``world`` data-parallel ranks:
    ``batch_size x world x grad_accum``, or under ``--global-batch`` that
    batch, with ``grad_accum = global_batch / (batch_size x world)``."""
    if cfg.dp and cfg.dp != world:
        raise ValueError(
            f"--dp {cfg.dp} does not match the world: {world} process(es), "
            "one per device. Fix the world size or --dp — silent "
            "resharding is refused.")
    if not cfg.global_batch:
        return cfg.batch_size * world * cfg.grad_accum, cfg.grad_accum
    denom = cfg.batch_size * world
    if cfg.global_batch % denom:
        raise ValueError(
            f"--global-batch {cfg.global_batch} is not divisible by "
            f"batch_size x data_parallel = {cfg.batch_size} x {world} = "
            f"{denom} at this world size. Pick a global batch divisible "
            "at every world size the job may run at (or adjust "
            "--batch-size).")
    return cfg.global_batch, cfg.global_batch // denom


def run(cfg: Config) -> dict:
    """Full training run. Returns the final summary dict."""
    _validate(cfg)
    senv, device, group = cluster.initialize(cfg.backend)
    try:
        print(cluster.rank_banner(senv, device, group), flush=True)
        rank, world = ((senv.global_rank, senv.world_size)
                       if group is not None else (0, 1))
        is_master = rank == 0
        global_batch, accum = batch_geometry(cfg, world)
        if is_master:
            print(f"device {device} data_parallel {world} global_batch "
                  f"{global_batch}"
                  + (f" (grad_accum {accum})" if accum > 1 else "")
                  + (" [fixed --global-batch contract]"
                     if cfg.global_batch else ""), flush=True)
            print(skipped_line(), flush=True)
        train_loader, val_loader = make_loaders(cfg, rank, world,
                                                global_batch)
        decode = getattr(train_loader, "decode_path", None)
        if decode and is_master:
            print(f"decode: {decode}", flush=True)
        try:
            return _run(cfg, device, group, is_master, world, global_batch,
                        accum, train_loader, val_loader)
        finally:
            train_loader.close()
            val_loader.close()
    finally:
        cluster.destroy(group)


def _fused_mlp_plan_line(cfg: Config, device) -> str | None:
    """The start-up line naming, per ConvNeXt stage width, whether the
    blocks run the fused kernels and, if not, why: ``smem`` (the
    kernels' shared memory does not fit the device) or ``device``
    (``auto`` off CUDA)."""
    from imagent_tpu_torch.models.convnext import CONVNEXT_DEFS
    from imagent_tpu_torch.ops.fused_mlp import unfused_reason
    if cfg.fused_mlp == "off" or cfg.arch not in CONVNEXT_DEFS:
        return None
    depths, dims = CONVNEXT_DEFS[cfg.arch]
    parts, fused = [], 0
    for depth, dim in zip(depths, dims):
        why = unfused_reason(cfg.fused_mlp, dim, device=device)
        parts.append(f"C={dim} " + (f"unfused ({why})" if why else "fused"))
        fused += 0 if why else depth
    return (f"fused-mlp {cfg.fused_mlp}: " + ", ".join(parts)
            + f" ({fused}/{sum(depths)} blocks fused)")


def _model_overrides(cfg: Config) -> dict:
    if cfg.arch.startswith("convnext"):
        return {"fused_mlp": cfg.fused_mlp}
    if not cfg.arch.startswith("vit"):
        return {"stem": cfg.stem}
    return {"attn_impl": cfg.attn, "fused_qkv": cfg.fused_qkv,
            "register_tokens": cfg.register_tokens}


def _run(cfg, device, group, is_master, world, global_batch, accum,
         train_loader, val_loader) -> dict:
    plan = _fused_mlp_plan_line(cfg, device)
    if plan and is_master:
        print(plan, flush=True)
    model = create_model(
        cfg.arch, cfg.num_classes, cfg.bf16, image_size=cfg.image_size,
        generator=torch.Generator().manual_seed(cfg.seed),
        **_model_overrides(cfg)).to(device)
    optimizer = make_optimizer(cfg.momentum, cfg.weight_decay,
                               cfg.optimizer)
    state = create_train_state(model, optimizer)
    train_step = make_train_step(
        optimizer, cfg.mean, cfg.std, label_smoothing=cfg.label_smoothing,
        grad_accum=accum, health_stats=cfg.health_stats, group=group)
    eval_step = make_eval_step(cfg.mean, cfg.std, group=group)

    start_epoch = 0
    best_top1, best_top5, best_epoch = 0.0, 0.0, -1
    if cfg.resume:
        meta = ckpt_lib.restore(cfg.ckpt_dir, ckpt_lib.LAST, state)
        if meta is not None:
            recorded = int(meta.get("global_batch", 0))
            if cfg.global_batch and recorded and recorded != global_batch:
                raise ValueError(
                    f"--global-batch {global_batch} does not match the "
                    f"checkpoint's recorded global batch {recorded} — the "
                    "fixed-batch contract pins the optimization "
                    "trajectory; resuming with a different value would "
                    "silently change it")
            start_epoch = int(meta["epoch"]) + 1
            best_top1 = float(meta.get("best_top1", 0.0))
            best_top5 = float(meta.get("best_top5", 0.0))
            best_epoch = int(meta.get("best_epoch", -1))
            if is_master:
                print(f"resumed from epoch {start_epoch}", flush=True)
        elif is_master:
            print(f"--resume: no checkpoint under {cfg.ckpt_dir}; "
                  "starting fresh", flush=True)
    topo_meta = {"global_batch": global_batch, "process_count": world,
                 "data_parallel": world, "seed": cfg.seed, "arch": cfg.arch}

    logger = TrainLogger(cfg.log_dir, is_master)
    run_t0 = time.time()
    train_m = {"loss": 0.0, "top1": 0.0, "top5": 0.0}
    val_m = {"loss": 0.0, "top1": 0.0, "top5": 0.0}
    rollbacks = rollback_streak = 0
    warm = None
    epoch = start_epoch
    try:
        while epoch < cfg.epochs:
            lr = lr_for_epoch(cfg, epoch)
            state, train_m, train_t, want_rollback, warm = train_one_epoch(
                cfg, device, train_step, state, train_loader, epoch, lr,
                is_master, prefetch=warm)
            if want_rollback:
                rollbacks += 1
                rollback_streak += 1
                if rollback_streak > _MAX_ROLLBACKS:
                    raise exitcodes.RollbackGiveUpError(
                        f"non-finite steps persisted through "
                        f"{_MAX_ROLLBACKS} consecutive rollbacks — giving "
                        "up (check data / lr / bf16 ranges)")
                meta = ckpt_lib.restore(cfg.ckpt_dir, ckpt_lib.LAST, state)
                if meta is None:
                    if is_master:
                        print(f"WARNING: {cfg.max_bad_steps} consecutive "
                              f"non-finite steps in epoch {epoch + 1} and "
                              "no checkpoint to roll back to "
                              "(--save-model off?). State is unpoisoned "
                              "(updates were skipped in the step); "
                              "abandoning the rest of this epoch",
                              flush=True)
                    epoch += 1
                    continue
                epoch = int(meta["epoch"]) + 1
                if is_master:
                    print(f"ROLLBACK {rollback_streak}/{_MAX_ROLLBACKS}: "
                          f"restored checkpoint '{ckpt_lib.LAST}', "
                          f"replaying from epoch {epoch + 1}", flush=True)
                continue
            rollback_streak = 0
            did_eval = ((epoch + 1) % cfg.eval_every == 0
                        or epoch == cfg.epochs - 1)
            val_t = 0.0
            if did_eval:
                val_m, val_t = evaluate(cfg, device, eval_step, state,
                                        val_loader, epoch)
                if val_m["top1"] > best_top1:
                    best_top1, best_top5, best_epoch = (
                        val_m["top1"], val_m["top5"], epoch)
                    if cfg.save_model and is_master:
                        ckpt_lib.save(cfg.ckpt_dir, ckpt_lib.BEST, state, {
                            "epoch": epoch, "best_top1": best_top1,
                            "best_top5": best_top5,
                            "best_epoch": best_epoch, **topo_meta})
            if cfg.save_model:
                if is_master:
                    ckpt_lib.save(cfg.ckpt_dir, ckpt_lib.LAST, state, {
                        "epoch": epoch, "best_top1": best_top1,
                        "best_top5": best_top5, "best_epoch": best_epoch,
                        **topo_meta})
                # No rank reads a checkpoint (a rollback) before rank 0
                # has written it whole.
                cluster.barrier(group)
            if is_master and train_m.get("bad_steps"):
                print(f"  epoch {epoch + 1}: {train_m['bad_steps']} "
                      "non-finite step(s) skipped", flush=True)
            logger.epoch_summary(epoch, lr, train_m,
                                 val_m if did_eval else None, train_t,
                                 val_t)
            logger.scalars(epoch, lr, train_m, val_m if did_eval else None)
            epoch += 1
        total_min = (time.time() - run_t0) / 60.0
        logger.final_summary(best_epoch, best_top1, best_top5, total_min)
    finally:
        if warm is not None:
            warm.close()
        logger.close()
    return {"best_top1": best_top1, "best_top5": best_top5,
            "best_epoch": best_epoch, "total_minutes": total_min,
            "final_train": train_m, "final_val": val_m,
            "rollbacks": rollbacks}
