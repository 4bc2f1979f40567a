"""Process-0 logging: stdout epoch summaries + TensorBoard scalars.

Copy of ``imagent_tpu/utils/logging.py`` for the PyTorch port, without the
telemetry, SLO and pod series (not ported in this slice); epoch times
print to the millisecond.

Mirrors the reference's L6 outputs (``imagenet.py:362-421``): a master-only
``SummaryWriter`` with grouped scalars ``Loss``/``Top1``/``Top5`` (train +
test series on one chart) and ``lr`` (``imagenet.py:405-421``), plus epoch
summary prints (``imagenet.py:397-403``) and the final best/total summary
(``imagenet.py:422-429``).
"""

from __future__ import annotations


class TrainLogger:
    """All methods no-op on non-master processes (``imagenet.py:362``)."""

    def __init__(self, log_dir: str, is_master: bool):
        self.is_master = is_master
        self.writer = None
        if is_master:
            # Pure-Python event writer (utils/tb_writer.py); same file
            # format TensorBoard reads.
            from imagent_tpu_torch.utils.tb_writer import SummaryWriter
            self.writer = SummaryWriter(log_dir)

    def epoch_summary(self, epoch: int, lr: float, train: dict,
                      val: dict | None, train_time: float,
                      val_time: float) -> None:
        """``val=None`` means no validation ran this epoch (eval_every>1) —
        nothing is fabricated in its place."""
        if not self.is_master:
            return
        line = (f"Epoch {epoch + 1}: lr {lr:g} | "
                f"train loss {train['loss']:.4f} top1 {train['top1']:.3f} "
                f"top5 {train['top5']:.3f} time {train_time:.3f}s")
        if "host_blocked_s" in train:
            # Data-starvation counters (data/prefetch.py::PrefetchStats):
            # input_wait ≈ epoch time ⇒ the run is input-bound.
            line += (f" input_wait {train['host_blocked_s']:.1f}s "
                     f"h2d {train['h2d_bytes'] / 1e9:.2f}GB")
        if val is not None:
            line += (f" | val loss {val['loss']:.4f} top1 {val['top1']:.3f} "
                     f"top5 {val['top5']:.3f} time {val_time:.3f}s")
            if "host_blocked_s" in val:
                line += f" input_wait {val['host_blocked_s']:.1f}s"
        print(line, flush=True)

    def scalars(self, epoch: int, lr: float, train: dict,
                val: dict | None) -> None:
        """Same scalar names/groupings as ``imagenet.py:405-421``; the
        ``test`` series only gets points for epochs that actually ran
        validation."""
        if self.writer is None:
            return
        for group, key in (("Loss", "loss"), ("Top1", "top1"),
                           ("Top5", "top5")):
            series = {"train": train[key]}
            if val is not None:
                series["test"] = val[key]
            self.writer.add_scalars(group, series, epoch)
        self.writer.add_scalar("lr", lr, epoch)
        if "host_blocked_s" in train:
            # Input-pipeline health series: blocked time trending up at
            # constant h2d volume = the host side is falling behind.
            self.writer.add_scalar("data/host_blocked_s",
                                   train["host_blocked_s"], epoch)
            self.writer.add_scalar("data/h2d_mb",
                                   train["h2d_bytes"] / 1e6, epoch)
        if val is not None and "host_blocked_s" in val:
            # Eval reads its own (often different) storage path and
            # must NOT pollute the train series `data/host_blocked_s`
            # that the --input-wait-alert threshold and the thread-
            # scaling budget (docs/ROOFLINE.md) are judged against —
            # the split is regression-tested (tests/test_telemetry.py
            # and the offload drill in tests/test_offload.py).
            self.writer.add_scalar("data/eval_blocked_s",
                                   val["host_blocked_s"], epoch)
            self.writer.add_scalar("data/eval_h2d_mb",
                                   val["h2d_bytes"] / 1e6, epoch)
        self.writer.flush()

    def final_summary(self, best_epoch: int, best_top1: float,
                      best_top5: float, total_minutes: float) -> None:
        """Reference's end-of-run block (``imagenet.py:422-429``,
        visible at ``imagent_sgd.out:875-878``)."""
        if not self.is_master:
            return
        print(f"Best top-1: {best_top1:.3f} (epoch {best_epoch + 1})",
              flush=True)
        print(f"Best top-5: {best_top5:.3f}", flush=True)
        print(f"Total training time: {total_minutes:.2f} min", flush=True)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
