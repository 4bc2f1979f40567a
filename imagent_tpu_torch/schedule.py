"""Learning-rate schedules.

Parity schedule is the reference's step decay
``lr = lr0 * 0.1 ** (epoch // 30)`` (``adjust_learning_rate``,
``imagenet.py:154-162``; observable in the log: 0.1 → 0.01 → 0.001 → 1e-4 at
epochs 1/31/61/91, ``imagent_sgd.out:274,454,634,814``). Warmup and cosine
are additive capabilities.

Copy of ``imagent_tpu/schedule.py`` for the PyTorch port.
"""

from __future__ import annotations

import math

from imagent_tpu_torch.config import Config


def step_decay(lr0: float, epoch: int, period: int = 30,
               factor: float = 0.1) -> float:
    """Reference schedule (``imagenet.py:158``)."""
    return lr0 * factor ** (epoch // period)


def cosine(lr0: float, epoch: int, total_epochs: int) -> float:
    return 0.5 * lr0 * (1.0 + math.cos(math.pi * epoch / max(total_epochs, 1)))


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """Epoch-granularity LR, applied once per epoch like the reference's
    ``adjust_learning_rate`` call at ``imagenet.py:378``."""
    if cfg.warmup_epochs > 0 and epoch < cfg.warmup_epochs:
        return cfg.lr * (epoch + 1) / cfg.warmup_epochs
    e = epoch - cfg.warmup_epochs
    if cfg.schedule == "cosine":
        return cosine(cfg.lr, e, cfg.epochs - cfg.warmup_epochs)
    return step_decay(cfg.lr, e, cfg.lr_decay_period, cfg.lr_decay_factor)
