"""Metrics: running meters and top-k accuracy (PyTorch port of
``imagent_tpu/utils/metrics.py``).

``topk_correct`` counts by RANK: a target is top-k correct when fewer
than k logits strictly exceed its logit. Ties therefore count in the
target's favour, as in the JAX package; ``torch.topk``'s index-order
tie-breaking is not used.
"""

from __future__ import annotations

import torch


class AverageMeter:
    """Running value/sum/count/average (reference ``imagenet.py:44-60``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AverageMeter({self.name}: val={self.val:.4f} avg={self.avg:.4f})"


def topk_rank(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-sample count of logits strictly above the target's (0 = argmax)."""
    logits = logits.float()
    target_logit = logits.gather(1, targets.long()[:, None])
    return (logits > target_logit).sum(1)


def topk_correct(logits: torch.Tensor, targets: torch.Tensor,
                 topk=(1, 5)) -> tuple[torch.Tensor, ...]:
    """Per-k correct counts as fp32 device scalars (no host sync)."""
    rank = topk_rank(logits, targets)
    return tuple((rank < k).sum().float() for k in topk)
