"""Softmax cross-entropy, the reference's loss (``nn.CrossEntropyLoss()``,
``imagenet.py:323-324``); PyTorch port of ``imagent_tpu/ops/cross_entropy.py``.

Computed from integer labels without one-hots: gather the target logit
and subtract the log-sum-exp, in fp32 whatever the logits' type.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-sample CE loss. ``logits`` (B, C) float, ``labels`` (B,) int.
    Label smoothing mixes in the uniform-target term, as the JAX
    package does: ``(1 - a) * nll + a * (lse - mean(logits))``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, labels.long()[:, None])[:, 0]
    nll = lse - target_logit
    if label_smoothing > 0.0:
        smooth_nll = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth_nll
    return nll
