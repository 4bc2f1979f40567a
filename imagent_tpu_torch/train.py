"""Train and eval steps (PyTorch port of ``imagent_tpu/train.py``), one
process per data-parallel replica.

The step keeps the JAX step's contract:

* input prep inside the step: the uint8 NHWC wire batch -> fp32 * 1/255
  -> ``(x - mean) / std`` (``make_input_prep``);
* loss and gradients from autograd; ``grad_accum`` K is a Python loop
  over K equal micro-batches returning the mean of the per-micro mean
  gradients and the summed metrics (``_scan_microbatches``);
* the update is ``p <- p - lr * u`` with ``u`` from a functional SGD or
  AdamW written to match ``optax`` (``make_optimizer``), not
  ``torch.optim``;
* the non-finite guard: ``gnorm2`` (``_sq_sum`` of the gradients) and the
  metric vector decide ``ok`` (``_nonfinite_local``); every parameter,
  optimizer slot and buffer (BatchNorm's running statistics) then takes
  ``torch.where(ok, new, old)`` (``_skip_if_bad``) and a skipped step
  returns the all-zero metric vector. Nothing in the step reads a value
  back to the host;
* the train step runs the model in train mode (BatchNorm normalises by
  the batch statistics and updates its running ones, chained through
  the micro-batches in order), the eval step in eval mode (the running
  statistics), as the JAX step's ``train=True``/``False``;
* the step returns ``[loss_sum, top1, top5, n]`` then ``HEALTH_FIELDS``
  when ``health_stats`` is on;
* across a process group (``group``; None for one process) the train
  step makes exactly two collectives whatever ``grad_accum`` is: one
  ``pmean`` of the gradients and BatchNorm's running statistics after
  the micro-batches (the JAX step's ``pmean_tree(grads)`` and
  ``pmean_tree(new_bs)``: each replica normalises by its own batch
  statistics, the stored running ones are the replicas' mean), then one
  ``psum`` of ``[local metrics, bad]`` from which every rank takes the
  same ``ok`` (the summed ``bad`` is 0) and the summed metrics (JAX's
  ``psum`` of ``bad`` and of the guarded vector, fused). The eval step
  makes one, the ``psum`` of its masked vector. The health stats need
  none: the gradients are reduced and the parameters replicated.

State is updated in place (parameters with ``copy_``, optimizer slots
replaced) instead of built anew as JAX does: the old and new trees never
both outlive the step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from imagent_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from imagent_tpu_torch.parallel import collectives
from imagent_tpu_torch.utils.metrics import topk_correct, topk_rank

# Health scalars appended past the [loss_sum, top1, top5, n] head when
# health_stats is on — the same wire order as the JAX package.
HEALTH_FIELDS = ("grad_norm", "param_norm", "update_ratio")


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the params), the optimizer slots
    (a dict of tensors and dicts of tensors keyed like the parameters)
    and the step counter, a device scalar."""

    model: nn.Module
    opt_state: dict
    step: torch.Tensor

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


# ------------------------------------------------------------ optimizers


class SGD:
    """``optax.chain(add_decayed_weights(wd), trace(momentum))``: the
    torch.optim.SGD order — grad += wd * param, then the momentum trace
    — as an LR-free direction."""

    def __init__(self, momentum: float, weight_decay: float):
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict):
        trace = {n: grads[n] + self.weight_decay * params[n]
                 + self.momentum * state["trace"][n] for n in grads}
        return trace, {"trace": trace}


class AdamW:
    """``optax.chain(scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
    add_decayed_weights(wd))`` on every leaf, no mask: decoupled weight
    decay that rides the caller's lr."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - torch.pow(torch.full_like(c, self.b1), c)
        bc2 = 1.0 - torch.pow(torch.full_like(c, self.b2), c)
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1.0 - self.b1) * g + self.b1 * state["mu"][n]
            nu[n] = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + self.eps)
            updates[n] = u + self.weight_decay * params[n]
        return updates, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(momentum: float = 0.9, weight_decay: float = 1e-4,
                   name: str = "sgd"):
    """LR-free optimizer by name; the step applies ``-lr``. ``nadam``,
    ``lars`` and ``lamb`` are refused as not yet ported."""
    if name == "sgd":
        return SGD(momentum, weight_decay)
    if name == "adamw":
        return AdamW(weight_decay)
    if name in ("nadam", "lars", "lamb"):
        raise ValueError(f"--optimizer {name} is not yet ported to "
                         "imagent_tpu_torch (sgd, adamw)")
    raise ValueError(f"unknown optimizer {name!r}; one of sgd|adamw")


def create_train_state(model: nn.Module, optimizer) -> TrainState:
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(model=model, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int64, device=device))


# ------------------------------------------------------------ step math

_INV255 = 1.0 / 255.0


def make_input_prep(mean, std):
    """``prep(images) -> fp32 normalized batch``: dequantize the raw
    [0, 255] wire batch, then ``(x - mean) / std``."""
    m = torch.tensor([float(v) for v in mean], dtype=torch.float32)
    s = torch.tensor([float(v) for v in std], dtype=torch.float32)
    consts: dict = {}

    def prep(images):
        if images.device not in consts:
            consts[images.device] = (m.to(images.device), s.to(images.device))
        dm, ds = consts[images.device]
        return (images.float() * _INV255 - dm) / ds

    return prep


def masked_eval_metrics(logits, labels, mask) -> torch.Tensor:
    """``[loss_sum, top1_cnt, top5_cnt, n]`` for one batch with a
    per-sample validity mask (uint8 on the wire): padded eval rows
    contribute nothing. Top-k by rank (strictly-greater count)."""
    mask = mask.float()
    per_sample = softmax_cross_entropy(logits, labels) * mask
    rank = topk_rank(logits, labels)
    return torch.stack([per_sample.sum(), ((rank < 1) * mask).sum(),
                        ((rank < 5) * mask).sum(), mask.sum()])


def _sq_sum(tensors) -> torch.Tensor:
    """One fp32 scalar: the sum of squares over every tensor (non-finite
    values propagate into it)."""
    total = None
    for t in tensors:
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return total


def _nonfinite_local(gnorm2, metrics) -> torch.Tensor:
    """Scalar bool: the step produced a non-finite loss or gradient."""
    return torch.logical_not(torch.isfinite(gnorm2)
                             & torch.all(torch.isfinite(metrics)))


def _health_stats(gnorm2, params: dict, new_params: dict) -> torch.Tensor:
    """``[grad_norm, param_norm, update_ratio]`` (``HEALTH_FIELDS``)."""
    pnorm = torch.sqrt(_sq_sum(params.values()))
    dnorm2 = _sq_sum(new_params[n].float() - p.float()
                     for n, p in params.items())
    return torch.stack([torch.sqrt(gnorm2), pnorm,
                        torch.sqrt(dnorm2) / (pnorm + 1e-12)])


def _skip_if_bad(ok, new, old):
    """Per-tensor select over matching (nested) dicts: the new value on a
    finite step, the pre-step value otherwise."""
    if isinstance(new, dict):
        return {k: _skip_if_bad(ok, new[k], old[k]) for k in new}
    return torch.where(ok, new, old)


def _grads_and_metrics(model, params: dict, images, labels,
                       label_smoothing: float):
    """One batch: (grads, [loss_sum, top1, top5, n])."""
    logits = model(images)
    per_sample = softmax_cross_entropy(logits, labels, label_smoothing)
    grads = torch.autograd.grad(per_sample.mean(), list(params.values()))
    c1, c5 = topk_correct(logits.detach(), labels)
    n = torch.full((), float(labels.shape[0]), device=logits.device)
    metrics = torch.stack([per_sample.detach().sum(), c1, c5, n])
    return dict(zip(params, grads)), metrics


def _accumulate(model, params, images, labels, label_smoothing,
                grad_accum: int):
    """Mean of the per-micro mean gradients over K equal micro-batches,
    metrics summed (``_scan_microbatches``)."""
    if grad_accum <= 1:
        return _grads_and_metrics(model, params, images, labels,
                                  label_smoothing)
    grads_sum, metrics = None, None
    for im, lb in zip(images.reshape(grad_accum, -1, *images.shape[1:]),
                      labels.reshape(grad_accum, -1)):
        g, m = _grads_and_metrics(model, params, im, lb, label_smoothing)
        if grads_sum is None:
            grads_sum, metrics = g, m
        else:
            grads_sum = {n: grads_sum[n] + g[n] for n in g}
            metrics = metrics + m
    return {n: g / grad_accum for n, g in grads_sum.items()}, metrics


def _pmean_grads_and_buffers(grads: dict, buffers: dict, group) -> dict:
    """One ``pmean`` over the gradients and the buffers (BatchNorm's
    running statistics, written back in place); returns the gradients."""
    if group is None:
        return grads
    reduced = collectives.pmean([*grads.values(), *buffers.values()], group)
    for b, r in zip(buffers.values(), reduced[len(grads):]):
        b.copy_(r)
    return dict(zip(grads, reduced[:len(grads)]))


def make_train_step(optimizer, mean, std, label_smoothing: float = 0.0,
                    grad_accum: int = 1, health_stats: bool = False,
                    group=None) -> Callable:
    """``step(state, images, labels, lr) -> (state, metrics)``. ``lr`` is
    a device fp32 scalar (placed once per epoch by the engine). ``group``
    is the process group of the data-parallel replicas, None for one
    process."""
    prep = make_input_prep(mean, std)

    def step(state: TrainState, images, labels, lr):
        state.model.train()
        params = state.params()
        # BatchNorm updates its running statistics in place during the
        # forward pass (chained through the micro-batches in order); the
        # pre-step values are kept for the guard.
        buffers = dict(state.model.named_buffers())
        old_buffers = {n: b.clone() for n, b in buffers.items()}
        grads, local = _accumulate(state.model, params, prep(images), labels,
                                   label_smoothing, grad_accum)
        with torch.no_grad():
            # The reduce waits for the whole backward pass; overlapping
            # it with the backward (DDP's gradient buckets) is left to
            # later performance work.
            grads = _pmean_grads_and_buffers(grads, buffers, group)
            gnorm2 = _sq_sum(grads.values())
            bad = _nonfinite_local(gnorm2, local).to(local.dtype)
            summed, bad_sum = collectives.psum([local, bad.reshape(1)],
                                               group)
            ok = bad_sum[0] == 0
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                params)
            new_params = {n: p + (-lr * updates[n])
                          for n, p in params.items()}
            metrics = torch.where(ok, summed, torch.zeros_like(summed))
            if health_stats:
                metrics = torch.cat([metrics, _health_stats(
                    gnorm2, params, new_params)])
            for n, p in params.items():
                p.copy_(torch.where(ok, new_params[n], p))
            for n, b in buffers.items():
                b.copy_(torch.where(ok, b, old_buffers[n]))
            state.opt_state = _skip_if_bad(ok, new_opt, state.opt_state)
            state.step += 1
        return state, metrics

    return step


def make_eval_step(mean, std, group=None) -> Callable:
    """``eval_step(state, images, labels, mask) -> [loss_sum, top1, top5,
    n]`` over the valid rows of every rank of ``group`` (None: this
    process's)."""
    prep = make_input_prep(mean, std)

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels, mask):
        state.model.eval()
        local = masked_eval_metrics(state.model(prep(images)), labels, mask)
        return collectives.psum([local], group)[0]

    return eval_step
