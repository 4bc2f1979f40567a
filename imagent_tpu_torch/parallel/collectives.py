"""Sum and mean of tensors across the ranks of a process group
(PyTorch port of ``imagent_tpu/parallel/collectives.py``).

The JAX step's ``lax.psum``/``lax.pmean`` over the data axis become
``torch.distributed.all_reduce`` calls here: NCCL on CUDA devices, gloo
on the CPU. Each call packs its list of tensors into one flat buffer and
makes ONE ``all_reduce`` of it (the JAX step's ``pmean_tree`` fuses its
leaves into one collective the same way), so a train step costs two
collectives whatever the number of tensors. ``pmean`` divides the sum by
the world size, as ``lax.pmean`` does. With no group (one process
outside Slurm) both return their input unchanged and make no call.

``CALLS`` counts the ``all_reduce`` calls made (``reset_calls`` zeroes
it), so a caller can pin the collectives per step.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

CALLS = {"psum": 0, "pmean": 0}


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0


def _all_reduce(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The element-wise sum over ``group`` of each tensor, by one
    ``all_reduce`` of a flat buffer in the tensors' promoted dtype."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors))
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def psum(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor summed over the ranks of ``group`` (identity when
    ``group`` is None)."""
    if group is None:
        return list(tensors)
    CALLS["psum"] += 1
    return _all_reduce(tensors, group)


def pmean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor averaged over the ranks of ``group``: the sum divided
    by the world size (identity when ``group`` is None)."""
    if group is None:
        return list(tensors)
    CALLS["pmean"] += 1
    world = dist.get_world_size(group)
    return [t / world for t in _all_reduce(tensors, group)]
