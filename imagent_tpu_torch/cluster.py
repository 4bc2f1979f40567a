"""Runtime init: Slurm env parsing, the process group, the rank banner
and device resolution (PyTorch port of ``imagent_tpu/cluster.py``).

The Slurm half is a copy: a pure, unit-testable parser of the
``SLURM_*`` contract the reference reads (``imagenet.py:225-234``),
with the nodelist grammar expanded in Python.

One process per device. Under Slurm, ``initialize`` forms the
``torch.distributed`` group of the whole world, a world of one task
included (so a one-card run drives the code a 16-rank job runs), at
``tcp://<first host of the nodelist>:<IMAGENT_COORDINATOR_PORT or
29500>`` with the world size and rank Slurm gives: NCCL on ``--backend
gpu``, gloo on ``--backend cpu``. Outside Slurm no group is formed.

Device: ``--backend gpu`` (the default) takes ``cuda:<SLURM_LOCALID>``
(the current CUDA device outside Slurm) and refuses to start when
``torch.cuda.is_available()`` is false or the local rank has no card of
its own — it never shares a card and never falls back to the CPU or to
gloo; ``--backend cpu`` runs on the CPU. The reference's operator values
``nccl`` and ``gloo`` mean ``gpu`` and ``cpu`` (``BACKEND_ALIASES``).
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
from typing import Mapping

import torch
import torch.distributed as dist

from imagent_tpu_torch.config import BACKEND_ALIASES

# The reference's fixed MASTER_PORT (imagenet.py:242); the
# IMAGENT_COORDINATOR_PORT env var overrides it.
DEFAULT_COORDINATOR_PORT = 29500


@dataclasses.dataclass(frozen=True)
class SlurmEnv:
    """Rank geometry derived from Slurm, mirroring ``imagenet.py:225-234``."""

    n_nodes: int
    node_id: int
    local_rank: int
    global_rank: int
    world_size: int
    coordinator: str  # first hostname of SLURM_JOB_NODELIST


def expand_nodelist(nodelist: str) -> list[str]:
    """Expand a Slurm nodelist expression into hostnames, in pure Python:
    ``ener[021-030]``, ``n[1,3,5-7]b``, comma-separated groups."""
    hosts: list[str] = []
    parts, depth, cur = [], 0, []
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))

    for part in parts:
        m = re.match(r"^([^\[]*)\[([^\]]+)\](.*)$", part)
        if not m:
            hosts.append(part)
            continue
        prefix, body, suffix = m.groups()
        for item in body.split(","):
            if "-" in item:
                lo, hi = item.split("-")
                width = len(lo)
                for i in range(int(lo), int(hi) + 1):
                    hosts.append(f"{prefix}{i:0{width}d}{suffix}")
            else:
                hosts.append(f"{prefix}{item}{suffix}")
    return hosts


def resolve_coordinator(nodelist: str) -> str:
    """First host of the nodelist (the reference's ``scontrol`` master
    resolution, ``imagenet.py:237-238``), falling back to ``scontrol``
    for grammar this parser does not cover."""
    try:
        hosts = expand_nodelist(nodelist)
        if hosts:
            return hosts[0]
    except (ValueError, IndexError):
        pass
    out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return out.split()[0]


def parse_slurm_env(env: Mapping[str, str]) -> SlurmEnv | None:
    """Slurm env dict -> rank geometry, or None outside Slurm."""
    if "SLURM_JOB_NUM_NODES" not in env and "SLURM_NNODES" not in env:
        return None
    n_nodes = int(env.get("SLURM_JOB_NUM_NODES", env.get("SLURM_NNODES", "1")))
    nodelist = env.get("SLURM_JOB_NODELIST", env.get("SLURM_NODELIST", ""))
    return SlurmEnv(
        n_nodes=n_nodes,
        node_id=int(env.get("SLURM_NODEID", "0")),
        local_rank=int(env.get("SLURM_LOCALID", "0")),
        global_rank=int(env.get("SLURM_PROCID", "0")),
        world_size=int(env.get("SLURM_NTASKS", str(n_nodes))),
        coordinator=resolve_coordinator(nodelist) if nodelist else "127.0.0.1",
    )


def coordinator_port(env: Mapping[str, str]) -> int:
    """``IMAGENT_COORDINATOR_PORT`` (two jobs sharing a host must not
    collide on the reference's fixed port), else 29500."""
    raw = env.get("IMAGENT_COORDINATOR_PORT", "")
    try:
        return int(raw.strip()) if raw.strip() else DEFAULT_COORDINATOR_PORT
    except ValueError:
        raise ValueError(f"IMAGENT_COORDINATOR_PORT={raw!r} is not a port "
                         "number") from None


def resolve_device(backend: str, local_rank: int | None = None,
                   ) -> torch.device:
    """``gpu`` -> ``cuda:<local_rank>`` (the current CUDA device when
    ``local_rank`` is None), refused without a card for it; ``cpu`` ->
    the CPU."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend != "gpu":
        raise ValueError(f"--backend must be gpu or cpu, got {backend!r}")
    if not torch.cuda.is_available():
        raise ValueError(
            "--backend gpu: no CUDA device is available "
            "(torch.cuda.is_available() is false); pass --backend cpu "
            "to run on the CPU")
    if local_rank is None:
        return torch.device("cuda", torch.cuda.current_device())
    if local_rank >= torch.cuda.device_count():
        raise ValueError(
            f"--backend gpu: local rank {local_rank} has no CUDA device of "
            f"its own ({torch.cuda.device_count()} visible); launch at "
            "most one task per card")
    return torch.device("cuda", local_rank)


def initialize(backend: str, env: Mapping[str, str] | None = None,
               ) -> tuple[SlurmEnv | None, torch.device,
                          dist.ProcessGroup | None]:
    """Parse the launch geometry, resolve the device and, under Slurm,
    form the process group: ``(senv, device, group)``, with ``group``
    None outside Slurm. Pair with ``destroy``."""
    environ = os.environ if env is None else env
    backend = BACKEND_ALIASES.get(backend, backend)
    senv = parse_slurm_env(environ)
    if senv is None:
        return None, resolve_device(backend), None
    port = coordinator_port(environ)
    device = resolve_device(backend, senv.local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # device_id binds the NCCL communicator to this rank's card at init
    # (and makes barrier() use it) instead of guessing it from the rank.
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{senv.coordinator}:{port}",
        world_size=senv.world_size, rank=senv.global_rank,
        device_id=device if device.type == "cuda" else None)
    return senv, device, dist.group.WORLD


def barrier(group: dist.ProcessGroup | None) -> None:
    """Every rank of ``group`` waits for the others (no-op without)."""
    if group is not None:
        dist.barrier(group)


def destroy(group: dist.ProcessGroup | None) -> None:
    """Tear down the group ``initialize`` formed (no-op without)."""
    if group is not None:
        dist.destroy_process_group()


def rank_banner(senv: SlurmEnv | None, device: torch.device,
                group: dist.ProcessGroup | None = None) -> str:
    """The per-rank init banner the reference prints
    (``imagenet.py:252-262``), naming the world and the device."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if senv is None:
        return f"[proc 0/1] device={device} ({name}) (no Slurm env)"
    world = (f" world {dist.get_world_size(group)} over "
             f"{dist.get_backend(group)}" if group is not None else "")
    return (f"[rank {senv.global_rank}/{senv.world_size}] "
            f"node {senv.node_id}/{senv.n_nodes} local_rank "
            f"{senv.local_rank} coordinator {senv.coordinator}{world} "
            f"device={device} ({name})")
