"""Runtime init: Slurm env parsing, the rank banner and device
resolution (PyTorch port of ``imagent_tpu/cluster.py``).

The Slurm half is a copy: a pure, unit-testable parser of the
``SLURM_*`` contract the reference reads (``imagenet.py:225-234``),
with the nodelist grammar expanded in Python. This slice runs ONE
process: a Slurm world above one task is refused as not yet ported
(multi-process DDP over NCCL is a later slice).

Device: ``--backend gpu`` (the default) resolves to the current CUDA
device and refuses to start when ``torch.cuda.is_available()`` is false
— it never falls back to the CPU; ``--backend cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
from typing import Mapping

import torch


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


def resolve_device(backend: str) -> torch.device:
    """``gpu`` -> the current CUDA device (refused without one);
    ``cpu`` -> the CPU."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend != "gpu":
        raise ValueError(f"--backend must be gpu or cpu, got {backend!r}")
    if not torch.cuda.is_available():
        raise ValueError(
            "--backend gpu: no CUDA device is available "
            "(torch.cuda.is_available() is false); pass --backend cpu "
            "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def initialize(backend: str, env: Mapping[str, str] | None = None,
               ) -> tuple[SlurmEnv | None, torch.device]:
    """Parse the launch geometry and resolve the device. A world of
    more than one process is refused: not yet ported."""
    senv = parse_slurm_env(os.environ if env is None else env)
    if senv is not None and senv.world_size > 1:
        raise ValueError(
            f"a {senv.world_size}-process Slurm world is not yet ported to "
            "imagent_tpu_torch (this slice runs one process; launch with "
            "one task)")
    return senv, resolve_device(backend)


def rank_banner(senv: SlurmEnv | None, device: torch.device) -> str:
    """The per-rank init banner the reference prints
    (``imagenet.py:252-262``), naming the device."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if senv is None:
        return f"[proc 0/1] device={device} ({name}) (no Slurm env)"
    return (f"[rank {senv.global_rank}/{senv.world_size}] "
            f"node {senv.node_id}/{senv.n_nodes} local_rank "
            f"{senv.local_rank} coordinator {senv.coordinator} "
            f"device={device} ({name})")
