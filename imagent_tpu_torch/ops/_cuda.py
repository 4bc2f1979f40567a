"""Builds the hand-written CUDA kernels under ``imagent_tpu_torch/csrc``
into plain-C shared libraries and loads them with ``ctypes``.

The first use builds: ``nvcc`` compiles each source for
``sm_90a`` into ``build/kernels/`` at the root of the checkout, under a
name keyed on a hash of the source, the shared headers and the flags,
so an edited kernel is rebuilt and an unchanged one is reused. No PyTorch headers are
compiled in (a source with a plain C interface builds in seconds), and
nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Wall-clock bound of one source's nvcc (the slowest took ~40 s on the
# H100 machine); a build past it is killed and fails.
NVCC_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time, "log": nvcc/ptxas output}; empty
# for a library found already built.
BUILD_LOG: dict[str, dict] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on first use")
    return found


def _target(name: str) -> Path:
    """The library's path, keyed on the source, the shared headers of
    ``csrc`` (``*.cuh``) and the flags."""
    data = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    key = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def build(names) -> None:
    """Build every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together, each killed past
    ``NVCC_TIMEOUT_S``. Raises with the compiler's output if any build
    fails."""
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, t0, proc in jobs:
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"nvcc for {name}.cu ran past {NVCC_TIMEOUT_S} s:"
                          f"\n{log}")
            continue
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
