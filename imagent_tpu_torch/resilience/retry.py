"""Jittered exponential backoff for fragile I/O edges.

A 100-epoch pod run touches the filesystem and forks subprocesses
millions of times; networked storage and a busy Slurm controller WILL
throw transient errors. The reference retried nothing — one EIO killed
the whole job. Callers here (the per-file dataset reads in
``data/imagefolder.py`` / ``data/tarshards.py``) wrap exactly the
fragile call, keep the retry budget small, and jitter the delays so a
thousand workers hitting the same flaky NFS server don't retry in
lockstep.

Copy of ``imagent_tpu/resilience/retry.py`` for the PyTorch port, which
imports nothing of the JAX package. Standard library only.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterable


def backoff_delays(attempts: int, base_delay: float, max_delay: float,
                   jitter: float, rng: random.Random | None = None,
                   ) -> Iterable[float]:
    """The delay schedule between ``attempts`` tries: exponential from
    ``base_delay``, capped at ``max_delay``, each scaled by a uniform
    ``[1, 1 + jitter)`` factor (full-jitter would allow 0-delay retries,
    which defeats the point on a briefly-unavailable file)."""
    rng = rng or random
    for k in range(max(attempts - 1, 0)):
        delay = min(max_delay, base_delay * (2.0 ** k))
        yield delay * (1.0 + jitter * rng.random())


def retry_call(fn: Callable, *args, attempts: int = 3,
               base_delay: float = 0.05, max_delay: float = 2.0,
               jitter: float = 0.5,
               retry_on: tuple[type[BaseException], ...] = (OSError,),
               describe: str = "", sleep: Callable = time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` exceptions up
    to ``attempts`` total tries with jittered exponential backoff. The
    final failure re-raises the original exception — the caller decides
    whether that is fatal (coordinator resolution) or quarantinable (one
    unreadable image). ``sleep`` is injectable for tests."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delays = backoff_delays(attempts, base_delay, max_delay, jitter)
    for k in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if k == attempts - 1:
                raise
            delay = next(delays)
            what = describe or getattr(fn, "__name__", "call")
            print(f"NOTE: {what} failed ({type(e).__name__}: {e}); "
                  f"retry {k + 1}/{attempts - 1} in {delay:.2f}s",
                  flush=True)
            sleep(delay)
