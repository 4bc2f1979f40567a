"""Device prefetch: overlap host->device transfer with the running step
(PyTorch port of ``imagent_tpu/data/prefetch.py``).

A host producer thread pulls ``Batch``es from the loader, copies each
array into pinned host memory and starts a ``non_blocking`` copy to the
card on a side CUDA stream, recording an event. The consumer makes the
compute stream wait on that event and marks the tensors as used there
(``record_stream``), so the copy of batch N+1 overlaps step N and the
caching allocator never reuses a buffer too early. On the CPU the
arrays become tensors directly. A ``uint16`` image array is the bf16
wire (``pipeline.to_wire``) and is viewed as ``torch.bfloat16``.

``PrefetchStats`` counts the consumer's time blocked on the staging
queue and the host bytes staged, per epoch.
"""

from __future__ import annotations

import queue
import threading
import time

import torch


class PrefetchStats:
    """Per-epoch input-starvation counters: ``wait_s`` (consumer time
    blocked in the staging queue), ``max_wait_s``, ``bytes_staged``
    (host bytes handed to the device copy) and ``batches``."""

    __slots__ = ("wait_s", "max_wait_s", "bytes_staged", "batches")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.wait_s = 0.0
        self.max_wait_s = 0.0
        self.bytes_staged = 0
        self.batches = 0


def _stage_batch(device: torch.device, batch, with_mask: bool,
                 stats: PrefetchStats | None, stream):
    """One ``Batch`` -> ``(tensors, event)``; ``event`` is None on CPU."""
    arrays = (batch.images, batch.labels) + ((batch.mask,) if with_mask
                                             else ())
    if stats is not None:
        stats.bytes_staged += sum(a.nbytes for a in arrays)
        stats.batches += 1
    host = [torch.from_numpy(a) for a in arrays]
    if host[0].dtype == torch.uint16:  # the bf16 wire: bf16 bit patterns
        host[0] = host[0].view(torch.bfloat16)
    if device.type != "cuda":
        return tuple(host), None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = tuple(t.pin_memory().to(device, non_blocking=True)
                    for t in host)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _ready(device: torch.device, staged):
    """The consumer's half: order the compute stream after the copy."""
    tensors, event = staged
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in tensors:
            t.record_stream(current)
    return tensors


class Prefetcher:
    """Eagerly started device prefetch: the producer thread starts in
    ``__init__``, so building one for epoch N+1 at the end of epoch N
    overlaps the next epoch's generation and staging with the current
    epoch's metric drain, eval and checkpoint.

    Yields ``(images, labels)``, or ``(images, labels, mask)`` with
    ``with_mask``. ``close()`` must be called when the iterator is not
    run to exhaustion; it is idempotent and closes the source iterator.
    """

    def __init__(self, device: torch.device, batch_iter,
                 with_mask: bool = False, depth: int = 2,
                 stats: PrefetchStats | None = None):
        self.stats = stats if stats is not None else PrefetchStats()
        self._device = device
        self._batch_iter = batch_iter
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._end = object()
        self._done = False
        self._closed = False
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)

        def _put(item) -> bool:
            # Bounded put that gives up when the consumer is gone — a
            # plain q.put would block forever on the full queue.
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def runner():
            try:
                for batch in batch_iter:
                    if not _put(_stage_batch(device, batch, with_mask,
                                             self.stats, stream)):
                        return
                _put(self._end)
            except BaseException as e:  # propagate to the consumer
                _put(e)

        self._thread = threading.Thread(target=runner,
                                        name="device-prefetch", daemon=True)
        self._thread.start()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        waited = time.perf_counter() - t0
        self.stats.wait_s += waited
        self.stats.max_wait_s = max(self.stats.max_wait_s, waited)
        if item is self._end:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return _ready(self._device, item)

    def close(self) -> None:
        """Release the producer thread and the staged batches it holds,
        then close the source iterator."""
        if self._closed:
            return
        self._closed = True
        self._done = True
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        close = getattr(self._batch_iter, "close", None)
        if close is not None:
            close()

    def __del__(self):  # backstop only; call close() explicitly
        try:
            self.close()
        except Exception:
            pass

