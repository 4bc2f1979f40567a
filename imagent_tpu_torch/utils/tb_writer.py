"""Pure-Python TensorBoard event writer — no torch/tensorboard required.

The reference logs through ``torch.utils.tensorboard.SummaryWriter``
(``imagenet.py:362``). This module needs no tensorboard package: it
writes the TFRecord-framed ``tensorflow.Event`` protobuf stream
directly, covering exactly what the framework emits (scalar
summaries), readable by any TensorBoard.

Format (tensorflow/core/lib/io/record_writer.cc):
    uint64 length | uint32 masked_crc32c(length) | payload
                  | uint32 masked_crc32c(payload)
with CRC32C (Castagnoli) and the TF mask ((c>>15 | c<<17) + 0xa282ead8).
Event proto fields used: wall_time(1, double), step(2, varint),
file_version(3, string), summary(5) -> Summary.Value{tag(1),
simple_value(2, float)}.

The scalar half of ``imagent_tpu/utils/tb_writer.py``, copied for the
PyTorch port (the histogram writer joins with the telemetry port).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---- CRC32C (Castagnoli, table-driven) ------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf encoding --------------------------------------------


def _varint(n: int) -> bytes:
    # Negative ints encode as 64-bit two's complement (proto int64
    # semantics); without the mask the >>7 loop below never terminates.
    if n < 0:
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _scalar_summary(tag: str, value: float) -> bytes:
    v = (_field_bytes(1, tag.encode()) +
         bytes([0x15]) + struct.pack("<f", value))  # simple_value
    return _field_bytes(1, v)  # Summary.value


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    out = bytes([0x09]) + struct.pack("<d", wall_time)
    if step is not None:
        out += bytes([0x10]) + _varint(step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


# ---- writers ---------------------------------------------------------------


_writer_seq = 0  # per-process uniqueness: same-second, same-pid writers
                 # (e.g. a resume run reusing log_dir) must not truncate


class EventWriter:
    """One events.out.tfevents.* file in ``log_dir``."""

    def __init__(self, log_dir: str):
        global _writer_seq
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.{_writer_seq}")
        _writer_seq += 1
        self._f = open(os.path.join(log_dir, name), "xb")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=step,
                            summary=_scalar_summary(tag, float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class SummaryWriter:
    """The ``torch.utils.tensorboard.SummaryWriter`` subset the
    framework uses: ``add_scalar`` (one run) and ``add_scalars``
    (torch-compatible ``<logdir>/<tag>_<series>`` sub-runs so
    train/test land on one chart)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._main = EventWriter(log_dir)
        self._subs: dict[str, EventWriter] = {}

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._main.scalar(tag, value, step)

    def add_scalars(self, main_tag: str, series: dict, step: int) -> None:
        for name, value in series.items():
            key = f"{main_tag}_{name}"
            if key not in self._subs:
                self._subs[key] = EventWriter(
                    os.path.join(self.log_dir, key))
            self._subs[key].scalar(main_tag, value, step)

    def flush(self) -> None:
        self._main.flush()
        for w in self._subs.values():
            w.flush()

    def close(self) -> None:
        self._main.close()
        for w in self._subs.values():
            w.close()
