"""TensorBoard scalar event files, written with the standard library.

Counterpart of the writer half of the JAX package's
``utils/tb_events.py``: TFRecord framing (length, masked CRC32C) around
hand-encoded ``tensorflow.Event`` protos carrying ``Summary.Value{tag,
simple_value}``, the one record kind the trainers write.  TensorBoard
reads the files; so does the JAX package's ``read_records`` /
``decode_scalar_event``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", value)


def scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """Event{wall_time, step, summary{value{tag, simple_value}}}."""
    val = (_len_delimited(1, tag.encode("utf-8"))
           + _varint((2 << 3) | 5) + struct.pack("<f", float(value)))
    return (_double(1, wall_time)
            + _varint(2 << 3) + _varint(int(step) & 0xFFFFFFFFFFFFFFFF)
            + _len_delimited(5, _len_delimited(1, val)))


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Append-only scalar event file in ``log_dir``, opened with the
    conventional first record ``Event{file_version: "brain.Event:2"}``."""

    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / (f"events.out.tfevents.{int(time.time())}."
                               f"{socket.gethostname()}.{os.getpid()}.0")
        self._file = open(self.path, "ab")
        self._file.write(_record(_double(1, time.time())
                                 + _len_delimited(3, b"brain.Event:2")))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float = None) -> None:
        wt = time.time() if wall_time is None else wall_time
        self._file.write(_record(scalar_event(tag, value, step, wt)))
        self._file.flush()

    def close(self) -> None:
        self._file.close()
