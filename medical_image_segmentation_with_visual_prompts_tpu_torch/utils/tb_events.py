"""TensorBoard scalar event files, written and read with the standard
library.

Counterpart of the JAX package's ``utils/tb_events.py``: TFRecord framing
(length, masked CRC32C) around hand-encoded ``tensorflow.Event`` protos
carrying ``Summary.Value{tag, simple_value}``, the one record kind the
trainers write; :func:`read_records` and :func:`decode_scalar_event` read
them back (and the JAX package's files), and :func:`convert_jsonl` turns
a summary directory's ``scalars.jsonl`` into an event file.  As a
command, each summary directory given is converted::

    python -m medical_image_segmentation_with_visual_prompts_tpu_torch.utils.tb_events \
        logs/<run_name>/summary
"""

from __future__ import annotations

import json
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


def file_version_event(wall_time: float) -> bytes:
    """The conventional first record: Event{file_version: "brain.Event:2"}."""
    return _double(1, wall_time) + _len_delimited(3, b"brain.Event:2")


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


def read_records(path) -> list:
    """The payloads of a TFRecord file, each CRC checked."""
    data = Path(path).read_bytes()
    out, off = [], 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if hcrc != _masked_crc(data[off:off + 8]):
            raise ValueError(f"header CRC mismatch at offset {off}")
        payload = data[off + 12:off + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + length)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"payload CRC mismatch at offset {off}")
        out.append(payload)
        off += 16 + length
    return out


def _read_varint(buf: bytes, off: int):
    n, shift = 0, 0
    while True:
        b = buf[off]
        n |= (b & 0x7F) << shift
        off += 1
        if not b & 0x80:
            return n, off
        shift += 7


def _fields(buf: bytes):
    """(field, wire type, value) of each field of a proto message: ints
    for varints, bytes for the fixed and length-delimited ones."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, off = _read_varint(buf, off)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, off = buf[off:off + size], off + size
        elif wire == 2:
            size, off = _read_varint(buf, off)
            value, off = buf[off:off + size], off + size
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
        yield field, wire, value


def decode_scalar_event(payload: bytes):
    """An Event payload as ``(tag, value, step, wall_time)``, or None for
    an event without a scalar (the file-version record)."""
    wall_time, step, tag, value = 0.0, 0, None, None
    for field, wire, v in _fields(payload):
        if field == 1 and wire == 1:
            (wall_time,) = struct.unpack("<d", v)
        elif field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:                   # summary
            for sfield, swire, sv in _fields(v):
                if sfield != 1 or swire != 2:            # Summary.Value
                    continue
                for vfield, vwire, vv in _fields(sv):
                    if vfield == 1 and vwire == 2:
                        tag = vv.decode()
                    elif vfield == 2 and vwire == 5:
                        (value,) = struct.unpack("<f", vv)
    if tag is None:
        return None
    return tag, value, step, wall_time


class EventWriter:
    """Append-only scalar event file in ``log_dir``, opened with the
    conventional first record ``Event{file_version: "brain.Event:2"}``."""

    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / (f"events.out.tfevents.{int(time.time())}."
                               f"{socket.gethostname()}.{os.getpid()}.0")
        self._file = open(self.path, "ab")
        self._file.write(_record(file_version_event(time.time())))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float = None) -> None:
        wt = time.time() if wall_time is None else wall_time
        self._file.write(_record(scalar_event(tag, value, step, wt)))
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def convert_jsonl(summary_dir) -> Path:
    """Write ``summary_dir/scalars.jsonl`` as a TensorBoard event file in
    the same directory; returns the event file's path."""
    summary_dir = Path(summary_dir)
    src = summary_dir / "scalars.jsonl"
    if not src.exists():
        raise FileNotFoundError(src)
    writer = EventWriter(summary_dir)
    with open(src) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                writer.add_scalar(rec["tag"], rec["value"], rec["step"],
                                  rec.get("wall_time"))
    writer.close()
    return writer.path


if __name__ == "__main__":
    import sys
    for d in sys.argv[1:]:
        print(convert_jsonl(d))
