"""TensorBoard event files, written and read with no package beyond the
standard library.

An event file (``events.out.tfevents.<time>.<host>.<pid>.<n>``) is a run of
TFRecords: each is the data's length as a little-endian u64, the masked
CRC32C of those 8 bytes, the data, and the masked CRC32C of the data. The
data is one ``Event`` protobuf, encoded here by hand with the field numbers
of tensorboard's ``event.proto`` and ``summary.proto``:

* ``Event``: ``wall_time`` 1 (double), ``step`` 2 (varint), ``file_version``
  3 (string, ``"brain.Event:2"`` in the first record), ``summary`` 5;
* ``Summary``: ``value`` 1 (repeated);
* ``Summary.Value``: ``tag`` 1, ``simple_value`` 2 (float), ``image`` 4,
  ``audio`` 6;
* ``Summary.Audio``: ``sample_rate`` 1 (float), ``num_channels`` 2,
  ``length_frames`` 3, ``encoded_audio_string`` 4, ``content_type`` 5;
* ``Summary.Image``: ``height`` 1, ``width`` 2, ``colorspace`` 3,
  ``encoded_image_string`` 4.

The card's machine has neither tensorboardX nor tensorboard, so the port
writes its logs, and ``scripts.gan_longrun report`` reads them, through
this module; TensorBoard and tensorboardX read and write the same files.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

MASK_DELTA = 0xA282EAD8
FILE_VERSION = b"brain.Event:2"


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1  # Castagnoli, reflected
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + MASK_DELTA) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord around ``data``."""
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", masked_crc32c(length)) + data + struct.pack("<I", masked_crc32c(data))


# -- protobuf encoding ----------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # a negative int64 is its two's complement
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _double_field(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", x)


def _float_field(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", x)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def scalar_value(tag: str, value: float) -> bytes:
    """A ``Summary.Value`` holding ``simple_value``."""
    return _bytes_field(1, tag.encode()) + _float_field(2, value)


def audio_value(tag: str, encoded: bytes, sample_rate: float, num_channels: int, length_frames: int,
                content_type: str = "audio/wav") -> bytes:
    audio = (_float_field(1, sample_rate) + _int_field(2, num_channels) + _int_field(3, length_frames)
             + _bytes_field(4, encoded) + _bytes_field(5, content_type.encode()))
    return _bytes_field(1, tag.encode()) + _bytes_field(6, audio)


def image_value(tag: str, encoded: bytes, height: int, width: int, colorspace: int) -> bytes:
    image = _int_field(1, height) + _int_field(2, width) + _int_field(3, colorspace) + _bytes_field(4, encoded)
    return _bytes_field(1, tag.encode()) + _bytes_field(4, image)


def event(wall_time: float, step: int = 0, values=(), file_version: Optional[bytes] = None) -> bytes:
    """An ``Event``: the file-version header when ``file_version`` is given,
    else a ``Summary`` of ``values`` (encoded ``Summary.Value`` messages)."""
    out = _double_field(1, wall_time)
    if step:
        out += _int_field(2, step)
    if file_version is not None:
        return out + _bytes_field(3, file_version)
    return out + _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))


# -- protobuf decoding ----------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        n |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return n, pos
        shift += 7


def fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a message: an int
    for a varint, the raw bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos : pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield field, wire, value


def _signed(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def parse_value(buf: bytes) -> dict:
    """A ``Summary.Value`` as a dict: ``tag`` and one of ``simple_value``,
    ``audio`` or ``image`` (dicts of their fields); other kinds give the tag alone."""
    out: dict = {}
    for field, wire, value in fields(buf):
        if field == 1 and wire == 2:
            out["tag"] = value.decode()
        elif field == 2 and wire == 5:
            out["simple_value"] = struct.unpack("<f", value)[0]
        elif field == 6 and wire == 2:
            names = {1: "sample_rate", 2: "num_channels", 3: "length_frames", 4: "encoded_audio_string", 5: "content_type"}
            audio = {}
            for f, w, v in fields(value):
                if f in names:
                    audio[names[f]] = struct.unpack("<f", v)[0] if f == 1 else v.decode() if f == 5 else v
            out["audio"] = audio
        elif field == 4 and wire == 2:
            names = {1: "height", 2: "width", 3: "colorspace", 4: "encoded_image_string"}
            out["image"] = {names[f]: v for f, w, v in fields(value) if f in names}
    return out


def parse_event(buf: bytes) -> dict:
    """An ``Event`` as a dict: ``wall_time``, ``step``, and ``file_version``
    or ``values`` (``parse_value`` of each summary value)."""
    out: dict = {"wall_time": 0.0, "step": 0}
    for field, wire, value in fields(buf):
        if field == 1 and wire == 1:
            out["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2 and wire == 0:
            out["step"] = _signed(value)
        elif field == 3 and wire == 2:
            out["file_version"] = value.decode()
        elif field == 5 and wire == 2:
            out["values"] = [parse_value(v) for f, w, v in fields(value) if f == 1 and w == 2]
    return out


# -- files ----------------------------------------------------------------------


class CorruptRecordError(ValueError):
    """A record whose CRC does not match its bytes."""


def records(path) -> Iterator[bytes]:
    """The data of each record of an event file. A CRC mismatch raises
    ``CorruptRecordError``; a truncated final record (a writer still
    writing, or killed) ends the file quietly, as TensorBoard reads it."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            length = header[:8]
            if struct.unpack("<I", header[8:])[0] != masked_crc32c(length):
                raise CorruptRecordError(f"{path}: the length CRC of a record does not match")
            (n,) = struct.unpack("<Q", length)
            data = f.read(n)
            footer = f.read(4)
            if len(data) < n or len(footer) < 4:
                return
            if struct.unpack("<I", footer)[0] != masked_crc32c(data):
                raise CorruptRecordError(f"{path}: the data CRC of a record does not match")
            yield data


def event_files(log_dir) -> List[Path]:
    """A log directory's event files in name order, which is their time order."""
    return sorted(p for p in Path(log_dir).iterdir() if p.is_file() and "tfevents" in p.name)


def read_events(log_dir) -> Iterator[dict]:
    """``parse_event`` of every record of every event file of ``log_dir``."""
    for path in event_files(log_dir):
        for data in records(path):
            yield parse_event(data)


def read_scalars(log_dir) -> Dict[str, List[Tuple[int, float, float]]]:
    """``{tag: [(step, value, wall_time), ...]}`` of every scalar summary in
    ``log_dir``, tags in their first appearance's order, each tag's events
    in file order."""
    out: Dict[str, List[Tuple[int, float, float]]] = {}
    for ev in read_events(log_dir):
        for value in ev.get("values", ()):
            if "simple_value" in value:
                out.setdefault(value["tag"], []).append((ev["step"], value["simple_value"], ev["wall_time"]))
    return out


_file_counter = itertools.count()


class EventWriter:
    """Appends events to a new event file in ``log_dir``; every event is
    flushed to the file as it is written, so a reader (or a run killed
    mid-training) loses at most the record being written."""

    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}.{os.getpid()}.{next(_file_counter)}"
        self.path = log_dir / name
        self._file = open(self.path, "wb")
        self._write(event(now, file_version=FILE_VERSION))

    def _write(self, data: bytes) -> None:
        self._file.write(frame_record(data))
        self._file.flush()

    def add(self, values, step: int, wall_time: Optional[float] = None) -> None:
        """One event of the encoded ``Summary.Value`` messages ``values``."""
        self._write(event(time.time() if wall_time is None else wall_time, step, values))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()
