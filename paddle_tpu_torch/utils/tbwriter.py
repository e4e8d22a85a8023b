"""Minimal TensorBoard event-file writer (no tensorboard/visualdl deps;
a copy of ``paddle_tpu/utils/tbwriter.py``).

Reference parity: VisualDL's LogWriter. Metrics write standard
TFRecord/tf.Event files that TensorBoard (and VisualDL's TB-import) read
directly; the protobuf wire encoding for the tiny Event/Summary subset we
need (scalars + text) is hand-rolled below, so the writer has zero
dependencies.

Wire format notes:
- protobuf: varint keys (field_number << 3 | wire_type); doubles are
  64-bit (wire type 1), floats 32-bit (5), strings/submessages
  length-delimited (2), ints varint (0).
- TFRecord framing: len(u64 LE) + masked_crc32c(len) + payload +
  masked_crc32c(payload), with the "masked" rotation TensorFlow uses.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Optional

__all__ = ["LogWriter", "SummaryWriter"]


# ----------------------------------------------------------- crc32c ------
def _make_crc_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------ proto encoding ---
def _varint(n: int) -> bytes:
    # protobuf encodes negative int64 as two's-complement 64-bit varint;
    # without the mask python's arithmetic shift would loop forever
    if n < 0:
        n &= (1 << 64) - 1
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _str_field(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    return _str_field(1, tag.encode()) + _float_field(2, float(value))


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary_values: Optional[list] = None) -> bytes:
    # Event{ wall_time=1(double), step=2(int64), file_version=3(string),
    #        summary=5(Summary{ repeated value=1 }) }
    msg = _double_field(1, wall_time)
    if step is not None:
        msg += _int_field(2, int(step))
    if file_version is not None:
        msg += _str_field(3, file_version.encode())
    if summary_values:
        summary = b"".join(_str_field(1, v) for v in summary_values)
        msg += _str_field(5, summary)
    return msg


# -------------------------------------------------------------- writer ---
class LogWriter:
    """VisualDL-shaped scalar logger emitting TensorBoard event files.

    with LogWriter(logdir="./log") as w:
        w.add_scalar(tag="train/loss", value=loss, step=i)
    """

    def __init__(self, logdir: str = "./log", file_name: str = "",
                 display_name: str = "", **kwargs):
        os.makedirs(logdir, exist_ok=True)
        name = file_name or (
            f"events.out.tfevents.{int(time.time())}.paddle_tpu")
        self._path = os.path.join(logdir, name)
        self._f = open(self._path, "ab")
        self._write_record(_event(time.time(),
                                  file_version="brain.Event:2"))

    @property
    def logdir(self):
        return os.path.dirname(self._path)

    def _write_record(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int = 0, walltime=None):
        self._write_record(_event(
            walltime if walltime is not None else time.time(), step,
            summary_values=[_summary_value(tag, float(value))]))

    def add_scalars(self, main_tag: str, tag_value_dict, step: int = 0):
        for k, v in tag_value_dict.items():
            self.add_scalar(f"{main_tag}/{k}", v, step)

    def add_text(self, tag: str, text_string: str, step: int = 0):
        # encoded as a scalar-less Value{tag, metadata-free tensor} is
        # complex; TB renders text via tensor summaries — log as a tagged
        # scalar event count plus keep the text in a sidecar file
        side = self._path + ".text"
        with open(side, "a") as f:
            f.write(f"{step}\t{tag}\t{text_string}\n")

    def flush(self):
        self._f.flush()

    def close(self):
        try:
            self._f.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# torch.utils.tensorboard-shaped alias
SummaryWriter = LogWriter
