"""Dependency-free TensorBoard scalar event writer: a copy of
``fdtpu/utils/tb.py``, which is framework-free, so the port writes the same
event files without importing fdtpu.

The reference streams per-epoch metrics to TensorBoard through Lightning's
``self.log`` (the reference's ``models/ModelMeta.py:226,258-287``;
tensorboard pinned in ``requirements.txt:55``). The tensorboard package is
not in this image, but the on-disk format is simple: a TFRecord stream of
``Event`` protobufs. Both are hand-encoded here (~100 lines) so runs produce
real ``events.out.tfevents.*`` files that TensorBoard can open anywhere.

Wire format:
  record  = uint64 len | uint32 masked_crc32c(len) | data | masked_crc32c(data)
  Event   = 1: double wall_time | 2: int64 step | 3: string file_version
            | 5: Summary summary
  Summary = 1: repeated Value;  Value = 1: string tag | 2: float simple_value
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

# -- crc32c (Castagnoli), table-driven ----------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding --------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    msg = bytearray()
    msg += _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        msg += _varint(2 << 3 | 0) + _varint(step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            val = _field_bytes(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack(
                "<f", float(value)
            )
            summary += _field_bytes(1, val)
        msg += _field_bytes(5, bytes(summary))
    return bytes(msg)


class EventWriter:
    """Append-only ``events.out.tfevents`` scalar writer (one per run dir)."""

    def __init__(self, log_dir: str | Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "host"
        self.path = log_dir / f"events.out.tfevents.{int(time.time())}.{host}"
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        with self.path.open("ab") as f:
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(record)
            f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalars(self, step: int, scalars: dict, prefix: str = "") -> None:
        tagged = {f"{prefix}{k}": v for k, v in scalars.items()}
        self._write(_event(time.time(), step=step, scalars=tagged))


def read_scalars(path: str | Path) -> list[tuple[int, dict]]:
    """Decode an event file back to ``[(step, {tag: value})]`` — the test
    oracle (also handy to dump runs without tensorboard installed).
    Verifies record CRCs."""
    out = []
    data = Path(path).read_bytes()
    pos = 0
    while pos < len(data):
        (ln,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(header), "corrupt header crc"
        rec = data[pos + 12 : pos + 12 + ln]
        (rcrc,) = struct.unpack_from("<I", data, pos + 12 + ln)
        assert rcrc == _masked_crc(rec), "corrupt record crc"
        pos += 12 + ln + 4

        # decode Event
        step, scalars = 0, {}
        i = 0
        while i < len(rec):
            key = rec[i]
            i += 1
            num, wire = key >> 3, key & 7
            if wire == 0:  # varint
                val = 0
                shift = 0
                while True:
                    b = rec[i]
                    i += 1
                    val |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if num == 2:
                    step = val
            elif wire == 1:  # 64-bit
                i += 8
            elif wire == 5:  # 32-bit
                i += 4
            elif wire == 2:  # length-delimited
                ln2 = 0
                shift = 0
                while True:
                    b = rec[i]
                    i += 1
                    ln2 |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                payload = rec[i : i + ln2]
                i += ln2
                if num == 5:  # Summary
                    j = 0
                    while j < len(payload):
                        assert payload[j] == 0x0A
                        j += 1
                        vlen = 0
                        shift = 0
                        while True:
                            b = payload[j]
                            j += 1
                            vlen |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        value_msg = payload[j : j + vlen]
                        j += vlen
                        tag, simple = None, None
                        k = 0
                        while k < len(value_msg):
                            vkey = value_msg[k]
                            k += 1
                            if vkey == 0x0A:
                                tlen = value_msg[k]
                                k += 1
                                tag = value_msg[k : k + tlen].decode()
                                k += tlen
                            elif vkey == 0x15:
                                (simple,) = struct.unpack_from("<f", value_msg, k)
                                k += 4
                            else:  # unknown field: bail out of this Value
                                break
                        if tag is not None and simple is not None:
                            scalars[tag] = simple
        if scalars:
            out.append((step, scalars))
    return out
