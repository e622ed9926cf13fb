"""Native TensorBoard event writer — scalars and images, no tensorflow.

Parity target: the reference logger's tensorboardX SummaryWriter usage
(src/lib/logger.py:36-42, `scalar_summary`) plus the train-time debug images
(`trains/object_pose.py:218-401` routed to opt.debug_dir). The image has no
tensorflow/tensorboardX, so this encodes the `tensorflow.Event` protobuf
wire format directly (varint/fixed64/length-delimited — the only three wire
types the Event/Summary messages use) and frames records with the project's
own TFRecord writer (data/tfrecord.py: length + masked CRC32C).

Verified readable by TensorBoard's event_file_loader (same framing + protos).

Field numbers (tensorflow/core/util/event.proto, summary.proto):
  Event:    wall_time=1 (double), step=2 (int64), file_version=3 (string),
            summary=5 (message)
  Summary:  value=1 (repeated message)
  Summary.Value: tag=1 (string), simple_value=2 (float), image=4 (message)
  Summary.Image: height=1, width=2, colorspace=3 (3=RGB), encoded=4 (bytes)

The PyTorch package's own copy of `centerpose_tpu/utils/tbevents.py`.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from centerpose_tpu_torch.data.tfrecord import _masked_crc


# ---------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(step: int, summary: Optional[bytes] = None,
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    out = _f_double(1, time.time() if wall_time is None else wall_time)
    out += _f_varint(2, step)
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(value)))


def _image_value(tag: str, png: bytes, h: int, w: int) -> bytes:
    img = (
        _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, 3)  # colorspace RGB
        + _f_bytes(4, png)
    )
    return _f_bytes(1, _f_bytes(1, tag.encode()) + _f_bytes(4, img))


# ---------------------------------------------------------------- writer
class TBEventWriter:
    """Append-only events.out.tfevents.* writer (scalars + PNG images)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(step, _scalar_value(tag, value)))
        self._f.flush()

    def image(self, tag: str, rgb: np.ndarray, step: int) -> None:
        """rgb: [H, W, 3] uint8."""
        from PIL import Image

        rgb = np.ascontiguousarray(np.asarray(rgb, np.uint8))
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        self._record(
            _event(step, _image_value(tag, buf.getvalue(), rgb.shape[0],
                                      rgb.shape[1]))
        )
        self._f.flush()

    def close(self) -> None:
        self._f.close()
