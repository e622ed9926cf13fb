"""Video frame sources for the demo (`centerpose_tpu_torch/demo.py`).

The package's own copy of the readers of `centerpose_tpu/data/video.py`
(numpy + PIL). Parity target: the reference decodes videos with an ffmpeg
rawvideo pipe (data/preprocess.py:32-81) and cv2.VideoCapture in demo.py.
This module provides:
  * `FrameDirReader` — a directory of ordered image frames (always available);
  * `MJPEGAVIReader` / `Y4MReader` — pure-python container parsers (RIFF/AVI
    with JPEG frames via PIL, and YUV4MPEG2 raw streams) so a video runs with
    no external binary at all;
  * `FFmpegReader` — everything else (mp4/webm) via an ffmpeg subprocess pipe,
    gated on the binary being present (it raises a clear error without it);
  * `open_video` — picks the reader for a path.
The JAX package's `write_mjpeg_avi` (the demo's video output) is not copied:
the demo here writes JSON only.
"""

from __future__ import annotations

import glob
import io
import os
import shutil
import struct
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np


class FrameDirReader:
    def __init__(self, path: str):
        exts = ("*.png", "*.jpg", "*.jpeg")
        self.files = sorted(
            sum([glob.glob(os.path.join(path, e)) for e in exts], [])
        )
        if not self.files:
            raise FileNotFoundError(f"no image frames under {path}")

    def __iter__(self) -> Iterator[np.ndarray]:
        from PIL import Image

        for f in self.files:
            yield np.asarray(Image.open(f).convert("RGB"))

    def __len__(self):
        return len(self.files)


class FFmpegReader:
    """Stream RGB24 frames from a video file through ffmpeg."""

    def __init__(self, path: str, fps: Optional[float] = None):
        if shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None:
            raise RuntimeError(
                "ffmpeg/ffprobe not available in this environment; use a frame "
                "directory (FrameDirReader) instead"
            )
        self.path = path
        self.fps = fps
        self.size = self._probe_size()

    def _probe_size(self) -> Tuple[int, int]:
        out = subprocess.check_output(
            [
                "ffprobe", "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=width,height", "-of", "csv=p=0",
                self.path,
            ]
        )
        w, h = (int(v) for v in out.decode().strip().split(","))
        return w, h

    def __iter__(self) -> Iterator[np.ndarray]:
        w, h = self.size
        cmd = ["ffmpeg", "-v", "error", "-i", self.path]
        if self.fps:
            cmd += ["-vf", f"fps={self.fps}"]
        cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        frame_bytes = w * h * 3
        try:
            while True:
                buf = proc.stdout.read(frame_bytes)
                if len(buf) < frame_bytes:
                    return
                yield np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        finally:
            proc.stdout.close()
            proc.wait()


class MJPEGAVIReader:
    """Pure-python RIFF/AVI parser for Motion-JPEG streams (PIL decodes frames).

    Covers the cv2.VideoCapture surface the reference demo uses
    (src/demo.py:33) for the one codec decodable without ffmpeg. Walks the chunk tree; frames are the `??dc`/`??db`
    chunks of the first video stream, in file order.
    """

    def __init__(self, path: str):
        import mmap

        self.path = path
        # Memory-MAP rather than slurp: a multi-GB AVI stays pageable instead
        # of pinned resident for the reader's lifetime.
        self._file = open(path, "rb")
        try:
            self._data = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )
        except ValueError:
            self._file.close()
            raise ValueError(f"{path}: not a RIFF/AVI file (empty)")
        data = self._data
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            self.close()
            raise ValueError(f"{path}: not a RIFF/AVI file")
        self.fps = None
        self._frames: List[Tuple[int, int]] = []  # (offset, size) into data
        self._walk(12, len(data))
        if not self._frames:
            self.close()
            raise ValueError(f"{path}: no video frame chunks found")

    def close(self) -> None:
        if getattr(self, "_data", None) is not None and not isinstance(
            self._data, bytes
        ):
            self._data.close()
        if getattr(self, "_file", None) is not None:
            self._file.close()

    def __del__(self):  # best-effort; close() is the explicit API
        try:
            self.close()
        except Exception:
            pass

    def _walk(self, pos: int, end: int) -> None:
        data = self._data
        while pos + 8 <= end:
            fourcc = data[pos : pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
            body = pos + 8
            if fourcc in (b"LIST", b"RIFF"):
                self._walk(body + 4, min(body + size, end))
            elif fourcc == b"avih" and size >= 4:
                (usec,) = struct.unpack("<I", data[body : body + 4])
                if usec:
                    self.fps = 1e6 / usec
            elif fourcc[:2] == b"00" and fourcc[2:4] in (b"dc", b"db") and size:
                self._frames.append((body, size))
            pos = body + size + (size & 1)

    def __len__(self):
        return len(self._frames)

    def __iter__(self) -> Iterator[np.ndarray]:
        from PIL import Image

        for off, size in self._frames:
            buf = self._data[off : off + size]
            img = Image.open(io.BytesIO(buf)).convert("RGB")
            yield np.asarray(img)


class Y4MReader:
    """YUV4MPEG2 raw-stream reader (the other ffmpeg-free container)."""

    _XSHIFT = {"420": 1, "422": 1, "444": 0, "mono": 0}
    _YSHIFT = {"420": 1, "422": 0, "444": 0, "mono": 0}

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header = f.readline()
        if not header.startswith(b"YUV4MPEG2"):
            raise ValueError(f"{path}: not a YUV4MPEG2 stream")
        self._hdr_len = len(header)
        self.width = self.height = 0
        self.fps = None
        self.subsampling = "420"
        for tok in header.decode("ascii", "replace").split()[1:]:
            key, val = tok[0], tok[1:]
            if key == "W":
                self.width = int(val)
            elif key == "H":
                self.height = int(val)
            elif key == "F":
                num, den = val.split(":")
                self.fps = float(num) / float(den)
            elif key == "C":
                base = "mono" if val.startswith("mono") else val[:3]
                if base not in self._XSHIFT:
                    raise ValueError(f"unsupported y4m chroma mode C{val}")
                self.subsampling = base
        if not (self.width and self.height):
            raise ValueError(f"{path}: missing W/H in y4m header")

    def __iter__(self) -> Iterator[np.ndarray]:
        w, h = self.width, self.height
        cw = w >> self._XSHIFT[self.subsampling]
        ch = h >> self._YSHIFT[self.subsampling]
        ysize, csize = w * h, cw * ch
        mono = self.subsampling == "mono"
        with open(self.path, "rb") as f:
            f.seek(self._hdr_len)
            while True:
                line = f.readline()
                if not line:
                    return
                if not line.startswith(b"FRAME"):
                    raise ValueError("corrupt y4m frame marker")
                y = f.read(ysize)
                if len(y) < ysize:
                    return
                yp = np.frombuffer(y, np.uint8).reshape(h, w).astype(np.float32)
                if mono:
                    rgb = np.repeat(yp[..., None], 3, axis=-1)
                    yield np.clip(rgb, 0, 255).astype(np.uint8)
                    continue
                u = np.frombuffer(f.read(csize), np.uint8).reshape(ch, cw)
                v = np.frombuffer(f.read(csize), np.uint8).reshape(ch, cw)
                up = u.repeat(h // ch, 0).repeat(w // cw, 1).astype(np.float32)
                vp = v.repeat(h // ch, 0).repeat(w // cw, 1).astype(np.float32)
                # BT.601 limited range (ffmpeg's default yuv420p semantics).
                yc, uc, vc = 1.164 * (yp - 16.0), up - 128.0, vp - 128.0
                rgb = np.stack(
                    [
                        yc + 1.596 * vc,
                        yc - 0.392 * uc - 0.813 * vc,
                        yc + 2.017 * uc,
                    ],
                    axis=-1,
                )
                yield np.clip(rgb, 0, 255).astype(np.uint8)


def open_video(path: str, fps: Optional[float] = None):
    if os.path.isdir(path):
        return FrameDirReader(path)
    with open(path, "rb") as f:
        magic = f.read(12)
    if magic[:4] == b"RIFF" and magic[8:12] == b"AVI ":
        return MJPEGAVIReader(path)
    if magic.startswith(b"YUV4MPEG2"):
        return Y4MReader(path)
    return FFmpegReader(path, fps)
