"""V4L2 webcam capture, cv2-free (pure python: ioctl + mmap).

Parity target: the reference demo's webcam mode (`src/demo.py:31-57`,
`cv2.VideoCapture(0)` + frame loop). The image has no cv2, so this speaks
V4L2 directly: negotiate a YUYV format, mmap kernel buffers, stream, and
convert YUYV → RGB in vectorized numpy (BT.601).

Hardware-gated like the ffmpeg-gated video decode (data/video.py): creating a
`V4L2Camera` raises `WebcamUnavailable` when the device node is absent, which
demo.py turns into a clear message. The YUYV conversion and the struct
layouts are unit-tested; the ioctl path needs a real /dev/video* node.

Struct layouts follow linux/videodev2.h for 64-bit (verified against the
kernel headers' field order; sizes asserted in the tests).

The PyTorch package's own copy of `centerpose_tpu/data/webcam.py`. Capture is
host work (numpy), the same in both packages; the frames then go to the
`Detector` on its device.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap
import os
import select

import numpy as np


class WebcamUnavailable(RuntimeError):
    pass


# ---------------------------------------------------------------- ioctl nums
def _ioc(direction: int, nr: int, size: int) -> int:
    # linux _IOC: dir(2) | size(14) | type(8) | nr(8); type 'V' = 0x56.
    return (direction << 30) | (size << 16) | (0x56 << 8) | nr


_IOC_W, _IOC_R, _IOC_RW = 1, 2, 3

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_PIX_FMT_YUYV = 0x56595559  # 'YUYV' little-endian fourcc


class v4l2_capability(ctypes.Structure):
    _fields_ = [
        ("driver", ctypes.c_char * 16),
        ("card", ctypes.c_char * 32),
        ("bus_info", ctypes.c_char * 32),
        ("version", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("device_caps", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 3),
    ]


class v4l2_pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32),
        ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32),
        ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("ycbcr_enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32),
        ("xfer_func", ctypes.c_uint32),
    ]


class v4l2_format(ctypes.Structure):
    class _fmt(ctypes.Union):
        # raw_data as u64 gives the union the kernel's 8-byte alignment
        # (it holds pointer-bearing structs like v4l2_window there), which
        # inserts the 4-byte pad after `type` — sizeof must be 208.
        _fields_ = [
            ("pix", v4l2_pix_format),
            ("raw_data", ctypes.c_uint64 * 25),
        ]

    _fields_ = [("type", ctypes.c_uint32), ("fmt", _fmt)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("flags", ctypes.c_uint8),
        ("reserved", ctypes.c_uint8 * 3),
    ]


class v4l2_timecode(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class v4l2_buffer(ctypes.Structure):
    class _m(ctypes.Union):
        _fields_ = [
            ("offset", ctypes.c_uint32),
            ("userptr", ctypes.c_ulong),
            ("planes", ctypes.c_void_p),
            ("fd", ctypes.c_int32),
        ]

    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("timestamp", ctypes.c_long * 2),   # struct timeval
        ("timecode", v4l2_timecode),
        ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("m", _m),
        ("length", ctypes.c_uint32),
        ("reserved2", ctypes.c_uint32),
        ("request_fd", ctypes.c_int32),
    ]


VIDIOC_QUERYCAP = _ioc(_IOC_R, 0, ctypes.sizeof(v4l2_capability))
VIDIOC_S_FMT = _ioc(_IOC_RW, 5, ctypes.sizeof(v4l2_format))
VIDIOC_REQBUFS = _ioc(_IOC_RW, 8, ctypes.sizeof(v4l2_requestbuffers))
VIDIOC_QUERYBUF = _ioc(_IOC_RW, 9, ctypes.sizeof(v4l2_buffer))
VIDIOC_QBUF = _ioc(_IOC_RW, 15, ctypes.sizeof(v4l2_buffer))
VIDIOC_DQBUF = _ioc(_IOC_RW, 17, ctypes.sizeof(v4l2_buffer))
VIDIOC_STREAMON = _ioc(_IOC_W, 18, ctypes.sizeof(ctypes.c_int))
VIDIOC_STREAMOFF = _ioc(_IOC_W, 19, ctypes.sizeof(ctypes.c_int))


def yuyv_to_rgb(frame: bytes, width: int, height: int) -> np.ndarray:
    """YUYV 4:2:2 → RGB uint8 [H, W, 3], BT.601 full-swing (cv2-compatible)."""
    data = np.frombuffer(frame, np.uint8, count=width * height * 2)
    yuyv = data.reshape(height, width // 2, 4).astype(np.float32)
    y = yuyv[:, :, (0, 2)].reshape(height, width)
    u = np.repeat(yuyv[:, :, 1], 2, axis=1).reshape(height, width) - 128.0
    v = np.repeat(yuyv[:, :, 3], 2, axis=1).reshape(height, width) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class V4L2Camera:
    """Streaming mmap capture from a V4L2 device.

    Usage:
        with V4L2Camera("/dev/video0", 640, 480) as cam:
            for frame in cam:   # RGB uint8 [H, W, 3]
                ...
    """

    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, n_buffers: int = 4):
        if not os.path.exists(device):
            raise WebcamUnavailable(
                f"{device} not present — webcam mode needs a V4L2 capture "
                "device (the reference uses cv2.VideoCapture(0), demo.py:33)"
            )
        self.fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        try:
            cap = v4l2_capability()
            fcntl.ioctl(self.fd, VIDIOC_QUERYCAP, cap)

            fmt = v4l2_format()
            fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            fmt.fmt.pix.width = width
            fmt.fmt.pix.height = height
            fmt.fmt.pix.pixelformat = V4L2_PIX_FMT_YUYV
            fmt.fmt.pix.field = 1  # V4L2_FIELD_NONE; the device may set another
            fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
            if fmt.fmt.pix.pixelformat != V4L2_PIX_FMT_YUYV:
                raise WebcamUnavailable(
                    "device does not support YUYV capture"
                )
            self.width = int(fmt.fmt.pix.width)
            self.height = int(fmt.fmt.pix.height)

            req = v4l2_requestbuffers()
            req.count = n_buffers
            req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            req.memory = V4L2_MEMORY_MMAP
            fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)

            self.buffers = []
            for i in range(req.count):
                buf = v4l2_buffer()
                buf.index = i
                buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
                buf.memory = V4L2_MEMORY_MMAP
                fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
                self.buffers.append(
                    mmap.mmap(self.fd, buf.length, offset=buf.m.offset)
                )
                fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)

            fcntl.ioctl(
                self.fd, VIDIOC_STREAMON,
                ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE),
            )
        except OSError as e:
            os.close(self.fd)
            raise WebcamUnavailable(f"V4L2 setup failed: {e}") from e

    def read(self, timeout: float = 2.0) -> np.ndarray:
        """Dequeue one frame, convert to RGB, re-queue the buffer."""
        ready, _, _ = select.select([self.fd], [], [], timeout)
        if not ready:
            raise WebcamUnavailable("webcam frame timeout")
        buf = v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        raw = self.buffers[buf.index][: buf.bytesused]
        frame = yuyv_to_rgb(raw, self.width, self.height)
        fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        return frame

    def __iter__(self):
        while True:
            yield self.read()

    def close(self):
        try:
            fcntl.ioctl(
                self.fd, VIDIOC_STREAMOFF,
                ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE),
            )
        except OSError:
            pass
        for m in self.buffers:
            m.close()
        os.close(self.fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
