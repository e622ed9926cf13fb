"""The PyTorch package's V4L2 webcam reader against the JAX package's, on
the CPU: the YUYV conversion to the byte, the kernel-ABI struct layouts, the
ioctl request numbers and the fourcc, and the refusal of a missing device
(here and through the demo CLI's `webcam` source). The host has no
/dev/video* node, so the capture itself is not run (tests/test_webcam.py
covers the JAX package's the same way)."""

import ctypes

import numpy as np
import pytest

from centerpose_tpu.data import webcam as jax_webcam
from centerpose_tpu_torch import demo
from centerpose_tpu_torch.data import webcam


@pytest.mark.parametrize("width, height", [(2, 1), (8, 4), (64, 48)])
def test_yuyv_to_rgb_matches_jax(width, height):
    frame = np.random.RandomState(width).randint(0, 256, width * height * 2).astype(np.uint8).tobytes()
    out = webcam.yuyv_to_rgb(frame, width, height)
    assert out.shape == (height, width, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jax_webcam.yuyv_to_rgb(frame, width, height))


def test_yuyv_gray_and_bt601():
    """U = V = 128 carries no chroma; one macropixel's BT.601 coefficients."""
    y = (np.arange(32, dtype=np.uint8) * 7).reshape(4, 8)
    frame = np.zeros((4, 8, 2), np.uint8)
    frame[:, :, 0], frame[:, :, 1] = y, 128
    rgb = webcam.yuyv_to_rgb(frame.tobytes(), 8, 4)
    for c in range(3):
        np.testing.assert_array_equal(rgb[:, :, c], y)
    rgb = webcam.yuyv_to_rgb(bytes([100, 200, 100, 50]), 2, 1).astype(np.float64)
    u, v = 200.0 - 128, 50.0 - 128
    np.testing.assert_allclose(rgb[0, 0], np.clip([100 + 1.402 * v, 100 - 0.344136 * u - 0.714136 * v,
                                                   100 + 1.772 * u], 0, 255), atol=1)
    np.testing.assert_array_equal(rgb[0, 0], rgb[0, 1])


@pytest.mark.parametrize("name, size", [
    ("v4l2_capability", 104), ("v4l2_pix_format", 48), ("v4l2_format", 208),
    ("v4l2_requestbuffers", 20), ("v4l2_buffer", 88), ("v4l2_timecode", 16),
])
def test_struct_layout_matches_jax(name, size):
    """linux/videodev2.h on 64-bit: sizes, field names and offsets."""
    ours, ref = getattr(webcam, name), getattr(jax_webcam, name)
    assert ctypes.sizeof(ours) == ctypes.sizeof(ref) == size
    assert [f[0] for f in ours._fields_] == [f[0] for f in ref._fields_]
    for field, *_ in ours._fields_:
        assert getattr(ours, field).offset == getattr(ref, field).offset, field


@pytest.mark.parametrize("name", ["VIDIOC_QUERYCAP", "VIDIOC_S_FMT", "VIDIOC_REQBUFS", "VIDIOC_QUERYBUF",
                                  "VIDIOC_QBUF", "VIDIOC_DQBUF", "VIDIOC_STREAMON", "VIDIOC_STREAMOFF",
                                  "V4L2_PIX_FMT_YUYV", "V4L2_BUF_TYPE_VIDEO_CAPTURE", "V4L2_MEMORY_MMAP"])
def test_ioctl_numbers_match_jax(name):
    assert getattr(webcam, name) == getattr(jax_webcam, name)


def test_known_request_codes():
    assert webcam.VIDIOC_QUERYCAP == 0x80685600 and webcam.VIDIOC_S_FMT == 0xC0D05605
    assert webcam.VIDIOC_QBUF == 0xC058560F and webcam.VIDIOC_DQBUF == 0xC0585611
    assert webcam.VIDIOC_STREAMON == 0x40045612 and webcam.V4L2_PIX_FMT_YUYV == 0x56595559


def test_missing_device_raises_clear_error(tmp_path):
    with pytest.raises(webcam.WebcamUnavailable, match="not present"):
        webcam.V4L2Camera(str(tmp_path / "video9"))


def test_demo_webcam_source_opens_the_device(tmp_path):
    """The demo's `webcam` / `/dev/videoN` source reaches the reader (no
    refusal): a device node that is not there raises the reader's error."""
    args = demo.parse_args(["--demo", "/dev/video_absent_9", "--device", "cpu", "--debug", "2"])
    assert args.debug == 2
    with pytest.raises(webcam.WebcamUnavailable, match="/dev/video_absent_9 not present"):
        next(demo._frames(args))
