"""The host side of the PnP kernel (`ops/pnp.py`, `csrc/pnp.cu`) on the CPU:
the dispatch by device, the packed input and output rows, the ctypes entry's
declaration and its error path, and that nothing is built or loaded at
import. The kernel itself runs only on the card (`chip_smoke.py`, phase
`pnp_kernel`, holds it against the plain version there)."""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops import pnp

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "centerpose_tpu_torch" / "csrc" / "pnp.cu"
CAMERA = np.array([[615.0, 0.0, 320.0], [0.0, 615.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def planted(m, n=16, seed=0):
    """m objects with n noisy points each (n / 8 per corner), the third with
    the points of only 5 corners valid and the last with none."""
    rng = np.random.RandomState(seed)
    reps = n // 8
    pts, cubs = [], []
    for _ in range(m):
        half = rng.uniform(0.2, 0.7, 3)
        cub = np.array([[(-1) ** (1 - (i >> 2 & 1)), (-1) ** (1 - (i >> 1 & 1)), (-1) ** (1 - (i & 1))]
                        for i in range(8)]) * half
        ang = rng.uniform(-0.6, 0.6)
        rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
        pc = cub @ rot.T + [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(3, 6)]
        uv = pc[:, :2] / pc[:, 2:] * [CAMERA[0, 0], CAMERA[1, 1]] + [CAMERA[0, 2], CAMERA[1, 2]]
        pts.append(np.repeat(uv, reps, axis=0) + rng.randn(n, 2) * 0.3)
        cubs.append(cub)
    pts, cubs = np.array(pts, np.float32), np.array(cubs, np.float32)
    if m > 2:
        pts[2, 5 * reps:] = -10000.0
    pts[-1] = -10000.0
    return pts, cubs


@pytest.fixture
def counters():
    """The wrapper's counters, restored after the test."""
    saved = pnp.solve_pnp_packed.launches, pnp.solve_pnp_packed.rows
    yield pnp.solve_pnp_packed
    pnp.solve_pnp_packed.launches, pnp.solve_pnp_packed.rows = saved


def test_cpu_takes_the_plain_path_and_launches_nothing(counters):
    pts, cubs = planted(4)
    before = counters.launches, counters.rows
    out = pnp.solve_pnp_batch(pts, cubs, CAMERA, device="cpu")
    plain = pnp.solve_pnp_plain(pts, cubs, CAMERA, device="cpu")
    packed = pnp.solve_pnp_packed(pts, cubs, CAMERA, device="cpu")
    single = pnp.solve_pnp_single(pts[0], cubs[0], CAMERA, device="cpu")
    assert (counters.launches, counters.rows) == before
    assert out.valid.dtype == torch.bool and out.valid.tolist() == [True, True, True, False]
    for name in pnp.PnPResult._fields:          # NaN where no point is valid, in both
        want = getattr(plain, name).numpy()
        np.testing.assert_array_equal(getattr(out, name).numpy(), want, err_msg=name)
        np.testing.assert_array_equal(getattr(pnp.unpack_result(packed), name).numpy(), want, err_msg=name)
    assert torch.equal(single.translation, plain.translation[0])


@pytest.mark.parametrize("shared", [True, False])
def test_input_rows_hold_points_cuboid_and_intrinsics(shared):
    pts, cubs = planted(3, n=8, seed=1)
    cams = CAMERA if shared else np.stack([CAMERA * [[1.1 ** k], [1.0], [1.0]] for k in range(3)])
    rows = pnp.pack_inputs(pts, cubs, cams)
    assert rows.dtype == torch.float32 and tuple(rows.shape) == (3, 2 * 8 + pnp.INPUT_TAIL)
    assert not rows.is_pinned()
    np.testing.assert_array_equal(rows[:, :16].reshape(3, 8, 2).numpy(), pts)
    np.testing.assert_array_equal(rows[:, 16:40].reshape(3, 8, 3).numpy(), cubs)
    k = np.broadcast_to(cams, (3, 3, 3))
    np.testing.assert_array_equal(rows[:, 40:].numpy(), np.stack(
        [k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], axis=1).astype(np.float32))
    # Tensors pack as arrays do, on their own device.
    again = pnp.pack_inputs(torch.from_numpy(pts), torch.from_numpy(cubs), torch.from_numpy(np.asarray(cams)))
    assert torch.equal(again, rows)


@pytest.mark.parametrize("n", [8, 16, 160])
def test_packed_results_round_trip_on_the_host(n):
    """The packed rows of the plain result read back as the same fields, as
    tensors and as the host array one fetch gives."""
    pts, cubs = planted(5, n=n, seed=n)
    plain = pnp.solve_pnp_plain(pts, cubs, CAMERA, device="cpu")
    packed = pnp.pack_result(plain)
    assert tuple(packed.shape) == (5, pnp.RESULT_WIDTH) == (5, 50)
    for rows in (packed, packed.numpy()):
        back = pnp.unpack_result(rows)
        for name in pnp.PnPResult._fields:
            want = getattr(plain, name).numpy()
            got = np.asarray(getattr(back, name))
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert np.shares_memory(pnp.unpack_result(packed.numpy()).rotation, packed.numpy())


@pytest.mark.parametrize("shape", [(2, 12, 2), (2, 0, 2), (2, 2048, 2), (2, 16, 3)])
def test_packing_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        pnp.pack_inputs(np.zeros(shape, np.float32), np.zeros((2, 8, 3), np.float32), CAMERA)


def test_packing_refuses_mismatched_cuboids_and_cameras():
    pts = np.zeros((2, 8, 2), np.float32)
    with pytest.raises(ValueError):
        pnp.pack_inputs(pts, np.zeros((3, 8, 3), np.float32), CAMERA)
    with pytest.raises(ValueError):
        pnp.pack_inputs(pts, np.zeros((2, 8, 3), np.float32), np.zeros((3, 3, 3), np.float32))


class _Entry:
    """Stands in for a ctypes function of the built library."""

    def __init__(self, status):
        self.argtypes = None
        self.restype = None
        self.status = status
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.status


class _Library:
    def __init__(self, status):
        self.pnp_launch = _Entry(status)


def test_launch_entry_takes_pointers_and_stream_as_void_pointers(counters):
    lib = pnp._declare(_Library(0))
    fn = lib.pnp_launch
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    rows = torch.zeros((3, 2 * 16 + pnp.INPUT_TAIL))
    out = torch.empty((3, pnp.RESULT_WIDTH))
    before = counters.launches, counters.rows
    pnp._launch(lib, rows, out, 16, 4, 0x7F00DEADBEEF)
    assert fn.calls == [(rows.data_ptr(), out.data_ptr(), 3, 16, 4, 0x7F00DEADBEEF)]
    assert (counters.launches, counters.rows) == (before[0] + 1, before[1] + 3)


def test_launch_raises_on_a_refused_launch_and_counts_nothing(counters):
    lib = pnp._declare(_Library(700))
    before = counters.launches, counters.rows
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pnp._launch(lib, torch.zeros((2, 44)), torch.empty((2, pnp.RESULT_WIDTH)), 8, 4, 0)
    assert (counters.launches, counters.rows) == before


def test_snapshot_reports_the_kernel_counters(counters):
    from centerpose_tpu_torch.utils import profiler

    counters.launches, counters.rows = 3, 384
    snap = profiler.snapshot()["counters"]
    assert snap["pnp.launches"] == 3 and snap["pnp.rows"] == 384


def test_source_agrees_with_the_wrapper_and_stays_float32():
    """The layout constants of `csrc/pnp.cu` are the wrapper's, the source is
    among the built ones, and nothing in it or in the flags trades float32
    for speed."""
    src = SOURCE.read_text()
    assert "pnp" in _build.sources()
    for name, value in (("TAIL", pnp.INPUT_TAIL), ("RESULT_WIDTH", pnp.RESULT_WIDTH),
                        ("MAX_POINTS", pnp.MAX_POINTS), ("LM_ITERS", pnp._LM_ITERS),
                        ("DLT_MIN_POINTS", pnp._DLT_MIN_POINTS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert 'extern "C" int pnp_launch(const void* inputs, void* outputs, int m, int n, int min_required,' in src
    assert not any("fast_math" in f or "fast-math" in f for f in _build.NVCC_FLAGS)
    for banned in ("__half", "bfloat16", "__fdividef", "__expf", "__sinf", "__cosf", "double"):
        assert banned not in src, banned


def test_nothing_is_built_or_loaded_at_import():
    code = ("import sys\n"
            "import centerpose_tpu_torch.ops.pnp, centerpose_tpu_torch.inference.detector\n"
            "import centerpose_tpu_torch.tracking.tracker\n"
            "from centerpose_tpu_torch import _build\n"
            "assert not _build._loaded, _build._loaded\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'libpnp' not in maps and 'libdcn' not in maps\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
