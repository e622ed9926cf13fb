"""The bf16 DCNv2 forward kernel's tiling and argument checks, on the CPU.

The kernel (`centerpose_tpu_torch/csrc/dcn_v2_fwd.cu`, bf16 body) runs only
on a Hopper card, where `chip_smoke.py` holds it against the plain version.
What surrounds it is checked here: the tile and grid it chooses per shape
(`ops/dcn_fwd.py::bf16_plan`, the mirror of `dcn_v2_fwd_bf16_plan`, which
`chip_smoke.py` requires to be equal on the card), the constants the mirror
shares with the source, the instructions the body is built from, and the
wrapper's refusals, which come before any build.
"""

import re

import numpy as np
import pytest
import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops import dcn_fwd
from centerpose_tpu_torch.ops.dcn_fwd import bf16_plan

# (H = W, C, Co) of the 16 DCN calls of dlav1_34 / dla_34 at 512x512.
PRODUCTION = [(128, 64, 64), (64, 128, 128), (64, 128, 64), (32, 256, 256),
              (32, 256, 128), (32, 256, 64), (16, 512, 256)]
# (H, W, C, Co) of the tail cases: chunks of C and tiles of Co and of pixels
# that the kernel's tiles do not divide.
TAILS = [(9, 11, 8, 8), (9, 11, 24, 40), (9, 11, 72, 200), (9, 11, 64, 136)]
SHAPES = ([(b, hw, hw, c, co) for hw, c, co in PRODUCTION for b in (1, 8)]
          + [(b, h, w, c, co) for h, w, c, co in TAILS for b in (1, 2)])
SM_SHARED_BYTES = 228 * 1024       # an H100 SM's shared memory
BLOCK_SHARED_MAX = 227 * 1024      # the most one block may have
BLOCK_RESERVED = 1024              # the SM keeps 1 KB per resident block


def _source() -> str:
    return (_build.CSRC / "dcn_v2_fwd.cu").read_text()


def _bf16_body() -> str:
    """The source from the bf16 section to the C entry points."""
    src = _source()
    return src[src.index("// --------------------------------------------------------------- bfloat16"):
               src.index('extern "C"')]


@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_bf16_plan_covers_every_output_once(b, h, w, c, co):
    """Every (pixel, output channel) is owned by exactly one block, no block
    is empty, and the grid has at least as many blocks as the parent body's
    64-pixel x 128-channel grid had."""
    plan = bf16_plan(b, h, w, c, co)
    bm, bn = plan["block_m"], plan["block_n"]
    gx, gy = plan["grid"]
    m = b * h * w
    cover = np.zeros((m, co), np.int8)
    for i in range(gx):
        assert i * bm < m
        for j in range(gy):
            assert j * bn < co
            cover[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += 1
    assert (cover == 1).all()
    assert gx * gy >= -(-m // 64) * -(-co // 128)
    assert bn == min(max(co, 64), 128) and bm == 64


@pytest.mark.parametrize("co", [8, 40, 64, 128, 136, 200, 256])
def test_bf16_plan_fits_the_card(co):
    """The wgmma width of each of the two warpgroups is a multiple of 8 up to
    256, and the ring of stages with the corner tables leaves room for two
    blocks on one SM."""
    plan = bf16_plan(8, 32, 32, 256, co)
    assert plan["block_n"] // 2 % 8 == 0 and plan["block_n"] // 2 <= 256
    assert plan["smem_bytes"] <= BLOCK_SHARED_MAX
    assert 2 * (plan["smem_bytes"] + BLOCK_RESERVED) <= SM_SHARED_BYTES
    assert plan["stages"] >= 3     # the buffer a step fills is two steps old


def test_bf16_plan_mirrors_the_source_constants():
    """The Python mirror and the CUDA source state the same tile constants and
    the same choice of output tile."""
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BM") == dcn_fwd.BF16_BLOCK_M
    assert const("STAGES") == dcn_fwd.BF16_STAGES
    assert const("TAPS") == 9 and const("TK") == 64 and const("ROW_BYTES") == 128
    assert "return Co <= 64 ? 64 : 128;" in src


def test_bf16_body_is_built_from_hopper_instructions():
    """The bf16 body multiplies with wgmma from shared-memory descriptors in
    the 128-byte swizzle, brings the weight by cp.async, fences the column
    stores for the async proxy, lets one product stay in flight while the
    next step is gathered, and keeps no mma.sync path."""
    body = _bf16_body()
    for needle in ("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                   "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16",
                   "cp.async.cg.shared.global", "fence.proxy.async.shared::cta",
                   "wgmma_wait<1>()", "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert needle in _source(), needle
    assert "mma.sync" not in body and "ldmatrix" not in body
    loop = body[body.index("for (int s = 0; s < nsteps; ++s)"):]
    # the gather of step s+1 sits between the commit of step s and the wait
    commit, gather, wait = (loop.index(k) for k in ("wgmma_commit()", "gather_tile(", "wgmma_wait<1>()"))
    assert commit < gather < wait


def _operands(dtype=torch.bfloat16, c=16, co=16, misalign=None):
    """CPU operands of one call; `misalign` = "x" or "weight" moves that
    tensor's data 2 bytes off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(0)

    def tensor(*shape, off=False):
        n = int(np.prod(shape))
        flat = torch.randn(n + 8, generator=gen).to(dtype)
        return (flat[1:1 + n] if off else flat[:n]).view(*shape)

    x = tensor(1, 5, 6, c, off=misalign == "x")
    om = tensor(1, 5, 6, 27)
    weight = tensor(co, 3, 3, c, off=misalign == "weight").permute(1, 2, 3, 0)
    return [x, om[..., :18], torch.sigmoid(om[..., 18:]), weight, tensor(co)]


@pytest.mark.parametrize("case", ["c_not_8", "co_not_8", "mixed_dtypes", "x_misaligned",
                                  "weight_misaligned"])
def test_wrapper_refuses_before_any_build(case, monkeypatch):
    """What the kernel does not take raises in the wrapper, before the
    library is built or loaded."""
    def no_build(name):
        raise AssertionError(f"{name} was built for arguments the kernel does not take")

    monkeypatch.setattr(_build, "load", no_build)
    if case == "c_not_8":
        args, err = _operands(c=12), ValueError
    elif case == "co_not_8":
        args, err = _operands(co=20), ValueError
    elif case == "mixed_dtypes":
        args, err = _operands(), TypeError
        args[3] = args[3].float()
    else:
        args, err = _operands(misalign=case.split("_")[0]), ValueError
        assert args[0 if case == "x_misaligned" else 3].data_ptr() % 16 == 2
    with pytest.raises(err):
        dcn_fwd._launch_forward(*args)


def test_wrapper_reaches_the_build_for_what_it_takes(monkeypatch):
    """Arguments the kernel takes pass every check and go on to the build,
    which on a host without a CUDA compiler raises (there is no fallback)."""
    built = []

    def fake_load(name):
        built.append(name)
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(_build, "load", fake_load)
    with pytest.raises(RuntimeError, match="no compiler here"):
        dcn_fwd._launch_forward(*_operands())
    assert built == ["dcn_v2_fwd"]
