"""The float32 DCNv2 forward kernel's tiling, arithmetic and argument checks, on the CPU.

The kernel (`centerpose_tpu_torch/csrc/dcn_v2_fwd.cu`, float32 body) runs
only on a Hopper card, where `chip_smoke.py` holds it against the plain
version. What surrounds it is checked here: the tile, grid and split of the
K loop it chooses per shape (`ops/dcn_fwd.py::f32_plan`, the mirror of
`dcn_v2_fwd_f32_plan`, which `chip_smoke.py` requires to be equal on the
card), the constants the mirror shares with the source, the instructions the
body is built from, why the body needs three TF32 products and not one (a
value-level 3xTF32 forward against `dcn_v2`), and the wrapper's refusals and
allocations, which come before any build.
"""

import contextlib
import re
import types

import numpy as np
import pytest
import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops import dcn_fwd
from centerpose_tpu_torch.ops.dcn import dcn_v2
from centerpose_tpu_torch.ops.dcn_bwd import split_tf32
from centerpose_tpu_torch.ops.dcn_fwd import f32_plan

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
H100_SMS = 132
TOL_F32 = 1e-4                     # chip_smoke.py's float32 tolerance (absolute)


def _source() -> str:
    return (_build.CSRC / "dcn_v2_fwd.cu").read_text()


def _f32_body() -> str:
    """The source from the float32 section to the bfloat16 one."""
    src = _source()
    return src[src.index("// ---------------------------------------------------------------- float32"):
               src.index("// --------------------------------------------------------------- bfloat16")]


def _steps(c: int) -> int:
    return 9 * -(-c // dcn_fwd.F32_BK)


@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_f32_plan_covers_every_output_once(b, h, w, c, co):
    """Every (pixel, output channel) is owned by exactly one (grid x, grid y)
    tile and every step of the K loop by exactly one range of the split, so
    each output is written once (split 1) or summed from one partial per
    range; no tile and no range is empty."""
    plan = f32_plan(b, h, w, c, co)
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
    assert bm == 64 and bn == (64 if co <= 64 else 128)
    n, split = _steps(c), plan["split"]
    steps = np.zeros(n, np.int8)
    for z in range(split):
        s0, s1 = n * z // split, n * (z + 1) // split
        assert s1 > s0                                   # no empty range
        steps[s0:s1] += 1
    assert (steps == 1).all()


@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_f32_plan_splits_only_small_grids(b, h, w, c, co):
    """The K loop is split only where pixel tiles x channel tiles fall short
    of one wave of 132 SMs, and then into enough ranges of at least 4 steps
    to reach 132 blocks, or as many as the K loop allows."""
    plan = f32_plan(b, h, w, c, co)
    gx, gy = plan["grid"]
    n, split = _steps(c), plan["split"]
    if gx * gy >= H100_SMS:
        assert split == 1
    else:
        assert split == min(-(-H100_SMS // (gx * gy)), n // dcn_fwd.F32_MIN_RANGE)
        assert n // split >= dcn_fwd.F32_MIN_RANGE
        assert gx * gy * split >= H100_SMS or split == n // dcn_fwd.F32_MIN_RANGE


@pytest.mark.parametrize("hw,c,co", PRODUCTION)
def test_f32_plan_fills_the_card_at_batch_1(hw, c, co):
    """At B=1 (one tracked frame) every production shape runs at least the
    blocks of the parent body's grid (64 pixels x 64 channels, no split) and
    at least 132, the K loop allowing it at every one of them."""
    plan = f32_plan(1, hw, hw, c, co)
    blocks = plan["grid"][0] * plan["grid"][1] * plan["split"]
    parent = -(-hw * hw // 64) * -(-co // 64)
    assert blocks >= parent
    assert blocks >= H100_SMS
    if plan["grid"][0] * plan["grid"][1] < H100_SMS:
        assert plan["split"] > 1


@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_f32_plan_fits_the_card(b, h, w, c, co):
    """Shared memory within a block's 227 KB and, for the blocks per SM the
    kernel is bounded to, within the SM's 228 KB; the scratch is the
    weight's hi/lo copy and, where the loop is split, one float32 partial
    of the output per range."""
    plan = f32_plan(b, h, w, c, co)
    bn, stages = plan["block_n"], plan["stages"]
    assert plan["smem_bytes"] == 1024 + stages * 2 * (64 + bn) * 128 + 9 * 64 * 20
    assert plan["smem_bytes"] <= BLOCK_SHARED_MAX
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + BLOCK_RESERVED) <= SM_SHARED_BYTES
    assert stages == 2 and plan["blocks_per_sm"] == 2
    partial = plan["split"] * b * h * w * co if plan["split"] > 1 else 0
    assert plan["scratch_bytes"] == 4 * (2 * 9 * c * co + partial)


def test_f32_plan_refuses_what_the_kernel_does_not_take():
    """Channels not multiples of 8, an empty map, and corner indices beyond
    a 32-bit int are refused by the mirror as by the source."""
    for args in ((1, 4, 4, 12, 8), (1, 4, 4, 8, 20), (0, 4, 4, 8, 8), (1, 2 ** 16, 2 ** 15, 8, 8)):
        with pytest.raises(ValueError):
            f32_plan(*args)


def test_f32_plan_mirrors_the_source_constants():
    """The Python mirror and the CUDA source state the same constants, the
    same output tile, stages per tile, launch bound and split rule."""
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BM") == dcn_fwd.F32_BLOCK_M == 64
    assert const("F32_BK") == dcn_fwd.F32_BK == 32
    assert const("F32_MIN_RANGE") == dcn_fwd.F32_MIN_RANGE
    assert const("F32_SMS") == dcn_fwd.F32_SMS == H100_SMS
    assert const("ROW_BYTES") == 128 and const("TAPS") == 9 and const("NT") == 256
    assert const("F32_STAGES") == dcn_fwd.F32_STAGES == 2
    assert "__launch_bounds__(NT, 2)\ndcn_v2_fwd_f32_kernel" in src
    assert dcn_fwd.F32_BLOCKS_PER_SM == 2
    assert "p->bn = Co <= 64 ? 64 : 128;" in src
    assert "if (base < F32_SMS) {" in src
    assert "const int want = (int)((F32_SMS + base - 1) / base);" in src
    assert "const int most = nsteps / F32_MIN_RANGE;" in src


def test_f32_body_is_built_from_hopper_instructions():
    """The float32 body multiplies in 3xTF32 with wgmma from shared-memory
    descriptors (three products per k8 slice, lo.hi, hi.lo, hi.hi, a step's
    first from zero), splits its operands with cvt.rna.tf32 where they are
    written, brings the weight by cp.async, fences the column stores for the
    async proxy, keeps a step's products in flight while the next step is
    gathered and only then adds them to a float32 sum, sums split partials
    in a fixed order (no atomics), and keeps no FMA tile and no mma.sync
    path."""
    body = _f32_body()
    for needle in ("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32",
                   "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                   "cvt.rna.tf32.f32", "cp_async16(", "wgmma_wait<0>()",
                   "f32_sum_partials_kernel", "f32_weight_split_kernel",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert needle in body, needle
    for needle in ("cp.async.cg.shared.global", "fence.proxy.async.shared::cta"):
        assert needle in _source(), needle
    kernel = body[body.index("dcn_v2_fwd_f32_kernel(const F32Args a)"):body.index("f32_weight_split_kernel")]
    assert "fence_proxy_async();" in kernel
    assert "fmaf(a[i], b[j]" not in _source() and "mma.sync" not in body
    assert "atomicAdd" not in body
    products = re.findall(
        r"WgmmaTf32<NW>::mma\(acc, (da_\w+) \+ 2 \* kk, (db_\w+) \+ 2 \* kk, ([^)]+)\)", kernel)
    assert products == [("da_lo", "db_hi", "kk > 0"), ("da_hi", "db_lo", "1"), ("da_hi", "db_hi", "1")]
    loop = kernel[kernel.index("for (int s = s0; s < s1; ++s)"):]
    # the gather of step s+1 sits between the commit of step s and its wait,
    # and the step's products reach the sum after the wait
    commit, gather = loop.index("wgmma_commit()"), loop.index("f32_gather_tile(")
    wait, add = loop.index("wgmma_wait<0>()"), loop.index("sum[i] += acc[i];")
    assert commit < gather < wait < add
    # the old interface takes bf16 only; float32 has its own entry
    assert "if (dtype != 1) return -1;" in _source()


# ----------------------------------------------------------------- 3xTF32
def _operands(b=1, h=6, w=6, c=512, co=64, seed=0, dtype=torch.float32, misalign=None):
    """CPU operands of one call, made as chip_smoke.py makes them (offsets
    uniform in +-3, gates sigmoid(2 N(0, 1)), weight N(0, 1/(9C))): offset a
    slice of a [B, H, W, 27] tensor, the weight contiguous HWIO; `misalign`
    = "x" or "weight" moves that tensor 4 bytes off a 16-byte boundary."""
    rng = np.random.RandomState(seed)

    def tensor(a, off=False):
        flat = np.concatenate([a.ravel(), np.zeros(4)]).astype(np.float32)
        t = torch.from_numpy(flat).to(dtype)
        n = a.size
        return (t[1:1 + n] if off else t[:n]).view(*a.shape)

    x = tensor(rng.randn(b, h, w, c), off=misalign == "x")
    om = np.empty((b, h, w, 27))
    om[..., :18] = (rng.rand(b, h, w, 18) * 2 - 1) * 3.0
    om[..., 18:] = rng.randn(b, h, w, 9) * 2.0
    om = tensor(om)
    weight = tensor(rng.randn(3, 3, c, co) / np.sqrt(9 * c), off=misalign == "weight")
    bias = tensor(rng.randn(co) * 0.1)
    return [x, om[..., :18], torch.sigmoid(om[..., 18:]), weight, bias]


def test_three_tf32_products_hold_the_forward_tolerance():
    """Why the body issues three TF32 products: the forward as the kernel
    computes it, columns and weight each split into TF32 hi and lo parts
    (`split_tf32`, the kernel's cvt.rna) and the three products summed in
    float32, is within chip_smoke.py's 1e-4 of `dcn_v2` at the deepest
    production K, 9 x 512 (16^2 C512 of dlav1_34), and one TF32 product is
    not. The map is 6x6 (36 pixels, 2304 outputs): K, not the map, sets the
    error of one TF32 product, about 2^-11 of each term summed over 4608
    terms, several times 1e-4 at the largest of 2304 outputs; 3xTF32 drops
    about 2^-22 of a term."""
    x, offset, mask, weight, bias = _operands()
    c, co = weight.shape[2], weight.shape[3]
    ref = dcn_v2(x, offset, mask, weight, bias).reshape(-1, co)
    # The columns m_t * bil(x, p_t) [pixels, 9C], exactly: dcn_v2 against an
    # identity weight (products by 1 and 0, sums of zeros).
    eye = torch.eye(9 * c).reshape(3, 3, c, 9 * c)
    cols = dcn_v2(x, offset, mask, eye, torch.zeros(9 * c)).reshape(-1, 9 * c)
    w_mat = weight.reshape(9 * c, co)
    ah, al = split_tf32(cols)
    bh, bl = split_tf32(w_mat)
    three = (al @ bh + ah @ bl) + ah @ bh + bias
    one = ah @ bh + bias
    err3 = (three - ref).abs().max().item()
    err1 = (one - ref).abs().max().item()
    assert err3 <= TOL_F32 / 10, err3
    assert err1 > TOL_F32, err1


# ----------------------------------------------------------------- wrapper
@pytest.mark.parametrize("case", ["c_not_8", "co_not_8", "mixed_dtypes", "x_misaligned",
                                  "weight_misaligned", "x_not_contiguous", "bad_offset", "empty"])
def test_f32_wrapper_refuses_before_any_build(case, monkeypatch):
    """What the float32 kernel does not take raises in the wrapper, before
    the library is built or loaded, as it did for the body it replaces."""
    def no_build(name):
        raise AssertionError(f"{name} was built for arguments the kernel does not take")

    monkeypatch.setattr(_build, "load", no_build)
    err = ValueError
    if case == "c_not_8":
        args = _operands(c=12, co=16)
    elif case == "co_not_8":
        args = _operands(c=16, co=20)
    elif case == "mixed_dtypes":
        args, err = _operands(c=16, co=16), TypeError
        args[4] = args[4].double()
    elif case == "x_not_contiguous":
        args = _operands(c=16, co=16)
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "bad_offset":
        args = _operands(c=16, co=16)
        args[1] = args[1][..., :16]
    elif case == "empty":
        args = _operands(b=1, h=0, w=6, c=16, co=16)
    else:
        name = case.split("_")[0]
        args = _operands(c=16, co=16, misalign=name)
        assert args[0 if name == "x" else 3].data_ptr() % 16 == 4
    with pytest.raises(err):
        dcn_fwd._launch_forward(*args)


class _FakeLibrary:
    """Stands in for the built library: records each float32 launch."""

    def __init__(self):
        self.calls = []

        def launch(*args):
            self.calls.append(args)
            return 0

        self.dcn_v2_fwd_f32_launch = launch
        self.dcn_v2_fwd_launch = launch
        launch.argtypes = launch.restype = None


@pytest.mark.parametrize("b,h,w,c,co", [(1, 9, 11, 72, 200), (2, 9, 11, 24, 40), (1, 12, 12, 8, 8),
                                        (8, 2, 64, 16, 64)])
def test_f32_wrapper_allocates_the_plan_scratch(b, h, w, c, co, monkeypatch):
    """Arguments the kernel takes reach the float32 launch with the scratch
    that `f32_plan` states: the weight's hi/lo copy [2, Co, 9C] and, where
    the K loop is split, [split, M, Co] partials (none, and a null pointer,
    where it is not), allocated uninitialised; the launch is counted once."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(dcn_fwd, "_declare", lambda built: built)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=None))
    made = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made.append((t.data_ptr(), t.numel()))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    args = _operands(b=b, h=h, w=w, c=c, co=co)
    before = dcn_fwd.dcn_v2_forward.launches
    out = dcn_fwd._launch_forward(*args)
    assert dcn_fwd.dcn_v2_forward.launches == before + 1
    assert len(lib.calls) == 1
    call = lib.calls[0]
    plan = f32_plan(b, h, w, c, co)
    sizes = dict(made)
    w_split, partials, n_part = call[6], call[7], call[8]
    assert sizes[w_split] == 2 * 9 * c * co
    partial = plan["split"] * b * h * w * co if plan["split"] > 1 else 0
    assert n_part == partial == plan["scratch_bytes"] // 4 - 2 * 9 * c * co
    assert (partials is None) == (partial == 0)
    if partial:
        assert sizes[partials] == partial and partials % 16 == 0
    assert call[5] == out.data_ptr() and tuple(out.shape) == (b, h, w, co)
    assert call[9:14] == (b, h, w, c, co)
    assert call[14:16] == (27, 9)                        # pixel strides of offset / mask
    assert call[3] == args[3].data_ptr()                 # the [9C, Co] weight, not copied
