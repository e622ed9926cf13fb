"""The float32 DCNv2 backward kernels' tiling, arithmetic and argument checks, on the CPU.

The kernels (`centerpose_tpu_torch/csrc/dcn_v2_bwd.cu`) run only on a Hopper
card, where `chip_smoke.py` holds them against the plain version. What
surrounds them is checked here: the tiling and scratch each chooses per call
(`ops/dcn_bwd.py::bwd_plan`, the mirror of `dcn_v2_bwd_plan`, which
`chip_smoke.py` requires to be equal on the card), the constants the mirror
shares with the source, the instructions the products are built from, the
3xTF32 split of float32 operands (`split_tf32`) and why the kernels need
three TF32 products and not one, and the wrapper's refusals and allocations,
which come before any build.
"""

import contextlib
import ctypes
import re
import types

import numpy as np
import pytest
import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops import dcn_bwd
from centerpose_tpu_torch.ops.dcn_bwd import bwd_plan, split_tf32

# (H = W, C, Co) of the 16 DCN calls of dlav1_34 / dla_34 at 512x512.
PRODUCTION = [(128, 64, 64), (64, 128, 128), (64, 128, 64), (32, 256, 256),
              (32, 256, 128), (32, 256, 64), (16, 512, 256)]
# (H, W, C, Co) of the tail cases: chunks of C, tiles of Co and of pixels
# that the kernels' tiles do not divide.
TAILS = [(9, 11, 8, 8), (9, 11, 24, 40), (9, 11, 72, 200), (9, 11, 64, 136)]
SHAPES = ([(b, hw, hw, c, co) for hw, c, co in PRODUCTION for b in (1, 2, 8)]
          + [(b, h, w, c, co) for h, w, c, co in TAILS for b in (1, 2)])
KERNELS = ("fused", "dx", "dcoord", "dw")
SM_SHARED_BYTES = 228 * 1024       # an H100 SM's shared memory
BLOCK_SHARED_MAX = 227 * 1024      # the most one block may have
BLOCK_RESERVED = 1024              # the SM keeps 1 KB per resident block


def _source() -> str:
    return (_build.CSRC / "dcn_v2_bwd.cu").read_text()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_bwd_plan_covers_every_sample_once(kernel, b, h, w, c, co):
    """The grid is slabs x 9 taps x channel groups. Every 64-pixel tile is in
    exactly one slab, every input channel in exactly one chunk of one group,
    no slab and no group is empty, and the blocks fill the card's slots."""
    plan = bwd_plan(kernel, b, h, w, c, co)
    m = b * h * w
    tiles, slabs, groups, nch = plan["tiles"], plan["slabs"], plan["grid_z"], plan["chunks_per_block"]
    assert plan["grid_x"] == slabs and plan["grid_y"] == 9 and plan["block_m"] == 64
    assert tiles == -(-m // 64) and 1 <= slabs <= tiles
    pixels = np.zeros(m, np.int8)
    for s in range(slabs):
        t0, t1 = tiles * s // slabs, tiles * (s + 1) // slabs
        assert t1 > t0                                    # no empty slab
        for t in range(t0, t1):
            pixels[t * 64:(t + 1) * 64] += 1
    assert (pixels == 1).all()
    channels = np.zeros(c, np.int8)
    for g in range(groups):
        first = g * nch * 64
        assert first < c                                  # no empty group
        channels[first:first + nch * 64] += 1
    assert (channels == 1).all()
    blocks = slabs * 9 * groups
    slots = 132 * plan["blocks_per_sm"]
    assert blocks >= min(slots, tiles * 9 * groups) // 2 or slabs == tiles


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_bwd_plan_fits_the_card(kernel, b, h, w, c, co):
    """Shared memory within a block's 227 KB and the SM's 228 KB for the
    blocks per SM the slabs were chosen for; the register accumulators (dW
    over the slab, the gs tile, the coordinate sums) within 255 a thread
    (128 where two blocks share an SM); the dW partials within the cap."""
    plan = bwd_plan(kernel, b, h, w, c, co)
    smem, per_sm = plan["smem_bytes"], plan["blocks_per_sm"]
    assert smem <= BLOCK_SHARED_MAX and per_sm >= 1
    assert per_sm * (smem + BLOCK_RESERVED) <= SM_SHARED_BYTES
    dw_acc = plan["chunks_per_block"] * plan["co_tiles"] * 16 if kernel in ("fused", "dw") else 0
    assert dw_acc + 16 + 12 <= {1: 255, 2: 128, 3: 80}[per_sm] - 32
    assert 64 * plan["co_tiles"] >= co > 64 * plan["co_tiles"] // 2 or co <= 64
    assert plan["dw_partial_bytes"] <= dcn_bwd.BWD_SCRATCH_CAP
    wsize = 9 * c * co
    assert plan["scratch_floats"] * 4 == (
        (8 * wsize if kernel != "dw" else 0) + plan["dw_partial_bytes"] + plan["coord_partial_bytes"])
    assert plan["dw_partial_bytes"] in (0, 4 * wsize * plan["slabs"])


def test_bwd_plan_production_grids():
    """At the training batch the grid of every production shape fills at
    least 80 % of the card's block slots, and the whole scratch of a call
    stays under 25 MB."""
    for hw, c, co in PRODUCTION:
        plan = bwd_plan("fused", 8, hw, hw, c, co)
        blocks = plan["grid_x"] * plan["grid_y"] * plan["grid_z"]
        slots = 132 * plan["blocks_per_sm"]
        waves = -(-blocks // slots)
        assert blocks >= 0.8 * slots * waves or blocks >= 0.8 * slots, (hw, c, co, plan)
        assert plan["scratch_floats"] * 4 < 25 * 2 ** 20


def test_bwd_plan_mirrors_the_source_constants():
    """The Python mirror and the CUDA source state the same constants and
    the same rules for the Co tile and the chunks per block."""
    src = _source()

    def const(name):
        rhs = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", src).group(1)
        assert re.fullmatch(r"[0-9L <*]+", rhs), rhs
        return eval(rhs.replace("LL", ""), {})

    assert const("BM") == dcn_bwd.BWD_BLOCK_M == 64
    assert const("BC") == dcn_bwd.BWD_CHUNK == 64
    assert const("NT") == 256 and const("TAPS") == 9
    assert const("MAX_CO") == dcn_bwd.BWD_MAX_CO
    assert const("SCRATCH_CAP") == dcn_bwd.BWD_SCRATCH_CAP
    assert const("SM_SHARED") == dcn_bwd.SM_SHARED_BYTES == SM_SHARED_BYTES
    assert const("BLOCK_RESERVED") == dcn_bwd.BLOCK_RESERVED_BYTES
    assert "p->nco = Co <= 64 ? 1 : (Co <= 128 ? 2 : 4);" in src
    assert "p->nch = !has_dw(kind) ? chunks : ((p->nco == 1 && chunks >= 2) ? 2 : 1);" in src
    assert "p->smem = 4 * (2 * BM * 64 * p->nco + (has_dw(kind) ? 2 : 1) * BM * BC) + BM * 24;" in src
    assert "!has_dw(kind) ? (p->nco == 1 ? 3 : 2) : (p->nch * p->nco > 2 ? 1 : 2);" in src


def test_bwd_source_is_built_from_tensor_core_instructions():
    """Both products issue TF32 tensor-core instructions in the 3xTF32 split
    (three products per fragment pair, operands rounded by cvt.rna.tf32), dW
    goes through partials and a fixed-order sum, not atomics, and no library
    computes a product."""
    src = _source()
    assert "cvt.rna.tf32.f32" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    mma3 = src[src.index("void mma3("):]
    mma3 = mma3[:mma3.index("\n}\n")]
    assert mma3.count("mma_tf32(") == 3
    body = src[src.index("dcn_v2_bwd_kernel(const BwdArgs a)"):src.index("weight_fragments_kernel")]
    assert body.count("mma3(") == 2                       # gs and dW
    assert re.findall(r"add4\(([^,]+)", body) == ["a.dx + i00", "a.dx + i01", "a.dx + i10", "a.dx + i11"]
    assert "sum_partials_kernel" in src and "atomicAdd" not in body
    if "wgmma.mma_async" in src:
        assert "fence.proxy.async" in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()


# ----------------------------------------------------------------- 3xTF32
def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 values to 10 stored mantissa bits, to nearest with ties
    away from zero, by arithmetic in float64 on the value (not on its bits):
    the grid step is 2^(e - 10) for a normal value of exponent e and
    2^(-136) below the normal range. Infinity and NaN pass through."""
    x = x.astype(np.float32)
    out = x.astype(np.float64).copy()
    finite = np.isfinite(x) & (x != 0)
    a = np.abs(x[finite].astype(np.float64))
    e = np.maximum(np.floor(np.log2(a)), -126.0)
    step = np.exp2(e - 10)
    q = np.floor(a / step + 0.5) * step                 # ties away from zero (on |x|)
    out[finite] = np.sign(x[finite]) * q
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


EDGES = np.array([
    1.0, -1.0, 0.0, -0.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),          # exact ties: away from zero
    1.0 + 3 * 2 ** -11, 1.0 + 2 ** -11 - 2 ** -23, 1.0 + 2 ** -11 + 2 ** -23,
    np.float32(np.pi), -np.float32(np.e), 3.0e38, -3.0e38,
    np.finfo(np.float32).max, -np.finfo(np.float32).max,              # round up to infinity
    np.float32(2.0 ** 127 * (2 - 2 ** -10)),                          # the largest TF32 value
    np.finfo(np.float32).tiny, np.finfo(np.float32).tiny * (1 + 2 ** -11),
    np.float32(2.0 ** -149), np.float32(2.0 ** -140), np.float32(3 * 2.0 ** -137),   # subnormals
    np.float32(2.0 ** -126 - 2.0 ** -149), 1e-30, -7.5e-41,
    np.inf, -np.inf,
], dtype=np.float32)


def test_split_tf32_matches_a_value_level_rounding():
    """`split_tf32`'s high part is the TF32 rounding of `cvt.rna.tf32.f32`
    (ties away from zero, subnormals kept, infinity and NaN passed through,
    the largest floats rounded to infinity), bit for bit, on edge values and
    on 100k random values over the whole exponent range; the low part is the
    remainder rounded the same way."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    vals = np.concatenate([EDGES, bits.view(np.float32)])
    vals = vals[~np.isnan(vals)]
    hi, lo = split_tf32(torch.from_numpy(vals))
    ref_hi = _tf32_reference(vals)
    assert np.array_equal(hi.numpy().view(np.uint32), ref_hi.view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    fin = np.isfinite(ref_hi)
    rem = (vals[fin].astype(np.float32) - ref_hi[fin]).astype(np.float32)
    assert np.array_equal(lo.numpy()[fin].view(np.uint32), _tf32_reference(rem).view(np.uint32))
    # hi + lo carries 21 significant bits wherever both parts are normal floats
    normal = fin & (np.abs(vals) >= 2.0 ** -100) & (np.abs(vals) < 2.0 ** 127)
    err = np.abs(hi.numpy()[normal].astype(np.float64) + lo.numpy()[normal] - vals[normal])
    assert (err <= np.abs(vals[normal].astype(np.float64)) * 2.0 ** -21).all()
    ties = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11)])
    assert split_tf32(ties)[0].tolist() == [1.0 + 2 ** -10, -(1.0 + 2 ** -10)]
    special, _ = split_tf32(torch.tensor([np.inf, -np.inf, np.nan, np.finfo(np.float32).max]))
    assert special[0] == np.inf and special[1] == -np.inf and torch.isnan(special[2])
    assert special[3] == np.inf
    with pytest.raises(TypeError):
        split_tf32(torch.zeros(2, dtype=torch.float64))


def _tf32_product(a, b, passes):
    """a @ b in float32 from TF32 parts: `passes` 1 = a_hi.b_hi, 3 = the
    3xTF32 sum (a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, in the kernels' order).
    Products of TF32 values are exact in float32; the sums are float32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("product,m,k,n", [
    ("gs, K = Co", 64, 256, 64),            # gs[px][c] over the output channels
    ("dW, K = a slab's pixels", 256, 4544, 64),   # dW^T[co][c] over 71 tiles of 64 pixels
])
def test_three_tf32_products_hold_the_gradient_tolerance(product, m, k, n):
    """Why the kernels issue three TF32 products: at the production depths the
    3xTF32 sum stays within 1e-5 of the largest term against float64, one
    TF32 product does not stay within 1e-4 (the gradient check's relative
    tolerance on the card)."""
    rng = np.random.RandomState(k)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = np.abs(_tf32_product(ta, tb, 3).double().numpy() - ref).max() / scale
    err1 = np.abs(_tf32_product(ta, tb, 1).double().numpy() - ref).max() / scale
    assert err3 <= 1e-5, (product, err3)
    assert err1 > 1e-4, (product, err1)


# ----------------------------------------------------------------- wrapper
def _operands(c=16, co=16, b=1, h=5, w=6, dtype=torch.float32, misalign=None):
    """CPU operands of one call; `misalign` = "x", "weight" or "dout" moves
    that tensor's data 4 bytes off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(0)

    def tensor(*shape, off=False):
        n = int(np.prod(shape))
        flat = torch.randn(n + 8, generator=gen).to(dtype)
        return (flat[1:1 + n] if off else flat[:n]).view(*shape)

    x = tensor(b, h, w, c, off=misalign == "x")
    om = tensor(b, h, w, 27)
    weight = tensor(3, 3, c, co, off=misalign == "weight")
    dout = tensor(b, h, w, co, off=misalign == "dout")
    return [x, om[..., :18], torch.sigmoid(om[..., 18:]), weight, dout]


@pytest.mark.parametrize("case", ["c_not_8", "co_not_8", "bfloat16", "mixed_dtypes",
                                  "x_misaligned", "weight_misaligned", "dout_misaligned"])
def test_wrapper_refuses_before_any_build(case, monkeypatch):
    """What the kernels do not take raises in the wrapper, before the
    library is built or loaded."""
    def no_build(name):
        raise AssertionError(f"{name} was built for arguments the kernel does not take")

    monkeypatch.setattr(_build, "load", no_build)
    if case == "c_not_8":
        args, err = _operands(c=12), ValueError
    elif case == "co_not_8":
        args, err = _operands(co=20), ValueError
    elif case == "bfloat16":
        # bf16 operands are taken when all five are bf16; a float32 offset
        # beside them is not.
        args, err = _operands(dtype=torch.bfloat16), TypeError
        args[1] = args[1].float()
    elif case == "mixed_dtypes":
        args, err = _operands(), TypeError
        args[3] = args[3].double()
    else:
        name = case.split("_")[0]
        args, err = _operands(misalign=name), ValueError
        assert args[{"x": 0, "weight": 3, "dout": 4}[name]].data_ptr() % 16 == 4
    for kernel in KERNELS:
        if case == "x_misaligned" and kernel == "dx":
            continue                                      # the dX kernel reads no x
        with pytest.raises(err):
            dcn_bwd._launch(kernel, None if kernel == "dx" else args[0], *args[1:])


class _FakeLibrary:
    """Stands in for the built library: records each launch's arguments."""

    def __init__(self):
        self.calls = []
        for kernel in KERNELS:
            setattr(self, f"dcn_v2_bwd_{kernel}_launch", self._launcher(kernel))

    def _launcher(self, kernel):
        def launch(*args):
            self.calls.append((kernel, args))
            return 0
        launch.argtypes = launch.restype = None
        return launch


@pytest.mark.parametrize("co", [16, 264])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_allocates_the_plan_scratch(kernel, co, monkeypatch):
    """Arguments the kernels take reach the launch with the scratch that
    `bwd_plan` states for this card, one launch per 256 output channels,
    each counted once."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(dcn_bwd, "_declare", lambda built: built)
    monkeypatch.setattr(dcn_bwd, "_multiprocessors", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=None))
    x, offset, mask, weight, dout = _operands(c=24, co=co, b=2, h=9, w=11)
    counter = types.SimpleNamespace(launches=0)
    terms = dcn_bwd._launch(kernel, None if kernel == "dx" else x, offset, mask, weight, dout,
                            counter=counter)
    widths = [256, co - 256] if co > 256 else [co]
    assert counter.launches == len(lib.calls) == len(widths)
    for (name, args), width in zip(lib.calls, widths):
        assert name == kernel
        scratch_ptr, scratch_floats = args[9], args[10]
        b, h, w, c, co_arg = args[11:16]
        assert (b, h, w, c, co_arg) == (2, 9, 11, 24, width)
        assert scratch_floats == bwd_plan(kernel, 2, 9, 11, 24, width, 132)["scratch_floats"]
        assert scratch_floats == 0 or scratch_ptr % 16 == 0
        assert args[16:19] == (27, 9, 132)               # pixel strides of offset / mask, SMs
        assert (args[0] is None) == (kernel == "dx")
    wants = {"fused": (0, 1, 2, 3), "dx": (0,), "dcoord": (1, 2), "dw": (3,)}[kernel]
    assert [i for i, t in enumerate(terms) if t is not None] == list(wants)
    if 0 in wants:
        assert float(terms[0].abs().max()) == 0.0        # dX starts at zero for the atomics


def test_library_declares_pointer_arguments(monkeypatch):
    """ctypes is told that every pointer (and the stream) is a pointer, so
    that an address is not cut to 32 bits."""
    class Fn:
        argtypes = None
        restype = None

    lib = types.SimpleNamespace(**{f"dcn_v2_bwd_{k}_launch": Fn() for k in KERNELS})
    other = types.SimpleNamespace(**{f"dcn_v2_bwd_{k}_launch": Fn() for k in KERNELS})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    dcn_bwd._library()
    dcn_bwd._declare(other)          # another build, as a comparison loads it
    for k in KERNELS:
        for built in (lib, other):
            fn = getattr(built, f"dcn_v2_bwd_{k}_launch")
            assert fn.argtypes[:10] == [ctypes.c_void_p] * 10 and fn.argtypes[-1] == ctypes.c_void_p
            assert fn.argtypes[10] == ctypes.c_longlong and fn.restype == ctypes.c_int
