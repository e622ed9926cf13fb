"""DCNv2 backward: the five cotangents through the hand-written CUDA kernels.

Counterpart of `centerpose_tpu/ops/dcn_bwd.py`. For the 3x3 / stride 1 / pad 1
/ dilation 1 deformable convolution of `ops/dcn.py::dcn_v2` and a cotangent
`dout` of its output, `dcn_v2_grads` returns `(dx, doffset, dmask, dweight,
dbias)`. Four kernels of `csrc/dcn_v2_bwd.cu`, one for each TPU kernel:

  dcn_v2_bwd_fused   (`_fused_kernel`)   dx, doffset, dmask, dweight in one launch
  dcn_v2_bwd_dx      (`_dx_kernel`)      dx alone; reads no x
  dcn_v2_bwd_dcoord  (`_dcoord_kernel`)  doffset and dmask alone
  dcn_v2_bwd_dw      (`_dw_kernel`)      dweight alone

`dbias = sum(dout)` is outside every kernel, as in the JAX package, and is a
`torch.sum`. Every wrapper dispatches on the device of its tensors and on
nothing else: CUDA tensors launch the kernel or raise (unsupported type,
shape or stride, a failed build, a refused launch); CPU tensors take the plain
version beside it (`dcn_v2_*_plain`: `torch.autograd.grad` of `dcn_v2`). There
is no fallback from a CUDA tensor to the plain version. The kernels take
float32 operands; bfloat16 operands are not built yet.

Each wrapper counts its launches in `.launches`, incremented where the kernel
is launched and nowhere else.

The coordinate gradient is the corner difference (row y0+1 minus row y0), also
at integer coordinates, where it is one-sided and not 0: a zero-initialised
offset convolution starts there. On the card both products run on the tensor
cores in 3xTF32 (`split_tf32` is that split, in torch, for the tests), dX is a
sum of float atomics, so its last bits differ from run to run, and `dweight`,
`doffset` and `dmask` are sums of per-block partials in a fixed order: the
same bits in every run. `bwd_plan` states, per call, the tiling and the
scratch memory the kernels use; the wrapper allocates that scratch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops.dcn import dcn_v2

_KERNELS = ("fused", "dx", "dcoord", "dw")

# The kernels' tiling (`csrc/dcn_v2_bwd.cu`, `make_plan`): 64-pixel tiles, 64
# input channels per chunk, at most 256 output channels per launch (the
# wrapper splits a wider Co), at most SCRATCH_CAP bytes of dW partials.
BWD_BLOCK_M = 64
BWD_CHUNK = 64
BWD_MAX_CO = 256
BWD_SCRATCH_CAP = 16 << 20
SM_SHARED_BYTES = 228 * 1024      # an H100 SM's shared memory
BLOCK_RESERVED_BYTES = 1024       # kept by the SM for each resident block
H100_SMS = 132
_TAPS = 9
_PLAN_KEYS = ("block_m", "tiles", "slabs", "grid_x", "grid_y", "grid_z", "chunks_per_block",
              "co_tiles", "smem_bytes", "blocks_per_sm", "scratch_floats")


@functools.lru_cache(maxsize=None)
def _bwd_plan(kernel: str, b: int, h: int, w: int, c: int, co: int, sms: int) -> tuple:
    m = b * h * w
    chunks = -(-c // BWD_CHUNK)
    tiles = -(-m // BWD_BLOCK_M)
    nco = 1 if co <= 64 else 2 if co <= 128 else 4
    gs, dcoord, dw = kernel != "dw", kernel in ("fused", "dcoord"), kernel in ("fused", "dw")
    # Without dW nothing is accumulated over a slab: a block takes every chunk.
    nch = chunks if not dw else 2 if nco == 1 and chunks >= 2 else 1
    groups = -(-chunks // nch)
    smem = 4 * (2 * BWD_BLOCK_M * 64 * nco + (2 if dw else 1) * BWD_BLOCK_M * BWD_CHUNK) + BWD_BLOCK_M * 24
    per_sm = min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                 (3 if nco == 1 else 2) if not dw else 1 if nch * nco > 2 else 2)
    slots = sms * per_sm
    wsize = _TAPS * c * co
    best, slabs = None, 1
    for s in range(1, tiles + 1):
        if dw and s > 1 and s * wsize * 4 > BWD_SCRATCH_CAP:
            break
        cost = -(-(s * _TAPS * groups) // slots) * (-(-tiles // s) + 1)
        if best is None or cost < best:
            best, slabs = cost, s
    scratch = ((2 * wsize if gs else 0) + (slabs * wsize if dw and slabs > 1 else 0)
               + (groups * m * 3 * _TAPS if dcoord and groups > 1 else 0))
    return (BWD_BLOCK_M, tiles, slabs, slabs, _TAPS, groups, nch, nco, smem, per_sm, scratch)


def bwd_plan(kernel: str, b: int, h: int, w: int, c: int, co: int, sms: int = H100_SMS) -> dict:
    """Tiling, grid, shared memory and scratch of one launch of the backward
    kernel `kernel` ("fused", "dx", "dcoord", "dw"), as `csrc/dcn_v2_bwd.cu`
    chooses them for a card with `sms` multiprocessors (C, Co multiples of 8,
    Co <= 256). A block owns one tap, `chunks_per_block` chunks of 64 input
    channels and a slab of consecutive 64-pixel tiles; grid = (slabs, 9 taps,
    channel groups). `scratch_floats` = the weight's 3xTF32 fragment copy
    (2 x 9C x Co, kernels with a gs product) + dW partials (slabs x 9C x Co
    where slabs > 1) + coordinate partials (groups x M x 27 where groups >
    1). `blocks_per_sm` is what the slab count was chosen for."""
    if kernel not in _KERNELS:
        raise ValueError(f"unknown backward kernel {kernel!r}")
    if c % 8 or co % 8 or not 0 < co <= BWD_MAX_CO or b * h * w <= 0:
        raise ValueError(f"bwd_plan: unsupported C={c}, Co={co}, B*H*W={b * h * w}")
    plan = dict(zip(_PLAN_KEYS, _bwd_plan(kernel, b, h, w, c, co, sms)))
    wsize = _TAPS * c * co
    plan["dw_partial_bytes"] = 4 * wsize * plan["slabs"] if plan["slabs"] > 1 and kernel in ("fused", "dw") else 0
    plan["coord_partial_bytes"] = (4 * plan["grid_z"] * b * h * w * 3 * _TAPS
                                   if plan["grid_z"] > 1 and kernel in ("fused", "dcoord") else 0)
    return plan


def kernel_bwd_plan(kernel: str, b: int, h: int, w: int, c: int, co: int, sms: int,
                    lib: Optional[ctypes.CDLL] = None) -> dict:
    """The plan the built source reports (the keys of `bwd_plan` that it
    states); raises for a shape it does not take."""
    lib = lib if lib is not None else _library()
    fn = lib.dcn_v2_bwd_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    if fn(_KERNELS.index(kernel), b, h, w, c, co, sms, out) != 0:
        raise ValueError(f"dcn_v2_bwd_{kernel}: the kernel does not take {(b, h, w, c, co)}")
    return dict(zip(_PLAN_KEYS, (int(v) for v in out)))


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 `t` as the kernels split an operand for 3xTF32:
    hi = t rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as `cvt.rna.tf32.f32`), lo = (t - hi) rounded the same way. Infinity
    and NaN are kept in hi (lo is then NaN); a value within half a TF32 step
    of the largest float rounds to infinity, as rounding to nearest does."""
    def rna(v):
        u = v.contiguous().view(torch.int32)
        special = (u & 0x7F800000) == 0x7F800000
        r = torch.where(special, u, (u + 0x1000) & -0x2000)   # -0x2000 == 0xffffe000
        return r.view(torch.float32)

    if t.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {t.dtype}")
    hi = rna(t)
    return hi, rna(t - hi)


def _library() -> ctypes.CDLL:
    return _declare(_build.load("dcn_v2_bwd"))


def _declare(lib):
    """Declares the C signatures of a built backward source's entry points."""
    for kernel in _KERNELS:
        fn = getattr(lib, f"dcn_v2_bwd_{kernel}_launch")
        if fn.argtypes is None:
            # c_void_p for every pointer and the stream: ctypes would otherwise
            # pass a Python int as a 32-bit int and cut the address.
            fn.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pixel_stride(t: torch.Tensor, name: str, who: str) -> int:
    """Stride between pixels of a [B, H, W, n] tensor whose pixels are evenly
    spaced in row-major order (a channel slice of a contiguous NHWC tensor is
    such a tensor), or raise in the name of the wrapper `who`."""
    b, h, w, n = t.shape
    if w > 1:
        s = t.stride(2)
    elif h > 1:
        s = t.stride(1)
    elif b > 1:
        s = t.stride(0)
    else:
        s = n
    ok = (
        (n == 1 or t.stride(3) == 1)
        and s >= n
        and (h == 1 or t.stride(1) == w * s)
        and (b == 1 or t.stride(0) == h * w * s)
    )
    if not ok:
        raise ValueError(
            f"{who}: {name} of shape {tuple(t.shape)} has strides "
            f"{t.stride()}; it must be NHWC with evenly spaced pixels"
        )
    return s


# ------------------------------------------------------------ plain versions
def _plain(x, offset, mask, weight, dout, wrt: Sequence[str]):
    """Cotangents of `dcn_v2` for the operands named in `wrt`, by autograd."""
    named = {"x": x, "offset": offset, "mask": mask, "weight": weight}
    leaves = {k: v.detach().requires_grad_(k in wrt) for k, v in named.items()}
    bias = torch.zeros(weight.shape[3], dtype=x.dtype, device=x.device)
    with torch.enable_grad():
        out = dcn_v2(leaves["x"], leaves["offset"], leaves["mask"], leaves["weight"], bias)
        grads = torch.autograd.grad(out, [leaves[k] for k in wrt], dout)
    return tuple(g.contiguous() for g in grads)


def dcn_v2_dx_plain(x, offset, mask, weight, dout) -> torch.Tensor:
    """dX [B, H, W, C]: each sample's m * (W_t . dout) spread to its corners."""
    return _plain(x, offset, mask, weight, dout, ("x",))[0]


def dcn_v2_dcoord_plain(x, offset, mask, weight, dout) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_offset [B, H, W, 18] interleaved (dy, dx), d_mask [B, H, W, 9])."""
    return _plain(x, offset, mask, weight, dout, ("offset", "mask"))


def dcn_v2_dw_plain(x, offset, mask, weight, dout) -> torch.Tensor:
    """dW [3, 3, C, Co]: modulated samples (x) dout, summed over all pixels."""
    return _plain(x, offset, mask, weight, dout, ("weight",))[0]


def dcn_v2_grads_plain(x, offset, mask, weight, bias, dout):
    """(dx, doffset, dmask, dweight, dbias) of `dcn_v2` by autograd: what runs
    for CPU tensors and what the kernels are held against on the card."""
    grads = _plain(x, offset, mask, weight, dout, ("x", "offset", "mask", "weight"))
    return grads + (dout.sum(dim=(0, 1, 2)).to(bias.dtype),)


# ------------------------------------------------------------------ kernels
def _device_of(who: str, tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{who}: operands on different devices: {devices}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device type {kind!r}")
    return kind


def _launch(kernel: str, x: Optional[torch.Tensor], offset, mask, weight, dout,
            counter=None, lib: Optional[ctypes.CDLL] = None):
    """Check the operands, allocate the outputs of `kernel` and the scratch its
    plan states, and launch it on the current stream (once per 256 output
    channels), adding one to `counter.launches` for each launch. Returns
    (dx, doffset, dmask, dweight), None for a term the kernel does not
    compute. `x` is None for the dX kernel, which reads none. `dout` is made
    contiguous here: it arrives from the backward of whatever follows the
    convolution, in whatever layout autograd gives it. `lib` is another build
    of the source with the same C interface (for comparisons)."""
    who = f"dcn_v2_bwd_{kernel}"
    tensors = [t for t in (x, offset, mask, weight, dout) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            f"{who}: the backward kernels are float32, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if weight.dim() != 4 or tuple(weight.shape[:2]) != (3, 3) or dout.dim() != 4:
        raise ValueError(
            f"{who}: weight {tuple(weight.shape)} / dout {tuple(dout.shape)}: "
            "expected [3,3,C,Co] and [B,H,W,Co]"
        )
    c, co = weight.shape[2], weight.shape[3]
    b, h, w = dout.shape[:3]
    if dout.shape[3] != co:
        raise ValueError(f"{who}: dout has {dout.shape[3]} channels, the weight {co}")
    if x is not None and tuple(x.shape) != (b, h, w, c):
        raise ValueError(f"{who}: x {tuple(x.shape)}, expected {(b, h, w, c)}")
    if tuple(offset.shape) != (b, h, w, 18) or tuple(mask.shape) != (b, h, w, 9):
        raise ValueError(
            f"{who}: offset {tuple(offset.shape)} / mask {tuple(mask.shape)}: "
            f"expected {(b, h, w, 18)} and {(b, h, w, 9)}"
        )
    if c % 8 or co % 8:
        raise ValueError(f"{who}: C={c} and Co={co} must be multiples of 8")
    if b * h * w == 0 or b * h * w >= 2 ** 31:
        raise ValueError(f"{who}: unsupported size B*H*W={b * h * w}")
    if x is not None and not x.is_contiguous():
        raise ValueError(f"{who}: x must be contiguous")
    off_stride = pixel_stride(offset, "offset", who)
    mask_stride = pixel_stride(mask, "mask", who)
    w_mat = weight.contiguous().view(9 * c, co)           # [9C, Co]
    dout = dout.contiguous()
    for t in (x, w_mat, dout):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: x, weight and dout must be 16-byte aligned")

    mirror = lib is None          # this checkout's build: the plan is bwd_plan's
    lib = _library() if mirror else _declare(lib)
    fn = getattr(lib, f"{who}_launch")
    dev = dout.device
    sms = _multiprocessors(dev.index if dev.index is not None else torch.cuda.current_device())
    want_dx = kernel in ("fused", "dx")
    want_dc = kernel in ("fused", "dcoord")
    want_dw = kernel in ("fused", "dw")
    # dX is accumulated with atomics: it starts at zero. The kernels write
    # every element of the other terms.
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev) if want_dx else None
    doffset = torch.empty((b, h, w, 18), dtype=torch.float32, device=dev) if want_dc else None
    dmask = torch.empty((b, h, w, 9), dtype=torch.float32, device=dev) if want_dc else None
    dweight = torch.empty((3, 3, c, co), dtype=torch.float32, device=dev) if want_dw else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    # Each launch takes at most BWD_MAX_CO output channels. A wider Co is cut
    # into slices: dX adds up in place, the coordinate terms are summed here,
    # dW is put together slice by slice.
    for lo in range(0, co, BWD_MAX_CO):
        hi = min(co, lo + BWD_MAX_CO)
        part = lo > 0 or hi < co
        d_s = dout[..., lo:hi].contiguous() if part else dout
        w_s = w_mat[:, lo:hi].contiguous() if part else w_mat
        off_s = torch.empty_like(doffset) if want_dc and lo > 0 else doffset
        mask_s = torch.empty_like(dmask) if want_dc and lo > 0 else dmask
        dw_s = (torch.empty((9 * c, hi - lo), dtype=torch.float32, device=dev)
                if want_dw and part else dweight)
        plan = (bwd_plan(kernel, b, h, w, c, hi - lo, sms) if mirror
                else kernel_bwd_plan(kernel, b, h, w, c, hi - lo, sms, lib))
        scratch = torch.empty((plan["scratch_floats"],), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(
                ptr(x), ptr(offset), ptr(mask), ptr(w_s), ptr(d_s),
                ptr(dx), ptr(off_s), ptr(mask_s), ptr(dw_s), ptr(scratch), scratch.numel(),
                b, h, w, c, hi - lo, off_stride, mask_stride, sms, stream,
            )
        if err != 0:
            raise RuntimeError(
                f"{who}: kernel launch failed with CUDA error {err} for "
                f"dout {tuple(dout.shape)}, C={c}"
            )
        if counter is not None:
            counter.launches += 1
        if want_dc and lo > 0:
            doffset += off_s
            dmask += mask_s
        if want_dw and part:
            dweight.view(9 * c, co)[:, lo:hi] = dw_s
    return dx, doffset, dmask, dweight


def dcn_v2_bwd_fused(x, offset, mask, weight, dout):
    """(dx, doffset, dmask, dweight) in one launch (plain version on the CPU)."""
    if _device_of("dcn_v2_bwd_fused", (x, offset, mask, weight, dout)) == "cpu":
        return _plain(x, offset, mask, weight, dout, ("x", "offset", "mask", "weight"))
    return _launch("fused", x, offset, mask, weight, dout, counter=dcn_v2_bwd_fused)


def dcn_v2_bwd_dx(x, offset, mask, weight, dout) -> torch.Tensor:
    """dx alone. The kernel reads no x (its shape follows from the weight's);
    the plain version on the CPU differentiates through it."""
    if _device_of("dcn_v2_bwd_dx", (x, offset, mask, weight, dout)) == "cpu":
        return dcn_v2_dx_plain(x, offset, mask, weight, dout)
    if tuple(x.shape) != tuple(dout.shape[:3]) + (weight.shape[2],):
        raise ValueError(f"dcn_v2_bwd_dx: x {tuple(x.shape)} does not match dout and weight")
    return _launch("dx", None, offset, mask, weight, dout, counter=dcn_v2_bwd_dx)[0]


def dcn_v2_bwd_dcoord(x, offset, mask, weight, dout) -> Tuple[torch.Tensor, torch.Tensor]:
    """(doffset, dmask) alone."""
    if _device_of("dcn_v2_bwd_dcoord", (x, offset, mask, weight, dout)) == "cpu":
        return dcn_v2_dcoord_plain(x, offset, mask, weight, dout)
    return _launch("dcoord", x, offset, mask, weight, dout, counter=dcn_v2_bwd_dcoord)[1:3]


def dcn_v2_bwd_dw(x, offset, mask, weight, dout) -> torch.Tensor:
    """dweight [3, 3, C, Co] alone. The kernel reads the weight's shape only."""
    if _device_of("dcn_v2_bwd_dw", (x, offset, mask, weight, dout)) == "cpu":
        return dcn_v2_dw_plain(x, offset, mask, weight, dout)
    return _launch("dw", x, offset, mask, weight, dout, counter=dcn_v2_bwd_dw)[3]


for _fn in (dcn_v2_bwd_fused, dcn_v2_bwd_dx, dcn_v2_bwd_dcoord, dcn_v2_bwd_dw):
    _fn.launches = 0


def dcn_v2_grads(x, offset, mask, weight, bias, dout, *, fused: bool = True):
    """All five DCNv2 cotangents.

    Args as `ops/dcn.py::dcn_v2` (3x3, stride 1, pad 1, dilation 1): x
    [B, H, W, C] contiguous; offset [B, H, W, 18] and mask [B, H, W, 9], each
    possibly a channel slice of a wider contiguous NHWC tensor; weight
    [3, 3, C, Co] in any memory layout (copied to [9C, Co] if need be); bias
    [Co]; `dout` [B, H, W, Co], the cotangent of the output, in any layout.
    `fused=True` is one launch of the fused kernel, `fused=False` the dX,
    coordinate and dW kernels one after the other. Returns (dx, doffset,
    dmask, dweight, dbias) in the primal types, each contiguous.
    """
    if fused:
        dx, doffset, dmask, dweight = dcn_v2_bwd_fused(x, offset, mask, weight, dout)
    else:
        dx = dcn_v2_bwd_dx(x, offset, mask, weight, dout)
        doffset, dmask = dcn_v2_bwd_dcoord(x, offset, mask, weight, dout)
        dweight = dcn_v2_bwd_dw(x, offset, mask, weight, dout)
    dbias = dout.sum(dim=(0, 1, 2)).to(bias.dtype)
    return dx, doffset, dmask, dweight, dbias
