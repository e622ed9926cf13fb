"""DCNv2 forward through the hand-written CUDA kernel.

`dcn_v2_forward` is the deformable convolution every `DeformConvBlock` of the
network calls. It computes what `ops/dcn.py::dcn_v2` computes for a 3x3,
stride-1, pad-1, dilation-1 convolution, and dispatches on the device of the
tensors it is given, and on nothing else:

  * CUDA tensors launch `csrc/dcn_v2_fwd.cu` (the counterpart of the TPU
    kernels `centerpose_tpu/ops/dcn_onehot.py::_grouped_kernel` and, on the
    tracking path, `_row_kernel`), or raise: unsupported type, shape or
    stride, a failed build and a refused launch are all errors. There is no
    fallback to the plain version.
  * CPU tensors take the plain version, `ops/dcn.py::dcn_v2`.

Two bodies: bfloat16 (`dcn_v2_fwd_launch`, tiling `bf16_plan`) and float32
(`dcn_v2_fwd_f32_launch`, tiling `f32_plan`), both `wgmma` from swizzled
shared memory; the float32 one in 3xTF32 (every operand split into TF32 hi
and lo parts, `ops/dcn_bwd.py::split_tf32`, three products), with the K loop
split over blocks where the grid is small. Its scratch (a K-major hi/lo copy
of the weight, and the partial sums of a split K loop) is allocated here, at
the sizes `f32_plan` states. Its output is the same bits in every call.

It is differentiable on both devices. On the CPU ordinary autograd goes
through the plain version. On CUDA, when a gradient is being recorded (an
operand requires grad while grad mode is on), the call goes through
`DCNv2Function`: forward = the forward kernel, backward = the backward kernels
of `ops/dcn_bwd.py` (`csrc/dcn_v2_bwd.cu`). Under `torch.no_grad()` the kernel
is launched directly and nothing is saved.

`dcn_v2_forward.launches` counts kernel launches, so that a run can show it
went through the kernel, `dcn_v2_forward.launches_bf16` those of the bf16
body and `dcn_v2_forward.launches_by_shape` all of them by (H, C, Co) (a
`Counter`). All are incremented where the kernel is launched and nowhere
else.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops import dcn_bwd
from centerpose_tpu_torch.ops.dcn import dcn_v2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernel's tiling (`csrc/dcn_v2_fwd.cu`, `dcn_v2_fwd_bf16_plan`):
# 64 output pixels per block, a ring of 3 (column, weight) stages of 64 input
# channels, 128-byte rows.
BF16_BLOCK_M = 64
BF16_STAGES = 3
_TAPS = 9

# The float32 kernel's tiling (`dcn_v2_fwd_f32_plan`): 64 output pixels per
# block, steps of 32 input channels (one 128-byte row of floats), a ring of 2
# stages of hi and lo tiles (two blocks per SM), a K loop split into ranges of
# at least 4 steps where the grid is below one wave of an H100's 132 SMs.
F32_BLOCK_M = 64
F32_BK = 32
F32_STAGES = 2
F32_BLOCKS_PER_SM = 2
F32_MIN_RANGE = 4
F32_SMS = 132
_ROW_BYTES = 128
_F32_PLAN_KEYS = ("block_m", "block_n", "grid", "split", "smem_bytes", "stages",
                  "blocks_per_sm", "scratch_bytes")


def bf16_plan(b: int, h: int, w: int, c: int, co: int) -> dict:
    """Tile, grid and dynamic shared memory of the bf16 kernel for one call,
    as `dcn_v2_fwd_launch` chooses them: a block owns 64 pixels and 64
    output channels where Co <= 64, else 128."""
    bn = 64 if co <= 64 else 128
    m = b * h * w
    stage = (BF16_BLOCK_M + bn) * 128                       # column + weight tile
    tables = _TAPS * BF16_BLOCK_M * 32                       # corner indices + weights
    return {
        "block_m": BF16_BLOCK_M, "block_n": bn,
        "grid": [-(-m // BF16_BLOCK_M), -(-co // bn)],
        "smem_bytes": 1024 + BF16_STAGES * stage + tables, "stages": BF16_STAGES,
    }


def kernel_bf16_plan(b: int, h: int, w: int, c: int, co: int) -> dict:
    """The plan the built kernel reports for one call (the keys of
    `bf16_plan`); raises for a shape it does not take."""
    fn = _library().dcn_v2_fwd_bf16_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_int * 6)()
    if fn(b, h, w, c, co, plan) != 0:
        raise ValueError(f"dcn_v2_forward: the bf16 kernel does not take {(b, h, w, c, co)}")
    return {"block_m": plan[0], "block_n": plan[1], "grid": [plan[2], plan[3]],
            "smem_bytes": plan[4], "stages": plan[5]}


def f32_plan(b: int, h: int, w: int, c: int, co: int) -> dict:
    """Tile, grid, split of the K loop, shared memory and scratch of the
    float32 kernel for one call, as `dcn_v2_fwd_f32_launch` chooses them.

    A block owns 64 pixels and 64 output channels where Co <= 64, else 128,
    and `split` ranges of the n = 9 * ceil(C / 32) steps (chunk-major: the 9
    taps of one 32-channel chunk, then the next chunk), range z = steps
    [n z / split, n (z + 1) / split) (grid z). `split` > 1 only where pixel
    tiles x channel tiles are fewer than 132 blocks: enough ranges for one
    wave, each of at least 4 steps. `smem_bytes` = 1024 (alignment) + 2
    stages of column and weight tiles, hi and lo, + the corner tables (one
    index and four weights per (tap, pixel)); `blocks_per_sm` is the
    kernel's launch bound. `scratch_bytes`
    = the weight's hi/lo copy [2, Co, 9C] + the partials [split, M, Co]
    where split > 1, float32."""
    m = b * h * w
    if c <= 0 or co <= 0 or c % 8 or co % 8 or m <= 0 or m + 2 * w + 2 >= 2 ** 31:
        raise ValueError(f"f32_plan: unsupported C={c}, Co={co}, B*H*W={m}")
    bn = 64 if co <= 64 else 128
    gx, gy = -(-m // F32_BLOCK_M), -(-co // bn)
    steps = _TAPS * -(-c // F32_BK)
    split = 1
    if gx * gy < F32_SMS:
        split = max(1, min(-(-F32_SMS // (gx * gy)), steps // F32_MIN_RANGE))
    stage = 2 * (F32_BLOCK_M + bn) * _ROW_BYTES                 # hi + lo of both tiles
    tables = _TAPS * F32_BLOCK_M * 20                          # one corner index + 4 weights
    scratch = 4 * (2 * _TAPS * c * co + (split * m * co if split > 1 else 0))
    return dict(zip(_F32_PLAN_KEYS, (
        F32_BLOCK_M, bn, [gx, gy], split, 1024 + F32_STAGES * stage + tables, F32_STAGES,
        F32_BLOCKS_PER_SM, scratch)))


def kernel_f32_plan(b: int, h: int, w: int, c: int, co: int, lib=None) -> dict:
    """The plan the built float32 kernel reports for one call (the keys of
    `f32_plan`), of this checkout's build or of `lib`; raises for a shape it
    does not take."""
    lib = lib if lib is not None else _library()
    fn = lib.dcn_v2_fwd_f32_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_longlong * 9)()
    if fn(b, h, w, c, co, plan) != 0:
        raise ValueError(f"dcn_v2_forward: the float32 kernel does not take {(b, h, w, c, co)}")
    v = [int(x) for x in plan]
    return dict(zip(_F32_PLAN_KEYS, v[:2] + [[v[2], v[3]]] + v[4:]))


def _library() -> ctypes.CDLL:
    return _declare(_build.load("dcn_v2_fwd"))


def _declare(lib):
    """Declares the C signatures of a built forward source's launch entries
    (c_void_p for every pointer and the stream: ctypes would otherwise pass a
    Python int as a 32-bit int and cut the address)."""
    fn = lib.dcn_v2_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    fn = lib.dcn_v2_fwd_f32_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    return dcn_bwd.pixel_stride(t, name, "dcn_v2_forward")


def kernel_weight(weight_oihw: torch.Tensor) -> torch.Tensor:
    """The [3, 3, C, Co] (HWIO) operand of `dcn_v2_forward` for a `Conv2d`-style
    [Co, C, 3, 3] weight, laid out in memory as the kernel of its type reads
    it, so that the call itself copies nothing: bfloat16 as [Co, 3, 3, C]
    (returned as an HWIO view of it), float32 as contiguous HWIO. One copy is
    made here; a module calls this once per weight, not once per forward."""
    if weight_oihw.dtype == torch.bfloat16:
        return weight_oihw.permute(0, 2, 3, 1).contiguous().permute(1, 2, 3, 0)
    return weight_oihw.permute(2, 3, 1, 0).contiguous()


def _launch_forward(x, offset, mask, weight, bias, lib=None) -> torch.Tensor:
    """Check the CUDA operands, allocate the output (and, for float32, the
    scratch its plan states) and launch the forward kernel on the current
    stream. `lib` is another build of the source with the same C interface
    (for comparisons): its plan is its own, and its launches are not
    counted."""
    tensors = (x, offset, mask, weight, bias)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(
            "dcn_v2_forward: operands must all be float32 or all bfloat16, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[:2]) != (3, 3):
        raise ValueError(
            f"dcn_v2_forward: x {tuple(x.shape)} / weight {tuple(weight.shape)}: "
            "expected [B,H,W,C] and [3,3,C,Co]"
        )
    b, h, w, c = x.shape
    co = weight.shape[3]
    if weight.shape[2] != c or tuple(bias.shape) != (co,):
        raise ValueError("dcn_v2_forward: weight/bias do not match x's channels")
    if tuple(offset.shape) != (b, h, w, 18) or tuple(mask.shape) != (b, h, w, 9):
        raise ValueError(
            f"dcn_v2_forward: offset {tuple(offset.shape)} / mask "
            f"{tuple(mask.shape)}: expected {(b, h, w, 18)} and {(b, h, w, 9)}"
        )
    if c % 8 or co % 8:
        raise ValueError(f"dcn_v2_forward: C={c} and Co={co} must be multiples of 8")
    if b * h * w == 0 or b * h * w >= 2 ** 31:
        raise ValueError(f"dcn_v2_forward: unsupported size B*H*W={b * h * w}")
    if not (x.is_contiguous() and bias.is_contiguous()):
        raise ValueError("dcn_v2_forward: x and bias must be contiguous")
    off_stride = _pixel_stride(offset, "offset")
    mask_stride = _pixel_stride(mask, "mask")

    if x.dtype == torch.bfloat16:
        # The tensor-core kernel reads the weight as [Co, 9C]: no copy where
        # the caller already holds it so (`kernel_weight`).
        w_mat = weight.permute(3, 0, 1, 2).contiguous()
    else:
        # [9C, Co], as the caller holds it; the call makes its own K-major
        # hi/lo copy in the scratch below.
        w_mat = weight.contiguous()
        plan = f32_plan(b, h, w, c, co)
    if x.data_ptr() % 16 or w_mat.data_ptr() % 16:
        raise ValueError("dcn_v2_forward: x and weight must be 16-byte aligned")

    mine = lib is None
    lib = _library() if mine else _declare(lib)
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            err = lib.dcn_v2_fwd_launch(
                x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w_mat.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, h, w, c, co,
                off_stride, mask_stride, _DTYPES[x.dtype], stream,
            )
        else:
            if not mine:
                plan = kernel_f32_plan(b, h, w, c, co, lib)
            w_split = torch.empty((2, co, _TAPS * c), dtype=torch.float32, device=x.device)
            n_part = plan["scratch_bytes"] // 4 - w_split.numel()
            partials = torch.empty((n_part,), dtype=torch.float32, device=x.device)
            err = lib.dcn_v2_fwd_f32_launch(
                x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w_mat.data_ptr(),
                bias.data_ptr(), out.data_ptr(), w_split.data_ptr(),
                partials.data_ptr() if n_part else None, n_part, b, h, w, c, co,
                off_stride, mask_stride, stream,
            )
    if err != 0:
        raise RuntimeError(
            f"dcn_v2_forward: kernel launch failed with CUDA error {err} for "
            f"x {tuple(x.shape)} -> Co={co}, {x.dtype}"
        )
    if mine:
        dcn_v2_forward.launches += 1
        dcn_v2_forward.launches_by_shape[(h, c, co)] += 1
        if x.dtype == torch.bfloat16:
            dcn_v2_forward.launches_bf16 += 1
    return out


class DCNv2Function(torch.autograd.Function):
    """The deformable convolution on CUDA tensors with its gradient: forward
    is the forward kernel, backward the backward kernels. Only the four
    operands are saved (no im2col matrix); `weight` is the HWIO tensor the
    caller passed (a permuted view of an OIHW parameter is fine: autograd
    carries the permute, the kernels read a [9C, Co] copy)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias):
        out = _launch_forward(x, offset, mask, weight, bias)
        ctx.save_for_backward(x, offset, mask, weight)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x, offset, mask, weight = ctx.saved_tensors
        need_x, need_off, need_mask, need_w, need_b = ctx.needs_input_grad
        dx = doffset = dmask = dweight = dbias = None
        if need_x and need_w and (need_off or need_mask):
            dx, doffset, dmask, dweight = dcn_bwd.dcn_v2_bwd_fused(x, offset, mask, weight, dout)
        else:
            # A frozen operand: only the kernels whose terms are asked for.
            if need_x:
                dx = dcn_bwd.dcn_v2_bwd_dx(x, offset, mask, weight, dout)
            if need_off or need_mask:
                doffset, dmask = dcn_bwd.dcn_v2_bwd_dcoord(x, offset, mask, weight, dout)
            if need_w:
                dweight = dcn_bwd.dcn_v2_bwd_dw(x, offset, mask, weight, dout)
        if need_b:
            dbias = dout.to(torch.float32).sum(dim=(0, 1, 2)).to(dout.dtype)
        return (
            dx,
            doffset if need_off else None,
            dmask if need_mask else None,
            dweight,
            dbias,
        )


def dcn_v2_forward(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """DCNv2 forward, 3x3 / stride 1 / pad 1 / dilation 1, NHWC.

    Args:
      x:      [B, H, W, C] contiguous.
      offset: [B, H, W, 18], channels [2t, 2t+1] = (dy, dx) of tap t; may be
              a channel slice of a wider contiguous NHWC tensor.
      mask:   [B, H, W, 9] post-sigmoid gates; may be such a slice too.
      weight: [3, 3, C, Co] (HWIO), contiguous or a view of a contiguous
              [Co, 3, 3, C] tensor (see `kernel_weight`).
      bias:   [Co].

    Returns [B, H, W, Co] in `x.dtype`. On CUDA: float32 or bfloat16, all
    operands of one type, C and Co multiples of 8. The output is allocated
    here, and a copy of the weight where its memory layout is not the one the
    kernel of that type reads ([9C, Co] for float32, [Co, 9C] for bfloat16),
    and for float32 the scratch of `f32_plan`; the kernel allocates nothing
    and runs on the current stream without synchronising. Where a gradient
    is recorded the result carries a graph whose backward is the backward
    kernels, which take both types: bfloat16 operands (the mixed-precision
    train step's) give bf16 products summed in float32, and every gradient
    in the type of its operand.
    """
    tensors = (x, offset, mask, weight, bias)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"dcn_v2_forward: operands on different devices: {devices}")
    if x.device.type == "cpu":
        return dcn_v2(x, offset, mask, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"dcn_v2_forward: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return DCNv2Function.apply(x, offset, mask, weight, bias)
    return _launch_forward(x, offset, mask, weight, bias)


dcn_v2_forward.launches = 0
dcn_v2_forward.launches_bf16 = 0
dcn_v2_forward.launches_by_shape = collections.Counter()
