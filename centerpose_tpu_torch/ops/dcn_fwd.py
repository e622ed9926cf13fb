"""DCNv2 forward through the hand-written CUDA kernel.

`dcn_v2_forward` is the deformable convolution every `DeformConvBlock` of the
network calls. It computes what `ops/dcn.py::dcn_v2` computes for a 3x3,
stride-1, pad-1, dilation-1 convolution, and dispatches on the device of the
tensors it is given, and on nothing else:

  * CUDA tensors launch `csrc/dcn_v2_fwd.cu` (the counterpart of the TPU
    kernel `centerpose_tpu/ops/dcn_onehot.py::_grouped_kernel`), or raise:
    unsupported type, shape or stride, a failed build and a refused launch
    are all errors. There is no fallback to the plain version.
  * CPU tensors take the plain version, `ops/dcn.py::dcn_v2`.

Only the forward pass has a kernel so far. Asked to record a gradient (an
input requires grad while grad mode is on) the CUDA path raises instead of
returning a tensor with no graph behind it; run it under `torch.no_grad()`.

`dcn_v2_forward.launches` counts kernel launches, so that a run can show it
went through the kernel. It is incremented where the kernel is launched and
nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops.dcn import dcn_v2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = _build.load("dcn_v2_fwd")
    fn = lib.dcn_v2_fwd_launch
    if fn.argtypes is None:
        # c_void_p for every pointer and the stream: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address.
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    """Stride between pixels of a [B, H, W, n] tensor whose pixels are evenly
    spaced in row-major order (a channel slice of a contiguous NHWC tensor is
    such a tensor), or raise."""
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
            f"dcn_v2_forward: {name} of shape {tuple(t.shape)} has strides "
            f"{t.stride()}; it must be NHWC with evenly spaced pixels"
        )
    return s


def kernel_weight(weight_oihw: torch.Tensor) -> torch.Tensor:
    """The [3, 3, C, Co] (HWIO) operand of `dcn_v2_forward` for a `Conv2d`-style
    [Co, C, 3, 3] weight, laid out in memory as the kernel of its type reads
    it, so that the call itself copies nothing: bfloat16 as [Co, 3, 3, C]
    (returned as an HWIO view of it), float32 as contiguous HWIO. One copy is
    made here; a module calls this once per weight, not once per forward."""
    if weight_oihw.dtype == torch.bfloat16:
        return weight_oihw.permute(0, 2, 3, 1).contiguous().permute(1, 2, 3, 0)
    return weight_oihw.permute(2, 3, 1, 0).contiguous()


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
    kernel of that type reads ([9C, Co] for float32, [Co, 9C] for bfloat16);
    the kernel allocates nothing and runs on the current stream without
    synchronising.
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
        raise RuntimeError(
            "dcn_v2_forward: the CUDA kernel has no backward pass yet; "
            "call it under torch.no_grad()"
        )
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
        w_mat = weight.contiguous()                      # [9C, Co]
    if x.data_ptr() % 16 or w_mat.data_ptr() % 16:
        raise ValueError("dcn_v2_forward: x and weight must be 16-byte aligned")

    lib = _library()
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcn_v2_fwd_launch(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w_mat.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, h, w, c, co,
            off_stride, mask_stride, _DTYPES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dcn_v2_forward: kernel launch failed with CUDA error {err} for "
            f"x {tuple(x.shape)} -> Co={co}, {x.dtype}"
        )
    dcn_v2_forward.launches += 1
    return out


dcn_v2_forward.launches = 0
