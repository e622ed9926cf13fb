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
is no fallback from a CUDA tensor to the plain version. The kernels are
float32; bfloat16 operands are not built yet.

Each wrapper counts its launches in `.launches`, incremented where the kernel
is launched and nowhere else.

The coordinate gradient is the corner difference (row y0+1 minus row y0), also
at integer coordinates, where it is one-sided and not 0: a zero-initialised
offset convolution starts there. `dx` and `dweight` are sums of float atomics
on the card, so their last bits differ from run to run; `doffset` and `dmask`
are deterministic.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from centerpose_tpu_torch import _build
from centerpose_tpu_torch.ops.dcn import dcn_v2

_KERNELS = ("fused", "dx", "dcoord", "dw")


def _library() -> ctypes.CDLL:
    lib = _build.load("dcn_v2_bwd")
    for kernel in _KERNELS:
        fn = getattr(lib, f"dcn_v2_bwd_{kernel}_launch")
        if fn.argtypes is None:
            # c_void_p for every pointer and the stream: ctypes would otherwise
            # pass a Python int as a 32-bit int and cut the address.
            fn.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
    return lib


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


def _launch(kernel: str, x: Optional[torch.Tensor], offset, mask, weight, dout):
    """Check the operands, allocate the outputs of `kernel` and launch it on
    the current stream. Returns (dx, doffset, dmask, dweight), None for a term
    the kernel does not compute. `x` is None for the dX kernel, which reads
    none. `dout` is made contiguous here: it arrives from the backward of
    whatever follows the convolution, in whatever layout autograd gives it."""
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
    w_mat = weight.contiguous()                          # [9C, Co]
    dout = dout.contiguous()
    for t in (x, w_mat, dout):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: x, weight and dout must be 16-byte aligned")

    lib = _library()
    dev = dout.device
    want_dx = kernel in ("fused", "dx")
    want_dc = kernel in ("fused", "dcoord")
    want_dw = kernel in ("fused", "dw")
    # dX and dW are accumulated with atomics: they start at zero.
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev) if want_dx else None
    doffset = torch.empty((b, h, w, 18), dtype=torch.float32, device=dev) if want_dc else None
    dmask = torch.empty((b, h, w, 9), dtype=torch.float32, device=dev) if want_dc else None
    dweight = torch.zeros((3, 3, c, co), dtype=torch.float32, device=dev) if want_dw else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{who}_launch")(
            ptr(x), ptr(offset), ptr(mask), ptr(w_mat), ptr(dout),
            ptr(dx), ptr(doffset), ptr(dmask), ptr(dweight),
            b, h, w, c, co, off_stride, mask_stride, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{who}: kernel launch failed with CUDA error {err} for "
            f"dout {tuple(dout.shape)}, C={c}"
        )
    return dx, doffset, dmask, dweight


def dcn_v2_bwd_fused(x, offset, mask, weight, dout):
    """(dx, doffset, dmask, dweight) in one launch (plain version on the CPU)."""
    if _device_of("dcn_v2_bwd_fused", (x, offset, mask, weight, dout)) == "cpu":
        return _plain(x, offset, mask, weight, dout, ("x", "offset", "mask", "weight"))
    out = _launch("fused", x, offset, mask, weight, dout)
    dcn_v2_bwd_fused.launches += 1
    return out


def dcn_v2_bwd_dx(x, offset, mask, weight, dout) -> torch.Tensor:
    """dx alone. The kernel reads no x (its shape follows from the weight's);
    the plain version on the CPU differentiates through it."""
    if _device_of("dcn_v2_bwd_dx", (x, offset, mask, weight, dout)) == "cpu":
        return dcn_v2_dx_plain(x, offset, mask, weight, dout)
    if tuple(x.shape) != tuple(dout.shape[:3]) + (weight.shape[2],):
        raise ValueError(f"dcn_v2_bwd_dx: x {tuple(x.shape)} does not match dout and weight")
    out = _launch("dx", None, offset, mask, weight, dout)[0]
    dcn_v2_bwd_dx.launches += 1
    return out


def dcn_v2_bwd_dcoord(x, offset, mask, weight, dout) -> Tuple[torch.Tensor, torch.Tensor]:
    """(doffset, dmask) alone."""
    if _device_of("dcn_v2_bwd_dcoord", (x, offset, mask, weight, dout)) == "cpu":
        return dcn_v2_dcoord_plain(x, offset, mask, weight, dout)
    out = _launch("dcoord", x, offset, mask, weight, dout)[1:3]
    dcn_v2_bwd_dcoord.launches += 1
    return out


def dcn_v2_bwd_dw(x, offset, mask, weight, dout) -> torch.Tensor:
    """dweight [3, 3, C, Co] alone. The kernel reads the weight's shape only."""
    if _device_of("dcn_v2_bwd_dw", (x, offset, mask, weight, dout)) == "cpu":
        return dcn_v2_dw_plain(x, offset, mask, weight, dout)
    out = _launch("dw", x, offset, mask, weight, dout)[3]
    dcn_v2_bwd_dw.launches += 1
    return out


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
