"""Plain DCNv2 forward in PyTorch: the benchmark's frozen copy of
`centerpose_tpu_torch/ops/dcn.py`, taken when the benchmark was defined, so that a later change to the
port cannot move the yardstick. Its original docstring follows.

Modulated deformable convolution v2 (DCNv2) — the plain PyTorch version.

Counterpart of `centerpose_tpu/ops/dcn.py::dcn_v2`, with the same semantics
(the reference's CUDA im2col sampler, `DCNv2/src/cuda/dcn_v2_im2col_cuda.cu`):

  For each output pixel (h, w) and 3x3 tap t = (i, j), row-major, the input is
  sampled at  p = (h*stride - pad + i*dil + dy[t],  w*stride - pad + j*dil + dx[t])
  with bilinear interpolation; a corner outside the image counts 0 (it is not
  clamped onto the border); the sample is scaled by the post-sigmoid gate
  mask[t] and contracted against the conv weight.

  Offset channels [2t, 2t+1] are (dy, dx) of tap t; mask channel t is its gate.

This is the exact version in ordinary tensor operations: four row gathers for
the bilinear corners of every (pixel, tap), the blend in float32, then one
`[B*HW, 9C] @ [9C, Co]` product plus bias. It is what runs for a CPU tensor,
it is differentiable by autograd, and it is the version the CUDA kernel
(`ops/dcn_fwd.py`) is held against on the GPU.
"""

from __future__ import annotations

import torch


def _bilinear_gather(x_flat: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """Bilinear sample of x_flat [B, H*W, C] at float32 coords py/px [B, N].

    Corners outside the image contribute zero. Returns float32 [B, N, C].
    """
    c = x_flat.shape[-1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = py - y0
    fx = px - x0

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        idx = (yc * w + xc)[..., None].expand(-1, -1, c)
        vals = torch.gather(x_flat, 1, idx).to(torch.float32)
        return vals * (wgt * valid.to(torch.float32))[..., None]

    out = corner(y0, x0, (1 - fy) * (1 - fx))
    out = out + corner(y0, x0 + 1, (1 - fy) * fx)
    out = out + corner(y0 + 1, x0, fy * (1 - fx))
    out = out + corner(y0 + 1, x0 + 1, fy * fx)
    return out


def dcn_v2(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Modulated deformable conv v2 forward, NHWC in and out.

    Args:
      x:      [B, H, W, C]  input feature map.
      offset: [B, Ho, Wo, 2*kh*kw]  interleaved (dy, dx) per tap, row-major taps.
      mask:   [B, Ho, Wo, kh*kw]  post-sigmoid modulation gates.
      weight: [kh, kw, C, Co]  conv weight (HWIO).
      bias:   [Co].

    Returns [B, Ho, Wo, Co] in `x.dtype`. Coordinates and the bilinear blend
    are float32 whatever the operand type; the product runs in `x.dtype`.
    """
    b, h, w, c = x.shape
    kh, kw, _, co = weight.shape
    ho, wo = offset.shape[1], offset.shape[2]
    kk = kh * kw
    dtype = x.dtype
    dev = x.device

    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    ty = torch.arange(kh, dtype=torch.float32, device=dev) * dilation
    tx = torch.arange(kw, dtype=torch.float32, device=dev) * dilation

    off = offset.reshape(b, ho, wo, kk, 2).to(torch.float32)
    base_y = oy[None, :, None, None] + ty.repeat_interleave(kw)[None, None, None, :]
    base_x = ox[None, None, :, None] + tx.repeat(kh)[None, None, None, :]
    py = (base_y + off[..., 0]).reshape(b, ho * wo * kk)
    px = (base_x + off[..., 1]).reshape(b, ho * wo * kk)

    samples = _bilinear_gather(x.reshape(b, h * w, c), py, px, h, w)
    samples = samples.reshape(b, ho * wo, kk, c)
    samples = samples * mask.reshape(b, ho * wo, kk, 1).to(torch.float32)

    # One product: [B*N, kk*C] @ [kk*C, Co]; weight rows are tap-major, then C.
    cols = samples.reshape(b * ho * wo, kk * c).to(dtype)
    w_mat = weight.reshape(kk * c, co).to(dtype)
    out = (cols @ w_mat).to(torch.float32) + bias.to(torch.float32)
    return out.to(dtype).reshape(b, ho, wo, co)
