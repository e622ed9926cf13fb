"""Work counted from shapes: the network's operations per image, and the
roofline bounds of the DCN kernels.

The network's count walks the reference network (`reference/net.py`) on the
meta device at the cell's input size: every convolution, transposed
convolution and deformable product as 2 x multiply-adds (norms, activations,
the bilinear sampling and decode are not counted). It reads the same work
whatever implements the layers.

`dcn_fwd_bound_s` and `dcn_bwd_bound_s` are frozen copies of
`chip_smoke.py::{dcn_bound_ms, bwd_bound_ms}` (taken when the benchmark was
defined): the least time the card could take for one call, the larger of
operations over the peak rate of the operands' type (float32 at the 3xTF32
rate: a float32-accurate product is three TF32 products) and bytes over the
memory rate, each input read once and each output written once.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from posebench.reference import net as refnet

# Published peaks of one H100 SXM (NVIDIA data sheet, dense).
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32_3XTF32 = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12
ELEM = {"bfloat16": 2, "float32": 4}
PEAK_OF = {"bfloat16": PEAK_BF16, "float32": PEAK_F32_3XTF32}


def network_work(spec: refnet.NetSpec, input_hw) -> Tuple[float, List[Tuple[int, int, int, int]]]:
    """(operations of one image's forward, [(H, W, C, Co)] of its DCN calls)."""
    with torch.device("meta"):
        net = refnet.CenterPoseNet(spec).eval()
    total = [0.0]
    dcn_calls: List[Tuple[int, int, int, int]] = []

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, refnet.DCN):
            h, w, c, co = x.shape[2], x.shape[3], x.shape[1], out.shape[1]
            dcn_calls.append((h, w, c, co))
            total[0] += 2.0 * h * w * 9 * c * co
        elif isinstance(mod, nn.ConvTranspose2d):
            k = mod.weight.shape[2] * mod.weight.shape[3]
            total[0] += 2.0 * x.shape[2] * x.shape[3] * mod.in_channels * (mod.out_channels // mod.groups) * k
        elif isinstance(mod, nn.Conv2d):
            k = mod.weight.shape[2] * mod.weight.shape[3]
            total[0] += 2.0 * out.shape[2] * out.shape[3] * mod.out_channels * (mod.in_channels // mod.groups) * k

    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, refnet.DCN)):
            m.register_forward_hook(hook)
        if isinstance(m, refnet.DCN):
            m.shape_only = True
    h, w = input_hw
    with torch.no_grad():
        net(torch.empty(1, h, w, 3, device="meta"))
    return total[0], dcn_calls


def dcn_fwd_bound_s(b: int, h: int, w: int, c: int, co: int, dtype: str) -> float:
    """Least seconds of one DCN forward call on B images of an H x W map."""
    flops = 2.0 * b * h * w * 9 * c * co
    nbytes = ELEM[dtype] * (b * h * w * (c + 18 + 9 + co) + 9 * c * co + co)
    return max(flops / PEAK_OF[dtype], nbytes / PEAK_BYTES)


def dcn_bwd_bound_s(b: int, h: int, w: int, c: int, co: int, dtype: str = "float32") -> float:
    """Least seconds of one fused DCN backward call (dX, d_offset, d_mask
    and dW: two products), reading x, offset, mask, dout and W once and
    writing the four terms once."""
    m = b * h * w
    flops = 2 * 2.0 * m * 9 * c * co
    elems = m * (18 + 9 + co) + m * c + 9 * c * co          # offset, mask, dout; x; W
    elems += m * c + m * 18 + m * 9 + 9 * c * co            # dX, d_offset, d_mask, dW
    return max(flops / PEAK_OF[dtype], ELEM[dtype] * elems / PEAK_BYTES)
