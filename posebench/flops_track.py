"""Work of the tracking network counted from shapes: the operations of one
frame's forward of `reference/track_net.py` at the cell's input size,
walked on the meta device with its previous-frame inputs, under the rules
of `posebench/flops.py::network_work`: every convolution (the stem and the
three previous-frame stems among them), transposed convolution and
deformable product as 2 x multiply-adds; norms, activations, the bilinear
sampling, the render and decode are not counted.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from posebench.reference import net as refnet
from posebench.reference import track_net


def network_work(spec: track_net.TrackSpec, input_hw) -> Tuple[float, List[Tuple[int, int, int, int]]]:
    """(operations of one frame's forward, [(H, W, C, Co)] of its DCN calls)."""
    with torch.device("meta"):
        net = track_net.TrackNet(spec).eval()
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
        net(*(torch.empty(1, h, w, c, device="meta") for c in (3, 3, 1, track_net.NUM_JOINTS)))
    return total[0], dcn_calls
