"""Weights of a cell, made on the device from the run's seed.

The recipe is a frozen copy of `chip_smoke.py::{track_weights,
randomize_offset_convs}` (taken when the benchmark was defined), adapted to
the image model's heads and drawn from one `torch.Generator` on the
device in one call:

- every convolution and DCN weight normal with variance `GAIN`^2 x 2 /
  fan_in, `GAIN` 0.8: below He's value the network is ordered, so that a
  rounding in one layer does not grow layer by layer (at He's value the
  float32 and bf16 networks' heatmaps differ by 60 % of their range at
  256x256, at 0.8 by 1.7 %), and above 0.7 the heatmap keeps its spatial
  variation (the port's own uniform +-1/sqrt(fan_in) init shrinks it to one
  value, and then every cell ties); the heads' output convs He-normal, then
  set as below;
- the DCN offset convs at 0.5 / sqrt(fan_in) and their biases at 0.5, so
  that sampling leaves the grid by about half a pixel and more;
- norms at identity, the upsamplers bilinear, other biases 0;
- the heads set so that every detection is well posed: the heatmap bias at
  `HM_BIAS`, boxes `box_px` output pixels wide (the traffic's: 2 keeps
  soft-NMS from decaying neighbouring peaks), centre and keypoint offsets
  near the middle of their cell (as a trained model's, so that a box's
  centre names its cell), no keypoint-heatmap peak (PnP reads the
  displacement keypoints), displacement keypoints near the projection of a
  unit cube 8 units in front of the default camera, a near unit scale.

The names and shapes are the reference network's (`reference/net.py`), which
are the port's, so one state dict loads into both.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from posebench.reference import net as refnet

DEFAULT_CAMERA = np.array([[663.0287679036459, 0, 300.2775065104167],
                           [0, 663.0287679036459, 395.00066121419275],
                           [0, 0, 1]])
GAIN = 0.8
HM_BIAS = -2.19
# head -> (gain on the drawn weight, bias); None keeps the bias at 0.
HEAD_SETTINGS = {
    "wh": (0.1, None), "hm_hp": (0.1, -6.0), "hps": (0.05, None), "scale": (0.1, 1.0),
    "reg": (0.1, 0.5), "hp_offset": (0.1, 0.5),
}


def cube_offsets(frame_w: int, output_w: int) -> np.ndarray:
    """[16] displacement offsets (output pixels, x/y interleaved) of a unit
    cube yawed by 0.5 rad, 8 units in front of the default camera."""
    corners = np.array([[(1 if i & 4 else -1), (1 if i & 2 else -1), (1 if i & 1 else -1)]
                        for i in range(8)], np.float64) * 0.5
    yaw = np.array([[np.cos(0.5), 0, np.sin(0.5)], [0, 1, 0], [-np.sin(0.5), 0, np.cos(0.5)]])
    corners = corners @ yaw.T + [0.0, 0.0, 8.0]
    out_px = frame_w / output_w
    return (corners[:, :2] / corners[:, 2:] * DEFAULT_CAMERA[0, 0] / out_px).reshape(-1)


def make_state(spec: refnet.NetSpec, seed: int, device, frame_w: int, output_w: int, box_px: float,
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The state dict of `spec`'s network from `seed`, on `device`, its
    floating tensors in `dtype` (the type the cell runs the port in), its
    boxes `box_px` output pixels wide."""
    device = torch.device(device)
    net = refnet.skeleton(spec)
    offset_convs = {id(d.conv_offset_mask) for d in refnet.dcn_modules(net)}
    head_outputs = {id(getattr(net, h)[-1]) for h, _ in spec.heads}
    drawn = []                                   # (module, scale) of the normal draws
    for mod in net.modules():
        if isinstance(mod, refnet.DCN):
            drawn.append((mod, GAIN * (2.0 / mod.weight[0].numel()) ** 0.5))
            om = mod.conv_offset_mask
            drawn.append((om, 0.5 / om.weight[0].numel() ** 0.5))
        elif isinstance(mod, nn.Conv2d) and id(mod) not in offset_convs:
            gain = 1.0 if id(mod) in head_outputs else GAIN
            drawn.append((mod, gain * (2.0 / mod.weight[0].numel()) ** 0.5))
    sizes = [m.weight.numel() for m, _ in drawn]
    sizes += [m.bias.numel() for m, _ in drawn if id(m) in offset_convs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn(sum(sizes), generator=gen, device=device)
    pieces = iter(torch.split(noise, sizes))

    values: Dict[int, torch.Tensor] = {}          # id(parameter) -> value
    for mod, scale in drawn:
        values[id(mod.weight)] = next(pieces).view(mod.weight.shape) * scale
    for mod, _ in drawn:
        if id(mod) in offset_convs:
            values[id(mod.bias)] = next(pieces) * 0.5

    state: Dict[str, torch.Tensor] = {}
    params = dict(net.named_parameters())
    for name, t in net.state_dict(keep_vars=True).items():
        if id(t) in values:
            v = values[id(t)]
        elif name.endswith("num_batches_tracked"):
            v = torch.zeros((), dtype=torch.int64, device=device)
        elif name.endswith("running_var"):
            v = torch.ones(t.shape, device=device)
        elif name.endswith("running_mean"):
            v = torch.zeros(t.shape, device=device)
        elif name in params and _owner_is(net, name, (nn.BatchNorm2d, nn.GroupNorm)) and name.endswith("weight"):
            v = torch.ones(t.shape, device=device)
        elif name in params and _owner_is(net, name, (refnet.UpsampleConv,)):
            mod = net.get_submodule(name.rsplit(".", 1)[0])
            v = refnet.bilinear_upsample_kernel(mod.factor)[None, None].expand(t.shape).to(device)
        else:
            v = torch.zeros(t.shape, device=device)
        state[name] = v

    last = {h: f"{h}.{len(getattr(net, h)) - 1}" for h, _ in spec.heads}
    state[last["hm"] + ".bias"] = torch.full_like(state[last["hm"] + ".bias"], HM_BIAS)
    for head, (gain, bias) in HEAD_SETTINGS.items():
        state[last[head] + ".weight"] = state[last[head] + ".weight"] * gain
        if bias is not None:
            state[last[head] + ".bias"] = torch.full_like(state[last[head] + ".bias"], bias)
    state[last["wh"] + ".bias"] = torch.full_like(state[last["wh"] + ".bias"], box_px)
    state[last["hps"] + ".bias"] = torch.tensor(cube_offsets(frame_w, output_w), dtype=torch.float32,
                                                device=device)
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


def _owner_is(net: nn.Module, name: str, kinds) -> bool:
    return isinstance(net.get_submodule(name.rsplit(".", 1)[0]), kinds)
