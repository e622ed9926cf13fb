"""Weights of the tracking cell, made on the device from the run's seed.

The image model's recipe (`posebench/weights.py`: convolutions and DCN at
0.8 of He's scale, offsets off the grid, norms at identity, bilinear
upsamplers, heads set so that every detection is well posed), with what a
live video of two objects needs to keep the tracker's load fixed:

- the two image stems (`base.base_layer`, `base.pre_img_layer`) DC-free:
  each 7x7 kernel less its mean, so that the black background gives no
  feature and the features lie where the video's two discs are;
- the three previous-frame stems at `PRE_GAIN` of the drawn scale, so that
  the current frame sets where the heatmap peaks;
- the neck's projections of the deeper levels (every `proj_*` DCN of
  `dla_up` and `ida_up`) at `PROJ_GAIN` of the drawn scale, so that the
  stride-4 features, centred on each disc, set the heatmap's shape: a deep
  level's features, upsampled bilinearly, peak at its own coarse grid
  points, so at full gain a disc lying between two of them showed two
  near-equal lobes 2-8 cells apart, and the second could outrank the other
  disc's peak (one detection reached the tracker in 0.9 % of frames; with
  this gain and the blurred centre head, the other disc's peak leads the
  next peak, ties aside, by 0.0069 or more in 22 seeds);
- the centre heatmap's 3x3 conv spatially constant and non-negative (each
  kernel's mean |drawn| x `HM_SMOOTH`), its output conv non-negative
  (|drawn| x `HM_GAIN`) over the ReLU between them, with the bias `HM_BIAS`
  (a score of 0.5): the heatmap is a 3x3 blur of a positive mix of the
  features, rising above its flat level at the discs with one peak each
  (lobes 2-3 cells apart merge), which moves with its disc. `HM_SMOOTH`
  sets a disc's peak logit at 0.6-1.8: at a tenth of it, two cells either
  side of a peak midway between them scored the same float32 value about
  once in 10^4 frames, both passed decode's 3x3 NMS and took both of K=2;
- `tracking` and `tracking_hp` small (gain `TRACK_GAIN`, bias 0);
- the keypoint uncertainty (`hps_uncertainty`, a log-variance) at bias 0
  for the joints the tracker keeps (a filtered position std of ~3 px, a
  Kalman confidence of ~0.83) and `GATED_LOG_VAR` for the three
  `GATED_JOINTS` (~13 px, confidence 0), both far from the tracker's 0.15
  gate, so that every re-PnP row carries 5 valid points and takes PnP's
  EPnP branch (with no rounding flip at the gate); `scale_uncertainty` at
  bias 0.

The names and shapes are the reference tracking network's
(`reference/track_net.py`), which are the port's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from posebench import weights
from posebench.reference import net as refnet
from posebench.reference import track_net

HM_GAIN = 5.0
PRE_GAIN = 0.1
PROJ_GAIN = 0.1
HM_SMOOTH = 0.5
HM_BIAS = 0.0
TRACK_GAIN = 0.05
GATED_JOINTS = (0, 1, 2)
GATED_LOG_VAR = 4.0
# head -> (gain on the drawn weight, bias); None keeps the bias at 0.
HEAD_SETTINGS = {
    **weights.HEAD_SETTINGS,
    "hps_uncertainty": (0.02, None), "scale_uncertainty": (0.02, None),
    "tracking": (TRACK_GAIN, None), "tracking_hp": (TRACK_GAIN, None),
}
IMAGE_STEMS = ("base.base_layer.0.weight", "base.pre_img_layer.0.weight")
PRE_STEMS = ("base.pre_img_layer.0.weight", "base.pre_hm_layer.0.weight", "base.pre_hm_hp_layer.0.weight")


def make_state(spec: track_net.TrackSpec, seed: int, device, frame_w: int, output_w: int,
               box_px: float) -> Dict[str, torch.Tensor]:
    """The float32 state dict of `spec`'s network from `seed`, on `device`,
    its boxes `box_px` output pixels wide."""
    device = torch.device(device)
    net = track_net.skeleton(spec)
    offset_convs = {id(d.conv_offset_mask) for d in refnet.dcn_modules(net)}
    head_outputs = {id(getattr(net, h)[-1]) for h, _ in spec.heads}
    drawn = []                                   # (module, scale) of the normal draws
    for mod in net.modules():
        if isinstance(mod, refnet.DCN):
            drawn.append((mod, weights.GAIN * (2.0 / mod.weight[0].numel()) ** 0.5))
            om = mod.conv_offset_mask
            drawn.append((om, 0.5 / om.weight[0].numel() ** 0.5))
        elif isinstance(mod, nn.Conv2d) and id(mod) not in offset_convs:
            gain = 1.0 if id(mod) in head_outputs else weights.GAIN
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
        elif name in params and weights._owner_is(net, name, (nn.BatchNorm2d,)) and name.endswith("weight"):
            v = torch.ones(t.shape, device=device)
        elif name in params and weights._owner_is(net, name, (refnet.UpsampleConv,)):
            mod = net.get_submodule(name.rsplit(".", 1)[0])
            v = refnet.bilinear_upsample_kernel(mod.factor)[None, None].expand(t.shape).to(device)
        else:
            v = torch.zeros(t.shape, device=device)
        state[name] = v

    for name in IMAGE_STEMS:
        w = state[name]
        state[name] = w - w.mean(dim=(2, 3), keepdim=True)
    for name in PRE_STEMS:
        state[name] = state[name] * PRE_GAIN
    for name in [k for k in state if ".proj_" in k and k.endswith(".conv.weight")]:
        state[name] = state[name] * PROJ_GAIN
    last = {h: f"{h}.{len(getattr(net, h)) - 1}" for h, _ in spec.heads}
    w = state["hm.0.weight"]
    state["hm.0.weight"] = (w.abs().mean(dim=(2, 3), keepdim=True) * HM_SMOOTH).expand_as(w).contiguous()
    state[last["hm"] + ".weight"] = state[last["hm"] + ".weight"].abs() * HM_GAIN
    state[last["hm"] + ".bias"] = torch.full_like(state[last["hm"] + ".bias"], HM_BIAS)
    for head, (gain, bias) in HEAD_SETTINGS.items():
        state[last[head] + ".weight"] = state[last[head] + ".weight"] * gain
        if bias is not None:
            state[last[head] + ".bias"] = torch.full_like(state[last[head] + ".bias"], bias)
    state[last["wh"] + ".bias"] = torch.full_like(state[last["wh"] + ".bias"], box_px)
    state[last["hps"] + ".bias"] = torch.tensor(weights.cube_offsets(frame_w, output_w), dtype=torch.float32,
                                                device=device)
    log_var = torch.zeros(2 * track_net.NUM_JOINTS, device=device)
    for j in GATED_JOINTS:
        log_var[2 * j:2 * j + 2] = GATED_LOG_VAR
    state[last["hps_uncertainty"] + ".bias"] = log_var
    return state
