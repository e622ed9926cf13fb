"""The plain CenterPoseTrack network (dla_34 with `tracking_task`) in
float32 PyTorch, the reference the benchmark's tracking cell holds the port
against.

The NVlabs model of `main_CenterPoseTrack.py` (`--arch dla_34
--tracking_task`): the DLA-34 trunk, whose 7x7 stem output gains the outputs
of three stems of its own for the previous frame (`pre_img_layer`, 3
channels), its rendered centre heatmap (`pre_hm_layer`, 1) and its keypoint
heatmaps (`pre_hm_hp_layer`, 8) (pose_dla_dcn.py:253-271, 310-322); the
DLAUp / IDAUp neck with its 16 DCNv2 blocks; no ConvGRU, and eleven heads of
3x3 conv (`head_conv` wide) + ReLU + 1x1 conv, with no GroupNorm, each on the
stride-4 feature. The blocks are `reference/net.py`'s, imported, so that the
`state_dict` carries the names the port loads (`base.pre_hm_layer.0.weight`,
`tracking_hp.2.bias`, ...). Inputs and outputs are NHWC, as the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from posebench.reference import net as refnet

NUM_JOINTS = refnet.NUM_JOINTS
# The heads of `preset("centerpose_track")`, in the order of opts.py:394-427.
TRACK_HEADS = (("hm", 1), ("wh", 2), ("hps", 2 * NUM_JOINTS), ("hps_uncertainty", 2 * NUM_JOINTS),
               ("reg", 2), ("hm_hp", NUM_JOINTS), ("hp_offset", 2), ("scale", 3),
               ("scale_uncertainty", 3), ("tracking", 2), ("tracking_hp", 2 * NUM_JOINTS))
PRE_STEMS = (("pre_img_layer", 3), ("pre_hm_layer", 1), ("pre_hm_hp_layer", NUM_JOINTS))


@dataclasses.dataclass(frozen=True)
class TrackSpec:
    arch: str                       # dla_34
    heads: Tuple[Tuple[str, int], ...] = TRACK_HEADS
    head_conv: int = 256


def spec_of(config: dict) -> TrackSpec:
    if config["arch"] != "dla_34":
        raise ValueError(f"the reference tracking network is dla_34, not {config['arch']!r}")
    heads = tuple((name, int(width)) for name, width in config["heads"].items())
    if heads != TRACK_HEADS:
        raise ValueError(f"the reference tracking network has the heads {TRACK_HEADS}, not {heads}")
    return TrackSpec(arch=config["arch"], head_conv=int(config["head_conv"]))


class TrackDLA(refnet.DLA):
    """The DLA-34 trunk with the three previous-frame stems, each added to
    the stem output."""

    def __init__(self):
        super().__init__()
        for name, cin in PRE_STEMS:
            setattr(self, name, refnet.conv_bn_relu(cin, refnet.DLA34_CHANNELS[0], 7))

    def forward(self, x, pre=()):
        x = self.base_layer(x)
        for (name, _), inp in zip(PRE_STEMS, pre):
            x = x + getattr(self, name)(inp)
        outs = []
        for name in ("level0", "level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            outs.append(x)
        return outs


def make_head(cin, classes, head_conv) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, head_conv, 3, padding=1), nn.ReLU(), nn.Conv2d(head_conv, classes, 1))


class TrackNet(nn.Module):
    """dla_34 CenterPoseTrack network; NHWC image and previous-frame inputs
    in, NHWC head maps out."""

    def __init__(self, spec: TrackSpec):
        super().__init__()
        self.spec = spec
        ch = refnet.DLA34_CHANNELS
        first, last = refnet.FIRST_LEVEL, refnet.LAST_LEVEL
        self.base = TrackDLA()
        self.dla_up = refnet.DLAUp(ch[first:])
        self.ida_up = refnet.IDAUp(ch[first], ch[first:last], [2 ** i for i in range(last - first)])
        for name, classes in spec.heads:
            setattr(self, name, make_head(ch[first], classes, spec.head_conv))

    def forward(self, x, pre_img=None, pre_hm=None, pre_hm_hp=None) -> Dict[str, torch.Tensor]:
        def nchw(t):
            return t.permute(0, 3, 1, 2).contiguous()

        pre = () if pre_img is None else (nchw(pre_img), nchw(pre_hm), nchw(pre_hm_hp))
        levels = self.base(nchw(x), pre)
        first, last = refnet.FIRST_LEVEL, refnet.LAST_LEVEL
        feat = self.ida_up(self.dla_up(levels[first:])[: last - first])[-1]
        return {name: getattr(self, name)(feat).permute(0, 2, 3, 1).contiguous() for name, _ in self.spec.heads}


def skeleton(spec: TrackSpec) -> TrackNet:
    """The network on the CPU with uninitialised values: its names, shapes
    and modules."""
    with refnet._no_init():
        return TrackNet(spec)


def build(spec: TrackSpec, device, state: Optional[Dict[str, torch.Tensor]] = None) -> TrackNet:
    """The float32 network on `device` in eval mode, loaded from `state`
    (every name must be the network's)."""
    net = skeleton(spec).to(device)
    if state is not None:
        missing = set(net.state_dict()) - set(state)
        unknown = set(state) - set(net.state_dict())
        if missing or unknown:
            raise KeyError(f"state mismatch: missing {sorted(missing)[:6]}, unknown {sorted(unknown)[:6]}")
        net.load_state_dict({k: v.to(device, torch.float32) if v.is_floating_point() else v
                             for k, v in state.items()})
    return net.eval()
