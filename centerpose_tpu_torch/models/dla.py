"""DLA-34 backbone and the DCN upsampling neck, counterparts of
`centerpose_tpu/models/dla.py`.

Parity targets: `DLA` (pose_dla_dcn.py:227-346: base 7x7 stem, two conv levels,
four Tree stages with levels=[1,1,1,2,2,1] and channels=[16,32,64,128,256,512]),
`DLAUp` iterative deep aggregation (:420-443) and `IDAUp` (:392-417: DCN proj →
bilinear-init depthwise transposed-conv upsample → DCN node merge).

The stem is the plain 7x7 convolution (the JAX package's space-to-depth stem
is a TPU layout). The tracking model adds the CenterTrack-style early-fusion
stems (:253-271, 310-322): `pre_img_layer`, `pre_hm_layer` and
`pre_hm_hp_layer`, the same 7x7 conv + BN + ReLU as `base_layer` on 3, 1 and 8
input channels, each added to the stem output when its input is given.

The `dlav0` neck (dlav0.py:469-555) is here too: `IDAUpV0` / `DLAUpV0`, plain
1x1 projections, the same depthwise bilinear upsampler and 3x3 conv + BN +
ReLU nodes over concatenated pairs, no deformable convolution.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from centerpose_tpu_torch.models.layers import (
    DeformConvBlock,
    Tree,
    UpsampleConv,
    conv_bn_relu,
)

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)


def _conv_level(cin: int, cout: int, convs: int, stride: int = 1) -> nn.Sequential:
    """`_make_conv_level`: n x (3x3 conv + BN + ReLU), stride on the first."""
    mods: List[nn.Module] = []
    for i in range(convs):
        mods.extend(conv_bn_relu(cin, cout, 3, stride if i == 0 else 1))
        cin = cout
    return nn.Sequential(*mods)


# Previous-frame stems of the tracking model and their input channels.
PRE_STEMS = (("pre_img_layer", 3), ("pre_hm_layer", 1), ("pre_hm_hp_layer", 8))


class DLA(nn.Module):
    """DLA-34 trunk returning the 6 per-level feature maps (strides 1..32).
    `tracking=True` adds the three previous-frame stems."""

    def __init__(self, levels: Sequence[int] = DLA34_LEVELS,
                 channels: Sequence[int] = DLA34_CHANNELS,
                 tracking: bool = False):
        super().__init__()
        ch = channels
        self.base_layer = conv_bn_relu(3, ch[0], 7, 1)
        self.tracking = tracking
        if tracking:
            for name, cin in PRE_STEMS:
                setattr(self, name, conv_bn_relu(cin, ch[0], 7, 1))
        self.level0 = _conv_level(ch[0], ch[0], levels[0])
        self.level1 = _conv_level(ch[0], ch[1], levels[1], stride=2)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True)

    def forward(self, x, pre_img: Optional[torch.Tensor] = None,
                pre_hm: Optional[torch.Tensor] = None,
                pre_hm_hp: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        x = self.base_layer(x)
        if self.tracking:
            for (name, _), inp in zip(PRE_STEMS, (pre_img, pre_hm, pre_hm_hp)):
                if inp is not None:
                    x = x + getattr(self, name)(inp)
        outs = []
        for name in ("level0", "level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            outs.append(x)
        return outs


class IDAUp(nn.Module):
    """Iterative deep aggregation across a pyramid slice (pose_dla_dcn.py:392-417).

    Given feature maps ordered shallow→deep, each deeper map i is projected
    (`proj_i`, DCN), upsampled to the shallower stride (`up_i`) and merged
    through a node DCN (`node_i`) with the running aggregate. Returns the new
    per-level list (no in-place list mutation like the reference).
    """

    def __init__(self, features: int, channels: Sequence[int],
                 up_factors: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i in range(1, self.n):
            f = int(up_factors[i])
            setattr(self, f"proj_{i}", DeformConvBlock(int(channels[i]), features))
            if f > 1:
                setattr(self, f"up_{i}", UpsampleConv(features, f))
            setattr(self, f"node_{i}", DeformConvBlock(features, features))

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        assert len(layers) == self.n, (len(layers), self.n)
        out = [layers[0]]
        for i in range(1, self.n):
            x = getattr(self, f"proj_{i}")(layers[i])
            up = getattr(self, f"up_{i}", None)
            if up is not None:
                x = up(x)
            out.append(getattr(self, f"node_{i}")(x + out[i - 1]))
        return out


class DLAUp(nn.Module):
    """Full pyramid aggregation (pose_dla_dcn.py:420-443): repeatedly applies
    IDAUp to the deepest remaining slice, producing a list of aggregated maps
    [stride 4, 8, 16, 32] for first_level=2."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        channels = list(channels)
        self.n = len(channels)
        scales = np.array([2 ** i for i in range(self.n)], dtype=int)
        in_channels = list(channels)
        for i in range(self.n - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:], (scales[j:] // scales[j]).tolist()
            ))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n - 1):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class IDAUpV0(nn.Module):
    """dlav0 iterative deep aggregation (dlav0.py:469-525). Every level is
    brought to `out_dim` channels (`proj_i`: 1x1 conv + BN + ReLU where its
    width differs, nothing otherwise) and to the shallowest stride (`up_i`,
    the depthwise bilinear upsampler, where its factor is > 1), then chained
    through `node_i` (3x3 conv + BN + ReLU) over the channel concatenation
    [aggregate, level i]. Returns (aggregate, [node outputs])."""

    def __init__(self, out_dim: int, channels: Sequence[int], up_factors: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            if int(c) != out_dim:
                setattr(self, f"proj_{i}", conv_bn_relu(int(c), out_dim, 1))
            f = int(up_factors[i])
            if f > 1:
                setattr(self, f"up_{i}", UpsampleConv(out_dim, f))
        for i in range(1, self.n):
            setattr(self, f"node_{i}", conv_bn_relu(2 * out_dim, out_dim, 3))

    def forward(self, layers: Sequence[torch.Tensor]):
        assert len(layers) == self.n, (len(layers), self.n)
        ups = []
        for i, x in enumerate(layers):
            for name in (f"proj_{i}", f"up_{i}"):
                mod = getattr(self, name, None)
                if mod is not None:
                    x = mod(x)
            ups.append(x)
        x, y = ups[0], []
        for i in range(1, self.n):
            x = getattr(self, f"node_{i}")(torch.cat([x, ups[i]], dim=1))
            y.append(x)
        return x, y


class DLAUpV0(nn.Module):
    """dlav0 pyramid aggregation (dlav0.py:528-555): IDAUpV0 over the deepest
    remaining slice, its node outputs replacing the deeper levels; returns
    the stride-4 aggregate for first_level=2."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        channels = list(channels)
        self.n = len(channels)
        scales = np.array([2 ** i for i in range(self.n)], dtype=int)
        in_channels = list(channels)
        for i in range(self.n - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUpV0(
                channels[j], in_channels[j:], (scales[j:] // scales[j]).tolist()
            ))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        layers = list(layers)
        x = layers[-1]
        for i in range(self.n - 1):
            x, y = getattr(self, f"ida_{i}")(layers[-i - 2:])
            layers[-i - 1:] = y
        return x
