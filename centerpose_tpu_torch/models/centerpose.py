"""The CenterPose networks on the DLA trunk, counterparts of
`centerpose_tpu/models/centerpose.py`: `CenterPoseNet` (DLA trunk →
DLAUp/IDAUp neck → (convGRU) → heads; dla_34, dlav1_34) and
`CenterPoseNetV0` (dlav0_34: the plain-conv concat-node neck).

Parity target: `DLASeg` (pose_dla_dcn.py:457-570) with `down_ratio=4`,
`last_level=5`. Head routing with convGRU (:542-565), image model, 3 steps:

    step0 → {hm, wh, reg}
    step1 → {hm_hp, hp_offset, hps, hps_uncertainty}
    step2 → {scale, scale_uncertainty}

Without convGRU (`dla_34`) every head reads the final stride-4 feature. That
includes the tracking model (`preset("centerpose_track")`: dla_34 with
`tracking_task`), whose `tracking` (2) and `tracking_hp` (16) heads read it
too, and whose trunk takes the previous frame (`pre_img`), its rendered
center heatmap (`pre_hm`) and its keypoint heatmaps (`pre_hm_hp`) through
stems of their own (`models/dla.py`). The 4-step GRU routing that the
reference keeps for dlav1 + tracking (`_GRU_GROUPS_TRACK` of the JAX package,
an idea the reference marks as untried) is not ported and raises.

`forward` takes NHWC batches ([B, H, W, 3] image; previous-frame inputs
[B, H, W, 3 / 1 / 8]) and returns a dict of NHWC head maps at stride 4, like
the JAX model; inside, tensors are NCHW-shaped in channels_last memory. Every
head runs its own 3x3 conv (the JAX package fuses the heads of one step into
one wide conv: same numbers up to float noise). With `head_conv <= 0` every
head is a single 1x1 conv (`layers.make_head`), on the GRU states too.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.models.conv_gru import ConvGRU
from centerpose_tpu_torch.models.dla import DLA, DLA34_CHANNELS, DLAUp, DLAUpV0, IDAUp
from centerpose_tpu_torch.models.layers import heads_to_nhwc, make_head, param_dtype, to_nchw

FIRST_LEVEL = 2  # log2(down_ratio=4)
LAST_LEVEL = 5
GRU_HIDDEN = 64

# GRU-step routing (pose_dla_dcn.py:542-565).
_GRU_GROUPS_IMAGE = (
    ("hm", "wh", "reg"),
    ("hm_hp", "hp_offset", "hps", "hps_uncertainty"),
    ("scale", "scale_uncertainty"),
)


class CenterPoseNet(nn.Module):
    """dla_34 / dlav1_34 CenterPose model (image model, or the dla_34 tracking
    model)."""

    def __init__(self, config: CenterPoseConfig):
        super().__init__()
        if config.tracking_task and config.use_conv_gru:
            raise NotImplementedError(
                "the dlav1 + tracking 4-step GRU routing is not ported; the "
                "tracking model is dla_34 (preset 'centerpose_track'), see ROADMAP.md"
            )
        self.config = config
        channels = DLA34_CHANNELS
        self.base = DLA(tracking=config.tracking_task)
        self.dla_up = DLAUp(channels[FIRST_LEVEL:])
        self.ida_up = IDAUp(
            channels[FIRST_LEVEL],
            channels[FIRST_LEVEL:LAST_LEVEL],
            [2 ** i for i in range(LAST_LEVEL - FIRST_LEVEL)],
        )
        self.use_gru = config.use_conv_gru
        feat = channels[FIRST_LEVEL]
        if self.use_gru:
            self.convGRU = ConvGRU(feat, steps=config.gru_steps, hidden=GRU_HIDDEN)
            feat = GRU_HIDDEN
        self.head_names = tuple(config.heads)
        for name, classes in config.heads.items():
            setattr(self, name, make_head(
                feat, classes, config.head_conv, use_gn=self.use_gru,
                bias_init_value=-2.19 if "hm" in name else 0.0,  # focal-loss prior
            ))

    def features(self, x: torch.Tensor, *pre) -> torch.Tensor:
        """NCHW image (and NCHW previous-frame inputs) → the stride-4 feature
        the heads (or the GRU) read."""
        levels = self.base(x, *pre)
        pyramid = self.dla_up(levels[FIRST_LEVEL:])
        return self.ida_up(pyramid[: LAST_LEVEL - FIRST_LEVEL])[-1]

    def forward(
        self,
        x: torch.Tensor,
        pre_img: Optional[torch.Tensor] = None,
        pre_hm: Optional[torch.Tensor] = None,
        pre_hm_hp: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        dtype = param_dtype(self)
        feat = self.features(*(to_nchw(t, dtype) for t in (x, pre_img, pre_hm, pre_hm_hp)))

        out: Dict[str, torch.Tensor] = {}
        if self.use_gru:
            states = self.convGRU(feat)
            for step, group in enumerate(_GRU_GROUPS_IMAGE):
                for head in group:
                    if head in self.head_names:
                        out[head] = getattr(self, head)(states[step])
        else:
            for head in self.head_names:
                out[head] = getattr(self, head)(feat)
        return heads_to_nhwc(out, self.head_names)


class CenterPoseNetV0(nn.Module):
    """dlav0_34 (dlav0.py DLASeg, :565-660): the DLA-34 trunk and one
    `DLAUpV0` aggregate at stride 4 that feeds the heads directly — no IDAUp
    pass, no convGRU, no GroupNorm, no tracking stems, no deformable
    convolution. A released checkpoint also holds the trunk's ImageNet
    classifier (`base.fc.*`), which CenterPose never runs and this module
    does not have (`models/convert.py::load_reference_state_dict` skips it)."""

    def __init__(self, config: CenterPoseConfig):
        super().__init__()
        self.config = config
        channels = DLA34_CHANNELS
        self.base = DLA()
        self.dla_up = DLAUpV0(channels[FIRST_LEVEL:])
        self.head_names = tuple(config.heads)
        for name, classes in config.heads.items():
            setattr(self, name, make_head(
                channels[FIRST_LEVEL], classes, config.head_conv,
                bias_init_value=-2.19 if "hm" in name else 0.0,
            ))

    def forward(self, x: torch.Tensor, pre_img=None, pre_hm=None,
                pre_hm_hp=None) -> Dict[str, torch.Tensor]:
        del pre_img, pre_hm, pre_hm_hp            # dlav0 never builds the stems
        levels = self.base(to_nchw(x, param_dtype(self)))
        feat = self.dla_up(levels[FIRST_LEVEL:])
        out = {h: getattr(self, h)(feat) for h in self.head_names}
        return heads_to_nhwc(out, self.head_names)
