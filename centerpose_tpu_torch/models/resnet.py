"""ResNet + deconv networks (res_18/34/50/101/152 and resdcn_*), counterpart of
`centerpose_tpu/models/resnet.py`.

Parity targets: the MSRA simple baseline (msra_resnet.py:108-312): the
torchvision-style ResNet trunk (7x7 s2 stem + BN + ReLU + 3/2/1 max-pool, four
stages of basic or bottleneck blocks, the stride in the bottleneck's 3x3
conv), three deconv stages back to stride 4 and the heads; and `resdcn_*`
(resnet_dcn.py:134-294), whose deconv stages start with a deformable
convolution.

`deconv_layers` is the reference's Sequential:
  msra    [ConvT(->256), BN, ReLU] x 3                   (BN at 3i + 1)
  resdcn  [DCN, BN, ReLU, ConvT(bilinear), BN, ReLU] x 3  at 256/128/64
          (the DCN module itself at 6i, BN at 6i + 1 and 6i + 4)
so the state_dict keys are the reference's (`conv1`, `bn1`,
`layer{s}.{b}.conv{n}` / `bn{n}` / `downsample.{0,1}`, `deconv_layers.{i}`,
`hm.0` / `hm.2`). Heads have no GroupNorm. The resdcn DCN blocks run the
deformable-convolution kernels on CUDA tensors, like the DLA neck's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.models.layers import (
    DCN,
    TorchConvTranspose,
    bn2d,
    heads_to_nhwc,
    make_head,
    param_dtype,
    to_nchw,
)

# (block kind, blocks per stage) per depth; basic expansion 1, bottleneck 4.
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
RESDCN_PLANES = (256, 128, 64)
MSRA_PLANES = 256


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), bn2d(cout))


class ResBasic(nn.Module):
    """Basic block (msra_resnet.py:26-55)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = bn2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = bn2d(cout)
        self.downsample = _downsample(cin, cout, stride) if stride != 1 or cin != cout else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResBottleneck(nn.Module):
    """Bottleneck block (msra_resnet.py:58-98), `cout` = 4 x the inner width,
    the stride in the 3x3 conv."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        inner = cout // 4
        self.conv1 = nn.Conv2d(cin, inner, 1, bias=False)
        self.bn1 = bn2d(inner)
        self.conv2 = nn.Conv2d(inner, inner, 3, stride=stride, padding=1, bias=False)
        self.bn2 = bn2d(inner)
        self.conv3 = nn.Conv2d(inner, cout, 1, bias=False)
        self.bn3 = bn2d(cout)
        self.downsample = _downsample(cin, cout, stride) if stride != 1 or cin != cout else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class PoseResNet(nn.Module):
    """res_{num_layers} (msra deconv stages) or, with `deformable_deconv`,
    resdcn_{num_layers}. Takes an NHWC batch, returns NHWC head maps at
    stride 4 (tracking inputs are a DLA feature and are ignored, as in the
    JAX package)."""

    def __init__(self, config: CenterPoseConfig, num_layers: int = 18,
                 deformable_deconv: bool = False):
        super().__init__()
        if num_layers not in RESNET_SPEC:
            raise ValueError(f"no ResNet of depth {num_layers}; depths {sorted(RESNET_SPEC)}")
        self.config = config
        kind, counts = RESNET_SPEC[num_layers]
        block = ResBasic if kind == "basic" else ResBottleneck
        expansion = 1 if kind == "basic" else 4
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for si, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), counts)):
            blocks: List[nn.Module] = []
            for bi in range(n_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                blocks.append(block(cin, width * expansion, stride))
                cin = width * expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        mods: List[nn.Module] = []
        if deformable_deconv:
            for planes in RESDCN_PLANES:
                mods += [DCN(cin, planes), bn2d(planes), nn.ReLU(inplace=True),
                         TorchConvTranspose(planes, planes, bilinear_init=True), bn2d(planes),
                         nn.ReLU(inplace=True)]
                cin = planes
        else:
            for _ in range(3):
                mods += [TorchConvTranspose(cin, MSRA_PLANES), bn2d(MSRA_PLANES), nn.ReLU(inplace=True)]
                cin = MSRA_PLANES
        self.deconv_layers = nn.Sequential(*mods)
        self.head_names = tuple(config.heads)
        for name, classes in config.heads.items():
            setattr(self, name, make_head(
                cin, classes, config.head_conv, bias_init_value=-2.19 if "hm" in name else 0.0))

    def forward(self, x: torch.Tensor, pre_img: Optional[torch.Tensor] = None,
                pre_hm: Optional[torch.Tensor] = None,
                pre_hm_hp: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        del pre_img, pre_hm, pre_hm_hp
        x = self.maxpool(torch.relu(self.bn1(self.conv1(to_nchw(x, param_dtype(self))))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.deconv_layers(x)
        out = {h: getattr(self, h)(x) for h in self.head_names}
        return heads_to_nhwc(out, self.head_names)
