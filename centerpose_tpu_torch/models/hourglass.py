"""Stacked hourglass network (`hourglass` arch), counterpart of
`centerpose_tpu/models/hourglass.py`.

Parity target: the CornerNet large hourglass (large_hourglass.py:128-314),
2 stacks of 5-level recursive `kp_module`s with dims (256, 256, 384, 384,
384, 512) and modules (2, 2, 2, 2, 2, 4):
  * each level goes down by a stride-2 residual, the first block of `low1`
    (the pool layer is an identity, :104-105), and up by a nearest x2
    upsample added to `up1`;
  * `low2` is the next level's kp_module, or `next_mod` residuals at the
    last level; `low3` is (mod - 1) residuals at the inner width and one
    residual from the inner to the outer width (:88-93);
  * the stem `pre` is a 7x7 s2 conv + BN + ReLU and a stride-2 residual;
    `cnvs` a 3x3 conv + BN + ReLU per stack; between stacks `inters_`
    (1x1 conv + BN on the stack's input) plus `cnvs_` (the same on its
    feature), ReLU, and a residual `inters`;
  * every stack has its own heads, `{head}.{s}` = [3x3 conv with bias at 256
    + ReLU, 1x1 conv]: the width is 256 whatever `head_conv` says (:312-314).

The state_dict keys are the reference's (`pre.0.conv`, `kps.0.up1.0.conv1`,
`kps.0.low2.low2.low2.low2.low2.3.conv2`, `cnvs.1.bn`, `hm.1.0.conv`, ...).
The forward returns the last stack's heads (the JAX trainer supervises only
those), or every stack's with `return_all_stacks`; only the heads returned
are computed, the other stack's parameters exist all the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.models.layers import bn2d, heads_to_nhwc, param_dtype, to_nchw

DIMS = (256, 256, 384, 384, 384, 512)
MODULES = (2, 2, 2, 2, 2, 4)
HEAD_WIDTH = 256
NUM_STACKS = 2


class Convolution(nn.Module):
    """CornerNet `convolution` (large_hourglass.py:17-32): k x k conv (no
    bias when followed by BN), BN or nothing, ReLU."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1, with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=not with_bn)
        self.bn = bn2d(cout) if with_bn else None

    def forward(self, x):
        x = self.conv(x)
        return torch.relu(x if self.bn is None else self.bn(x))


class Residual(nn.Module):
    """CornerNet residual (large_hourglass.py:50-77): 3x3 conv (stride) + BN +
    ReLU, 3x3 conv + BN, `skip` 1x1 conv + BN where the shape changes, ReLU
    of the sum."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = bn2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = bn2d(cout)
        self.skip = (nn.Sequential(nn.Conv2d(cin, cout, 1, stride=stride, bias=False), bn2d(cout))
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + (x if self.skip is None else self.skip(x)))


def _residuals(cin: int, cout: int, n: int, stride: int = 1) -> nn.Sequential:
    """n residuals, the first cin -> cout with `stride`, the rest at cout."""
    return nn.Sequential(*[Residual(cin if i == 0 else cout, cout, stride if i == 0 else 1)
                           for i in range(n)])


class KpModule(nn.Module):
    """Recursive kp_module (large_hourglass.py:128-187) at `level` (5 at the
    top): its widths and residual counts are read from `DIMS` and `MODULES`
    when it is built."""

    def __init__(self, level: int):
        super().__init__()
        depth = 5 - level
        curr_dim, next_dim = DIMS[depth], DIMS[depth + 1]
        curr_mod, next_mod = MODULES[depth], MODULES[depth + 1]
        self.up1 = _residuals(curr_dim, curr_dim, curr_mod)
        self.low1 = _residuals(curr_dim, next_dim, curr_mod, stride=2)
        self.low2 = (KpModule(level - 1) if level > 1
                     else _residuals(next_dim, next_dim, next_mod))
        self.low3 = nn.Sequential(*[Residual(next_dim, next_dim) for _ in range(curr_mod - 1)],
                                  Residual(next_dim, curr_dim))

    def forward(self, x):
        low = self.low3(self.low2(self.low1(x)))
        return self.up1(x) + F.interpolate(low, scale_factor=2, mode="nearest")


class KpHead(nn.Sequential):
    """make_kp_layer: [3x3 conv with bias + ReLU at 256, 1x1 conv]; heatmap
    heads get a -2.19 output bias."""

    def __init__(self, cin: int, classes: int, bias_init_value: float = 0.0):
        super().__init__(Convolution(3, cin, HEAD_WIDTH, with_bn=False), nn.Conv2d(HEAD_WIDTH, classes, 1))
        self.bias_init_value = bias_init_value
        nn.init.constant_(self[-1].bias, bias_init_value)


class HourglassNet(nn.Module):
    """The 2-stack large hourglass. Takes an NHWC batch and returns NHWC head
    maps at stride 4 (the input side a multiple of 128: five halvings below
    stride 4)."""

    def __init__(self, config: CenterPoseConfig, num_stacks: int = NUM_STACKS,
                 return_all_stacks: bool = False):
        super().__init__()
        self.config = config
        self.num_stacks = num_stacks
        self.return_all_stacks = return_all_stacks
        dim = DIMS[0]
        self.pre = nn.Sequential(Convolution(7, 3, 128, stride=2), Residual(128, dim, stride=2))
        self.kps = nn.ModuleList([KpModule(5) for _ in range(num_stacks)])
        self.cnvs = nn.ModuleList([Convolution(3, dim, dim) for _ in range(num_stacks)])
        self.inters = nn.ModuleList([Residual(dim, dim) for _ in range(num_stacks - 1)])

        def conv1x1_bn():
            return nn.Sequential(nn.Conv2d(dim, dim, 1, bias=False), bn2d(dim))

        self.inters_ = nn.ModuleList([conv1x1_bn() for _ in range(num_stacks - 1)])
        self.cnvs_ = nn.ModuleList([conv1x1_bn() for _ in range(num_stacks - 1)])
        self.head_names = tuple(config.heads)
        for name, classes in config.heads.items():
            setattr(self, name, nn.ModuleList([
                KpHead(dim, classes, -2.19 if "hm" in name else 0.0) for _ in range(num_stacks)]))

    def forward(self, x: torch.Tensor, pre_img: Optional[torch.Tensor] = None,
                pre_hm: Optional[torch.Tensor] = None, pre_hm_hp: Optional[torch.Tensor] = None,
                ) -> Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]:
        del pre_img, pre_hm, pre_hm_hp
        inter = self.pre(to_nchw(x, param_dtype(self)))
        outs = []
        for s in range(self.num_stacks):
            cnv = self.cnvs[s](self.kps[s](inter))
            if self.return_all_stacks or s == self.num_stacks - 1:
                out = {h: getattr(self, h)[s](cnv) for h in self.head_names}
                outs.append(heads_to_nhwc(out, self.head_names))
            if s < self.num_stacks - 1:
                inter = self.inters[s](torch.relu(self.inters_[s](inter) + self.cnvs_[s](cnv)))
        return outs if self.return_all_stacks else outs[-1]
