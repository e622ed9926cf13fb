"""Shared building blocks (`torch.nn`), counterparts of `centerpose_tpu/models/layers.py`.

Parity targets are the same as the JAX package's: BasicBlock/Root/Tree of the
reference DLA (`pose_dla_dcn.py:34-224`), the DCN+BN+ReLU `DeformConv`
(`:377-389`) and the depthwise bilinear-initialised transposed-conv upsampler
(`:365-374, 402-405`).

Tensors inside the network are NCHW-shaped in `torch.channels_last` memory
format, i.e. physically NHWC: the permutes at the network's boundary and
around the deformable convolution are views, and the DCN kernel sees
channel-contiguous data.

Parameter names are those of the reference's PyTorch `state_dict`
(`base.level2.tree1.conv1.weight`, `dla_up.ida_0.proj_1.conv.weight`,
`hm.0.weight`, ...), the names `centerpose_tpu/models/convert.py` reads, so a
released checkpoint loads with `load_state_dict` and `models/convert.py` of
this package maps the JAX package's variables onto the same names.

Not here: the JAX package's `S2DConvBN`, `SplitHeadConv` and `_batch_chunked`
(re-arrangements for the TPU's matrix unit and memory) and
`TorchConvTranspose` (used by architectures that are not ported yet).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward, kernel_weight

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True) -> nn.Sequential:
    """Conv (no bias) + BatchNorm + optional ReLU (`ConvBN` of the JAX package)
    as the reference's `Sequential(conv, bn[, relu])`."""
    pad = dilation * (kernel - 1) // 2
    mods: List[nn.Module] = [
        nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=False),
        _bn(cout),
    ]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual add (pose_dla_dcn.py:34-62)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, stride=1, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = _bn(cout)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + residual)


class Root(nn.Module):
    """1x1 aggregation over concatenated children (pose_dla_dcn.py:150-168)."""

    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = _bn(cout)
        self.residual = residual

    def forward(self, children: Sequence[torch.Tensor]):
        x = self.bn(self.conv(torch.cat(list(children), dim=1)))
        if self.residual:
            x = x + children[0]
        return torch.relu(x)


class Tree(nn.Module):
    """Recursive deep-layer-aggregation tree (pose_dla_dcn.py:171-224)."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        self.levels = levels
        self.level_root = level_root
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, cout, cout, 1,
                              root_dim=root_dim + cout,
                              root_residual=root_residual)
        self.downsample = nn.MaxPool2d(stride, stride=stride) if stride > 1 else None
        # Present whenever the widths differ, as in the reference; only a
        # one-level tree reads its output.
        self.project = (
            conv_bn_relu(cin, cout, 1, relu=False) if cin != cout else None
        )

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = [] if children is None else list(children)
        bottom = self.downsample(x) if self.downsample is not None else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DCN(nn.Module):
    """DCNv2 with its offset/mask conv (`DCN`, DCNv2/dcn_v2.py:97-128).

    `conv_offset_mask` emits 27 channels: [0:18] the interleaved (dy, dx) per
    tap, [18:27] the mask logits; the sigmoid is applied here, outside the
    deformable convolution. It is zero-initialised, so a fresh block is a
    plain 3x3 conv with 0.5 gates. `weight` is OIHW like any `Conv2d`'s.
    """

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, padding=1)
        bound = 1.0 / math.sqrt(cin * 9)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self._hwio = None                                # (key, tensor), see _weight_hwio

    def _weight_hwio(self):
        """`weight` as the HWIO operand in the kernel's memory layout, copied
        once and kept until the parameter is written to, moved or cast. Where
        a gradient is being recorded it is a view of the parameter instead."""
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return w.permute(2, 3, 1, 0)
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._hwio is None or self._hwio[0] != key:
            self._hwio = (key, kernel_weight(w.detach()))
        return self._hwio[1]

    def operands(self, x):
        """The five NHWC operands of the deformable convolution for the
        NCHW-shaped input `x`: (x, offset, mask, weight HWIO, bias)."""
        x = x.contiguous(memory_format=torch.channels_last)
        om = self.conv_offset_mask(x).contiguous(memory_format=torch.channels_last)
        om = om.permute(0, 2, 3, 1)                      # NHWC view, contiguous
        offset = om[..., :18]
        mask = torch.sigmoid(om[..., 18:])
        return x.permute(0, 2, 3, 1), offset, mask, self._weight_hwio(), self.bias

    def forward(self, x):
        out = dcn_v2_forward(*self.operands(x))          # [B, H, W, Co]
        return out.permute(0, 3, 1, 2)                   # NCHW view, channels_last


class DeformConvBlock(nn.Module):
    """DCNv2 + BN + ReLU (`DeformConv`, pose_dla_dcn.py:377-389)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.actf = nn.Sequential(_bn(cout), nn.ReLU(inplace=True))
        self.conv = DCN(cin, cout)

    def forward(self, x):
        return self.actf(self.conv(x))


def bilinear_upsample_kernel(factor: int) -> torch.Tensor:
    """(2f, 2f) bilinear interpolation kernel — the reference's
    `fill_up_weights` (pose_dla_dcn.py:365-374)."""
    size = factor * 2
    f = math.ceil(size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    r = torch.arange(size, dtype=torch.float32)
    k1 = 1 - torch.abs(r / f - c)
    return k1[:, None] * k1[None, :]


class UpsampleConv(nn.ConvTranspose2d):
    """Depthwise transposed conv x`factor`, bilinear-initialised but trainable:
    nn.ConvTranspose2d(C, C, 2f, stride=f, padding=f//2, groups=C, bias=False)
    (pose_dla_dcn.py:402-405). The weight is [C, 1, 2f, 2f]; the JAX package
    stores the same numbers as [2f, 2f, 1, C] and flips them when it applies
    them as an ordinary convolution, so no flip is needed here."""

    def __init__(self, channels: int, factor: int):
        super().__init__(channels, channels, factor * 2, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        self.factor = factor
        self.reset_bilinear()

    def reset_bilinear(self):
        with torch.no_grad():
            self.weight.copy_(
                bilinear_upsample_kernel(self.factor)[None, None].expand_as(self.weight)
            )

    def forward(self, x):
        return super().forward(x).contiguous(memory_format=torch.channels_last)


class HeadConv(nn.Sequential):
    """Prediction head: 3x3 conv -> [GroupNorm] -> ReLU -> 1x1 conv
    (pose_dla_dcn.py:491-521). GroupNorm(32, eps 1e-5) is inserted when the
    convGRU chain is active; heatmap heads get a -2.19 output bias."""

    def __init__(self, cin: int, classes: int, head_conv: int = 256,
                 use_gn: bool = False, bias_init_value: float = 0.0):
        if head_conv <= 0:
            raise NotImplementedError(
                "head_conv <= 0 (single 1x1 conv heads) is not ported"
            )
        mods: List[nn.Module] = [nn.Conv2d(cin, head_conv, 3, padding=1)]
        if use_gn:
            groups = 32 if head_conv % 32 == 0 else 16
            mods.append(nn.GroupNorm(groups, head_conv, eps=1e-5))
        mods.append(nn.ReLU(inplace=True))
        mods.append(nn.Conv2d(head_conv, classes, 1))
        super().__init__(*mods)
        self.bias_init_value = bias_init_value
        nn.init.constant_(self[-1].bias, bias_init_value)
