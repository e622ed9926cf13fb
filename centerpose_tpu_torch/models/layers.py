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

Also here: the full transposed convolution of the ResNet deconv stages
(`TorchConvTranspose`, msra_resnet.py:207-235, resnet_dcn.py:218-247) and the
single 1x1 conv head of `head_conv <= 0` (`make_head`, pose_dla_dcn.py:513-520).

Not here: the JAX package's `S2DConvBN`, `SplitHeadConv` and `_batch_chunked`
(re-arrangements for the TPU's matrix unit and memory).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward, kernel_weight

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def bn2d(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True) -> nn.Sequential:
    """Conv (no bias) + BatchNorm + optional ReLU (`ConvBN` of the JAX package)
    as the reference's `Sequential(conv, bn[, relu])`."""
    pad = dilation * (kernel - 1) // 2
    mods: List[nn.Module] = [
        nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=False),
        bn2d(cout),
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
        self.bn1 = bn2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, stride=1, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = bn2d(cout)

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
        self.bn = bn2d(cout)
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
        # one-level tree reads its output. A deeper tree still runs it in
        # train mode, as the reference and the JAX package do at every call:
        # its BatchNorm statistics are part of a trained checkpoint.
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
        if self.project is not None and self.training:
            with torch.no_grad():
                self.project(bottom)                     # running statistics only
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

    def _weight_hwio(self, dtype: torch.dtype):
        """`weight` in `dtype` as the HWIO operand in the kernel's memory
        layout, copied once and kept until the parameter is written to, moved
        or cast. Where a gradient is being recorded it is a view of the
        parameter (cast to `dtype` if need be) instead."""
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(dtype).permute(2, 3, 1, 0)
        key = (w.data_ptr(), w._version, w.dtype, w.device, dtype)
        if self._hwio is None or self._hwio[0] != key:
            self._hwio = (key, kernel_weight(w.detach().to(dtype)))
        return self._hwio[1]

    def operands(self, x):
        """The five NHWC operands of the deformable convolution for the
        NCHW-shaped input `x`: (x, offset, mask, weight HWIO, bias), all in
        one type. Under `torch.autocast` (the mixed-precision train step)
        that is the autocast type, as for the convolutions around the block:
        autocast does not reach the deformable convolution's own function,
        so the operands are cast here; the float32 parameters receive their
        gradients through the casts. Otherwise it is the parameters' type."""
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else self.weight.dtype
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        om = self.conv_offset_mask(x).contiguous(memory_format=torch.channels_last)
        om = om.permute(0, 2, 3, 1)                      # NHWC view, contiguous
        offset = om[..., :18]
        mask = torch.sigmoid(om[..., 18:])
        return (x.permute(0, 2, 3, 1), offset, mask, self._weight_hwio(dtype),
                self.bias.to(dtype))

    def forward(self, x):
        out = dcn_v2_forward(*self.operands(x))          # [B, H, W, Co]
        return out.permute(0, 3, 1, 2)                   # NCHW view, channels_last


class DeformConvBlock(nn.Module):
    """DCNv2 + BN + ReLU (`DeformConv`, pose_dla_dcn.py:377-389)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.actf = nn.Sequential(bn2d(cout), nn.ReLU(inplace=True))
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


class TorchConvTranspose(nn.ConvTranspose2d):
    """Full transposed conv x2 of the ResNet deconv stages:
    nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=False). The
    weight is [cin, cout, 4, 4]; the JAX package stores the same numbers as
    [4, 4, cin, cout] and flips them when it applies them as an ordinary
    convolution, so no flip is needed here. Init: uniform in
    +-1/sqrt(cin * 16), or with `bilinear_init` (resdcn) the reference's
    `fill_up_weights` on a full weight, which writes the bilinear stencil
    into output channel 0 of every input channel and leaves the others 0
    (resnet_dcn.py:22-31, kept as the reference has it)."""

    def __init__(self, cin: int, cout: int, bilinear_init: bool = False):
        super().__init__(cin, cout, 4, stride=2, padding=1, bias=False)
        self.bilinear_init = bilinear_init
        self.reset(None)

    def reset(self, generator: Optional[torch.Generator]) -> None:
        with torch.no_grad():
            if self.bilinear_init:
                self.weight.zero_()
                self.weight[:, 0] = bilinear_upsample_kernel(2)
            else:
                bound = 1.0 / math.sqrt(self.weight.shape[0] * 16)
                self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return super().forward(x).contiguous(memory_format=torch.channels_last)


class HeadConv(nn.Sequential):
    """Prediction head: 3x3 conv -> [GroupNorm] -> ReLU -> 1x1 conv
    (pose_dla_dcn.py:491-521), `head_conv` > 0 channels wide (`make_head`
    builds the head for any `head_conv`). GroupNorm(32, eps 1e-5) is inserted
    when the convGRU chain is active; heatmap heads get a -2.19 output bias."""

    def __init__(self, cin: int, classes: int, head_conv: int = 256,
                 use_gn: bool = False, bias_init_value: float = 0.0):
        mods: List[nn.Module] = [nn.Conv2d(cin, head_conv, 3, padding=1)]
        if use_gn:
            groups = 32 if head_conv % 32 == 0 else 16
            mods.append(nn.GroupNorm(groups, head_conv, eps=1e-5))
        mods.append(nn.ReLU(inplace=True))
        mods.append(nn.Conv2d(head_conv, classes, 1))
        super().__init__(*mods)
        self.bias_init_value = bias_init_value
        nn.init.constant_(self[-1].bias, bias_init_value)


class BareHead(nn.Conv2d):
    """The `head_conv <= 0` head: one 1x1 conv with bias, a bare `nn.Conv2d`
    in the reference (state_dict keys `hm.weight`, `hm.bias`;
    pose_dla_dcn.py:513-520); heatmap heads get a -2.19 bias."""

    def __init__(self, cin: int, classes: int, bias_init_value: float = 0.0):
        super().__init__(cin, classes, 1)
        self.bias_init_value = bias_init_value
        nn.init.constant_(self.bias, bias_init_value)


def make_head(cin: int, classes: int, head_conv: int, use_gn: bool = False,
              bias_init_value: float = 0.0) -> nn.Module:
    """`HeadConv` for `head_conv` > 0, else `BareHead` (no GroupNorm: there is
    no hidden layer to normalise)."""
    if head_conv > 0:
        return HeadConv(cin, classes, head_conv, use_gn, bias_init_value)
    return BareHead(cin, classes, bias_init_value)


def head_output_conv(head: nn.Module) -> nn.Conv2d:
    """The conv whose bias carries a head's `bias_init_value`."""
    return head if isinstance(head, nn.Conv2d) else head[-1]


def param_dtype(module: nn.Module) -> torch.dtype:
    """The type the network computes in (serving): that of its parameters."""
    return next(module.parameters()).dtype


def to_nchw(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """NHWC batch -> NCHW view in `dtype` (channels_last memory)."""
    return None if t is None else t.to(dtype).permute(0, 3, 1, 2)


def heads_to_nhwc(out, names) -> dict:
    """NCHW head maps -> contiguous NHWC, in the order of `names`."""
    return {h: out[h].permute(0, 2, 3, 1).contiguous() for h in names}
