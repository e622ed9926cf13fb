"""The plain CenterPose network (dlav1_34, the image model) in float32
PyTorch, the reference the benchmark holds the port against.

A frozen copy of the port's module structure (`centerpose_tpu_torch/models/
{layers,dla,conv_gru,centerpose}.py`, taken when the benchmark was defined),
so that its `state_dict` carries the NVlabs reference names and shapes the
port loads: `base.level2.tree1.conv1.weight`, `dla_up.ida_0.proj_1.conv.
conv_offset_mask.weight`, `convGRU.cell0.Wir.weight`, `hm.3.bias`, ... What
it leaves out: the kernels (the deformable convolution is the plain
`reference/dcn.py::dcn_v2`), channels_last layouts, the data-parallel
BatchNorm, the other architectures and the tracking model. Inputs are NHWC, outputs a dict of NHWC
head maps, as the port's.

`NetSpec` holds what the network's shape depends on; `spec_of` reads it from
a configuration file of `posebench/configs/`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from posebench.reference.dcn import dcn_v2

NUM_JOINTS = 8
DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)
FIRST_LEVEL, LAST_LEVEL = 2, 5
GRU_HIDDEN = 64
GRU_STEPS = 3
# The ConvGRU step whose state feeds each head.
GRU_GROUPS = (("hm", "wh", "reg"), ("hm_hp", "hp_offset", "hps"), ("scale",))
HEADS = (("hm", 1), ("wh", 2), ("hps", 2 * NUM_JOINTS), ("reg", 2), ("hm_hp", NUM_JOINTS),
         ("hp_offset", 2), ("scale", 3))


@dataclasses.dataclass(frozen=True)
class NetSpec:
    arch: str                       # dlav1_34
    heads: Tuple[Tuple[str, int], ...] = HEADS
    head_conv: int = 256


def spec_of(config: dict) -> NetSpec:
    if config["arch"] != "dlav1_34":
        raise ValueError(f"the reference network is dlav1_34, not {config['arch']!r}")
    return NetSpec(arch=config["arch"], head_conv=int(config["head_conv"]))


def bn2d(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def conv_bn_relu(cin, cout, kernel=3, stride=1, relu=True) -> nn.Sequential:
    mods: List[nn.Module] = [nn.Conv2d(cin, cout, kernel, stride=stride,
                                       padding=(kernel - 1) // 2, bias=False), bn2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = bn2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = bn2d(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + residual)


class Root(nn.Module):
    def __init__(self, cin, cout, residual=False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = bn2d(cout)
        self.residual = residual

    def forward(self, children):
        x = self.bn(self.conv(torch.cat(list(children), dim=1)))
        return torch.relu(x + children[0] if self.residual else x)


class Tree(nn.Module):
    def __init__(self, levels, cin, cout, stride=1, level_root=False, root_dim=0,
                 root_residual=False):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        self.levels, self.level_root = levels, level_root
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_residual=root_residual)
            self.tree2 = Tree(levels - 1, cout, cout, 1, root_dim=root_dim + cout,
                              root_residual=root_residual)
        self.downsample = nn.MaxPool2d(stride, stride=stride) if stride > 1 else None
        self.project = conv_bn_relu(cin, cout, 1, relu=False) if cin != cout else None

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = self.downsample(x) if self.downsample is not None else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = self.project(bottom) if self.project is not None else bottom
            x1 = self.tree1(x, residual)
            return self.root([self.tree2(x1), x1] + children)
        if self.project is not None and self.training:
            with torch.no_grad():
                self.project(bottom)                 # running statistics only
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DCN(nn.Module):
    """DCNv2 with its offset/mask conv: 27 channels, [0:18] the (dy, dx) of
    each tap, [18:27] the gates' logits."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.conv_offset_mask = nn.Conv2d(cin, 27, 3, padding=1)
        self.shape_only = False          # FLOP counting on the meta device

    def forward(self, x):
        om = self.conv_offset_mask(x)
        if self.shape_only:
            return x.new_empty(x.shape[0], self.weight.shape[0], x.shape[2], x.shape[3])
        if torch.is_grad_enabled():
            # The plain sampler keeps [B*H*W, 9C] blends for its backward; at
            # a training batch they would not fit beside the network, so the
            # block is recomputed in the backward pass instead.
            return checkpoint(_deform, x, om, self.weight, self.bias, use_reentrant=False)
        return _deform(x, om, self.weight, self.bias)


def _deform(x, om, weight, bias):
    om = om.permute(0, 2, 3, 1)
    out = dcn_v2(x.permute(0, 2, 3, 1), om[..., :18], torch.sigmoid(om[..., 18:]),
                 weight.permute(2, 3, 1, 0), bias)
    return out.permute(0, 3, 1, 2)


class DeformConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.actf = nn.Sequential(bn2d(cout), nn.ReLU())
        self.conv = DCN(cin, cout)

    def forward(self, x):
        return self.actf(self.conv(x))


def bilinear_upsample_kernel(factor: int) -> torch.Tensor:
    size = factor * 2
    f = math.ceil(size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    r = torch.arange(size, dtype=torch.float32)
    k1 = 1 - torch.abs(r / f - c)
    return k1[:, None] * k1[None, :]


class UpsampleConv(nn.ConvTranspose2d):
    """Depthwise transposed conv x`factor`, bilinear at initialisation."""

    def __init__(self, channels, factor):
        super().__init__(channels, channels, factor * 2, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        self.factor = factor
        with torch.no_grad():
            self.weight.copy_(bilinear_upsample_kernel(factor)[None, None].expand_as(self.weight))


class DLA(nn.Module):
    def __init__(self):
        super().__init__()
        ch, lv = DLA34_CHANNELS, DLA34_LEVELS
        self.base_layer = conv_bn_relu(3, ch[0], 7)
        self.level0 = _conv_level(ch[0], ch[0], lv[0])
        self.level1 = _conv_level(ch[0], ch[1], lv[1], stride=2)
        self.level2 = Tree(lv[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(lv[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(lv[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(lv[5], ch[4], ch[5], 2, level_root=True)

    def forward(self, x):
        x = self.base_layer(x)
        outs = []
        for name in ("level0", "level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            outs.append(x)
        return outs


def _conv_level(cin, cout, convs, stride=1) -> nn.Sequential:
    mods: List[nn.Module] = []
    for i in range(convs):
        mods.extend(conv_bn_relu(cin, cout, 3, stride if i == 0 else 1))
        cin = cout
    return nn.Sequential(*mods)


class IDAUp(nn.Module):
    def __init__(self, features, channels, up_factors):
        super().__init__()
        self.n = len(channels)
        for i in range(1, self.n):
            f = int(up_factors[i])
            setattr(self, f"proj_{i}", DeformConvBlock(int(channels[i]), features))
            if f > 1:
                setattr(self, f"up_{i}", UpsampleConv(features, f))
            setattr(self, f"node_{i}", DeformConvBlock(features, features))

    def forward(self, layers):
        out = [layers[0]]
        for i in range(1, self.n):
            x = getattr(self, f"proj_{i}")(layers[i])
            up = getattr(self, f"up_{i}", None)
            if up is not None:
                x = up(x)
            out.append(getattr(self, f"node_{i}")(x + out[i - 1]))
        return out


class DLAUp(nn.Module):
    def __init__(self, channels: Sequence[int]):
        super().__init__()
        channels = list(channels)
        self.n = len(channels)
        scales = np.array([2 ** i for i in range(self.n)], dtype=int)
        in_channels = list(channels)
        for i in range(self.n - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(channels[j], in_channels[j:],
                                            (scales[j:] // scales[j]).tolist()))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n - 1):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class ConvGRUCell(nn.Module):
    def __init__(self, cin, hidden=GRU_HIDDEN):
        super().__init__()
        self.Wir = nn.Conv2d(cin, hidden, 3, padding=1)
        self.Wiz = nn.Conv2d(cin, hidden, 3, padding=1)
        self.Win = nn.Conv2d(cin, hidden, 3, padding=1)
        self.Whr = nn.Conv2d(hidden, hidden, 3, padding=1, bias=False)
        self.Whz = nn.Conv2d(hidden, hidden, 3, padding=1, bias=False)
        self.Whn = nn.Conv2d(hidden, hidden, 3, padding=1, bias=False)

    def forward(self, x, h):
        r = torch.sigmoid(self.Wir(x) + self.Whr(h))
        z = torch.sigmoid(self.Wiz(x) + self.Whz(h))
        n = torch.tanh(self.Win(x) + r * self.Whn(h))
        return (1.0 - z) * n + z * h


class ConvGRU(nn.Module):
    def __init__(self, cin, steps):
        super().__init__()
        self.steps = steps
        self.cell0 = ConvGRUCell(cin)

    def forward(self, x):
        h = x.new_zeros((x.shape[0], GRU_HIDDEN, x.shape[2], x.shape[3]))
        outs = []
        for _ in range(self.steps):
            h = self.cell0(x, h)
            outs.append(h)
        return outs


def make_head(cin, classes, head_conv) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, head_conv, 3, padding=1),
                         nn.GroupNorm(32 if head_conv % 32 == 0 else 16, head_conv, eps=1e-5),
                         nn.ReLU(), nn.Conv2d(head_conv, classes, 1))


class CenterPoseNet(nn.Module):
    """dlav1_34 CenterPose network; NHWC in, NHWC head maps out."""

    def __init__(self, spec: NetSpec):
        super().__init__()
        self.spec = spec
        ch = DLA34_CHANNELS
        self.base = DLA()
        self.dla_up = DLAUp(ch[FIRST_LEVEL:])
        self.ida_up = IDAUp(ch[FIRST_LEVEL], ch[FIRST_LEVEL:LAST_LEVEL],
                            [2 ** i for i in range(LAST_LEVEL - FIRST_LEVEL)])
        self.convGRU = ConvGRU(ch[FIRST_LEVEL], GRU_STEPS)
        for name, classes in spec.heads:
            setattr(self, name, make_head(GRU_HIDDEN, classes, spec.head_conv))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        levels = self.base(x.permute(0, 3, 1, 2).contiguous())
        feat = self.ida_up(self.dla_up(levels[FIRST_LEVEL:])[: LAST_LEVEL - FIRST_LEVEL])[-1]
        names = [n for n, _ in self.spec.heads]
        states = self.convGRU(feat)
        out = {head: getattr(self, head)(states[step]) for step, group in enumerate(GRU_GROUPS) for head in group}
        return {h: out[h].permute(0, 2, 3, 1).contiguous() for h in names}


@contextlib.contextmanager
def _no_init():
    """Layers built within the block keep their storage uninitialised (the
    caller writes every value): construction then costs no init kernels."""
    kinds = (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d, nn.GroupNorm)
    saved = [(k, k.__dict__.get("reset_parameters")) for k in kinds]
    for k, _ in saved:
        k.reset_parameters = lambda self: None
    try:
        yield
    finally:
        for k, fn in saved:
            if fn is None:
                del k.reset_parameters
            else:
                k.reset_parameters = fn


def skeleton(spec: NetSpec) -> CenterPoseNet:
    """The network on the CPU with uninitialised values: its names, shapes
    and modules."""
    with _no_init():
        return CenterPoseNet(spec)


def build(spec: NetSpec, device, state: Optional[Dict[str, torch.Tensor]] = None) -> CenterPoseNet:
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


def dcn_modules(net: nn.Module) -> List[DCN]:
    return [m for m in net.modules() if isinstance(m, DCN)]
