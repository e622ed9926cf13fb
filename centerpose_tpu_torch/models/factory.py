"""Model factory: arch string → `nn.Module`, counterpart of
`centerpose_tpu/models/factory.py`.

Ported: `dla_34` (DLA-34 + DCN neck, plain heads; with `tracking_task` the
CenterPoseTrack model) and `dlav1_34` (the same with convGRU-chained heads,
image model only). The other architectures of the JAX package
(`dlav0_34`, `res_*`, `resdcn_*`, `hourglass`) raise `NotImplementedError`;
ROADMAP.md lists them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from centerpose_tpu_torch.config import CenterPoseConfig
from centerpose_tpu_torch.models.centerpose import CenterPoseNet
from centerpose_tpu_torch.models.layers import DCN, UpsampleConv

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of `model` from `generator` (no use of the
    global random state): convolutions uniform in ±1/sqrt(fan_in) like
    `nn.Conv2d`'s default, biases 0 except the heatmap heads' -2.19, DCN offset
    convs 0, upsamplers bilinear, norms at identity."""

    def uniform_(t: torch.Tensor, fan_in: int) -> None:
        bound = 1.0 / (fan_in ** 0.5)
        t.uniform_(-bound, bound, generator=generator)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, UpsampleConv):
                mod.reset_bilinear()
            elif isinstance(mod, DCN):
                uniform_(mod.weight, mod.weight[0].numel())
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                uniform_(mod.weight, mod.weight[0].numel())
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.BatchNorm2d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
        for mod in model.modules():
            if isinstance(mod, DCN):
                mod.conv_offset_mask.weight.zero_()
                mod.conv_offset_mask.bias.zero_()
            bias0 = getattr(mod, "bias_init_value", None)
            if bias0 is not None:
                mod[-1].bias.fill_(bias0)


def create_model(
    config: CenterPoseConfig,
    device: Union[str, torch.device] = "cuda",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build the network of `config.arch` in eval mode on `device`, in
    `config.compute_dtype`, channels_last. Weights are random, drawn from
    `generator` (seed 0 when None). Asked for "cuda" on a host without a GPU
    this raises; it never moves to the CPU by itself."""
    arch = config.arch
    name = arch.split("_")[0] if "_" in arch else arch
    if name not in ("dla", "dlav1"):
        if name in ("dlav0", "res", "resdcn", "hourglass"):
            raise NotImplementedError(
                f"arch {arch!r} is not ported to centerpose_tpu_torch yet; "
                "see ROADMAP.md (modules still to port)"
            )
        raise ValueError(f"unknown arch: {arch!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):       # leave the global state alone
        model = CenterPoseNet(config)
    reset_parameters(model, generator)
    model = model.to(device=torch.device(device), dtype=_DTYPES[config.compute_dtype])
    model = model.to(memory_format=torch.channels_last)
    return model.eval()
