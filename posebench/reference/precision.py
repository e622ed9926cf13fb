"""Lower-precision controls: the reference computed one step below the
precision a configuration states, which the comparison that decides
`correct` has to fail.

- `fp8(net)`: for a network served in bfloat16, every convolution (plain,
  transposed, the deformable one and its offset conv) reads its input and its
  weight, and writes its output, rounded to float8 e4m3 with one scale per
  tensor (amax to 448), and computes in float32 in between: what a network
  that keeps its weights and activations in fp8 computes.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from posebench.reference import net as refnet

E4M3_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale, back in its type."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
    return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)) * scale


def _kinds():
    return (nn.Conv2d, nn.ConvTranspose2d, refnet.DCN)


@contextlib.contextmanager
def fp8(net: nn.Module):
    """Within the block `net` runs its convolutions on fp8-rounded operands;
    its weights are restored on exit."""
    saved = {}
    hooks = []
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, _kinds()):
                saved[mod] = mod.weight.detach().clone()
                mod.weight.copy_(round_fp8(mod.weight))
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, args: (round_fp8(args[0]),) + tuple(args[1:])))
                hooks.append(mod.register_forward_hook(lambda m, args, out: round_fp8(out)))
    try:
        yield net
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for mod, w in saved.items():
                mod.weight.copy_(w)
