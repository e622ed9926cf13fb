"""Inputs of a cell, made from the run's seed on the device in bulk.

`smooth_frames`: distinct smooth uint8 frames, each a random low-resolution
image upsampled bilinearly (the look of `chip_smoke.py::synthetic_video`'s
base image, without its PIL resize per frame).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _smooth(gen: torch.Generator, n: int, low_hw, out_hw, device) -> torch.Tensor:
    """[n, H, W, 3] uint8 on `device`: uniform noise of `low_hw` upsampled
    bilinearly to `out_hw`."""
    low = torch.randint(0, 256, (n, 3, *low_hw), generator=gen, device=device).to(torch.float32)
    up = F.interpolate(low, size=tuple(out_hw), mode="bilinear", align_corners=False)
    return up.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def smooth_frames(seed: int, n: int, frame_hw, low_hw, device) -> np.ndarray:
    """[n, H, W, 3] uint8 host frames from `seed`, made on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return _smooth(gen, n, low_hw, frame_hw, device).cpu().numpy()

