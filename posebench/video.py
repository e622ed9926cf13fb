"""The tracking cell's video, made from the run's seed on the device in bulk.

`n` distinct uint8 frames: two small white discs (radius `OBJECT_RADIUS`, a
one-pixel soft edge: to the network nearly points, whose response has one
peak) on black, drifting together along one smooth path, a sum of two sines
per axis whose speed never passes `max_step` px a frame. The second disc
lies `SPACING` to the right of the first, the pair centred in the frame, at
least `MARGIN` from its edges. At 640 px wide: a radius of 5 px, 200 px
apart (160 px of the 512 network input, five strides of its deepest level:
the two discs meet the network at the same phase, so that their peaks are
equal; offset by half an output cell, 3 of 12 runs lost a detection), a
margin of 120 px. Sizes are shares of the frame's width. `play_order(n)` plays the
frames forward then backward, so that motion never jumps.
"""

from __future__ import annotations

import numpy as np
import torch

OBJECT_RADIUS = 5 / 640
SPACING = 200 / 640
MARGIN = 120 / 640


def paths(seed: int, n: int, frame_hw, max_step: float) -> np.ndarray:
    """[n, 2, 2] (frame, object, (x, y)) centres in image pixels."""
    h, w = frame_hw
    spacing, margin = SPACING * w, MARGIN * w
    rng = np.random.default_rng([int(seed), 2])
    t = np.arange(n, dtype=np.float64)
    first = np.zeros((n, 2))
    for axis, (lo, hi) in enumerate(((margin, w - margin - spacing), (margin, h - margin))):
        periods = rng.uniform(0.5, 1.5, 2) * n
        phases = rng.uniform(0, 2 * np.pi, 2)
        # the two sines' amplitudes, so that the speed stays within max_step / sqrt(2) an axis
        amp = min((hi - lo) / 4, max_step / np.sqrt(2) / (2 * np.pi * (1 / periods).sum()))
        first[:, axis] = (lo + hi) / 2 + amp * (np.sin(2 * np.pi * t / periods[0] + phases[0])
                                                + np.sin(2 * np.pi * t / periods[1] + phases[1]))
    return np.stack([first, first + [spacing, 0.0]], axis=1)


def frames(seed: int, n: int, frame_hw, max_step: float, device) -> np.ndarray:
    """[n, H, W, 3] uint8 host frames from `seed`, made on `device`."""
    h, w = frame_hw
    centres = torch.as_tensor(paths(seed, n, frame_hw, max_step), dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, 16):                    # 16 frames at a time: a few hundred MB at most
        c = centres[s:s + 16]
        disc = torch.zeros((c.shape[0], h, w), device=device)
        for obj in range(2):
            r = torch.sqrt((xs - c[:, obj, 0, None, None]) ** 2 + (ys - c[:, obj, 1, None, None]) ** 2)
            disc = torch.maximum(disc, (OBJECT_RADIUS * w - r).clamp(0, 1))
        out[s:s + 16] = (disc[..., None] * 255.0).round().to(torch.uint8).expand(-1, -1, -1, 3)
    return out.cpu().numpy()


def play_order(n: int) -> np.ndarray:
    """Frame indices of one period of forward-then-backward play:
    0, 1, ..., n-1, n-2, ..., 1."""
    return np.concatenate([np.arange(n), np.arange(n - 2, 0, -1)])
