"""Cuboid vertex convention.

Parity target: `src/lib/utils/pnp/cuboid_objectron.py:13-110`. The vertex ORDER is
load-bearing — it defines the channel order of the 8 keypoint heads and the Objectron
annotation order. The reference's `Cuboid3d.generate_vertexes` emits corners in
binary-counting order over (x, y, z) sign bits:

    idx 0: (-x, -y, -z)  left  bottom rear      idx 4: (+x, -y, -z) right bottom rear
    idx 1: (-x, -y, +z)  left  bottom front     idx 5: (+x, -y, +z) right bottom front
    idx 2: (-x, +y, -z)  left  top    rear      idx 6: (+x, +y, -z) right top    rear
    idx 3: (-x, +y, +z)  left  top    front     idx 7: (+x, +y, +z) right top    front

with size3d = (width=x, height=y, depth=z). Objectron's 9-point annotation prepends
the box center at index 0; keypoint heads use only the 8 corners in this order.

The PyTorch package's own copy of `centerpose_tpu/geometry/cuboid.py`.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np


class CuboidVertexType(enum.IntEnum):
    """Named corner semantics (enum values match the reference enum, which is a
    *different* numbering from the emitted vertex order documented above)."""

    FrontTopRight = 0
    FrontTopLeft = 1
    FrontBottomLeft = 2
    FrontBottomRight = 3
    RearTopRight = 4
    RearTopLeft = 5
    RearBottomLeft = 6
    RearBottomRight = 7
    Center = 8

    TotalCornerVertexCount = 8
    TotalVertexCount = 9


# Edges as index pairs into the 8-corner binary ordering (for visualization).
# Two corners share an edge iff their sign-bit patterns differ in exactly one bit.
CUBOID_EDGES: Tuple[Tuple[int, int], ...] = tuple(
    (a, b)
    for a in range(8)
    for b in range(a + 1, 8)
    if bin(a ^ b).count("1") == 1
)


def cuboid_vertices(size3d, include_center: bool = False) -> np.ndarray:
    """8 (or 9) corner coordinates of an origin-centered cuboid.

    Args:
      size3d: (width, height, depth) — full extents along x, y, z.
      include_center: prepend the (0,0,0) center as row 0 (Objectron 9-pt order).

    Returns:
      (8, 3) or (9, 3) float64 array in the binary-counting corner order.
    """
    w, h, d = [float(v) for v in size3d]
    half = np.array([w / 2.0, h / 2.0, d / 2.0])
    corners = np.empty((8, 3), dtype=np.float64)
    for i in range(8):
        sx = 1.0 if (i & 4) else -1.0  # x is the high bit
        sy = 1.0 if (i & 2) else -1.0
        sz = 1.0 if (i & 1) else -1.0  # z is the low bit
        corners[i] = half * np.array([sx, sy, sz])
    if include_center:
        return np.vstack([np.zeros((1, 3)), corners])
    return corners


def normalized_cuboid(scale) -> np.ndarray:
    """Unit cuboid used by the PnP shell: scale normalized by its y (height)
    component (`cuboid_pnp_shell.py:12`: `Cuboid3d(scale / scale[1])`)."""
    scale = np.asarray(scale, dtype=np.float64)
    return cuboid_vertices(scale / scale[1])
