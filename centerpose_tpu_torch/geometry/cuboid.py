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

The PyTorch package's own copy of `centerpose_tpu/geometry/cuboid.py::cuboid_vertices`.
"""

from __future__ import annotations

import numpy as np


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
