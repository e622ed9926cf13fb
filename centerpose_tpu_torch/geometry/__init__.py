"""Host-side (numpy) geometry used by the detector."""

from centerpose_tpu_torch.geometry.affine import (  # noqa: F401
    affine_transform_points,
    get_affine_transform,
    transform_preds,
    warp_affine,
)
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices  # noqa: F401
