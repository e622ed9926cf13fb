"""centerpose_tpu_torch — the PyTorch/CUDA package beside `centerpose_tpu`.

Category-level 6-DoF object pose from monocular RGB (CenterPose), written in
PyTorch for one NVIDIA Hopper GPU. The JAX package `centerpose_tpu` is the
reference this package is held against; nothing here imports it, or JAX.

What is here: the serving path of the image model — `dla_34` / `dlav1_34`
networks, the fused decode, batched PnP, on-device resampling and the
`Detector` around them — with the deformable convolution's forward pass as a
hand-written CUDA kernel (`csrc/dcn_v2_fwd.cu`, wrapped by `ops/dcn_fwd.py`);
the train step, whose backward pass runs the hand-written kernels of
`csrc/dcn_v2_bwd.cu`; and the CenterPoseTrack video path (the dla_34
tracking model, `tracking/`, the `Detector`'s tracking branch and the demo,
`python -m centerpose_tpu_torch.demo`). Evaluation, the training CLI and the
other architectures are not ported yet; ROADMAP.md lists them in order.

Entry points take an explicit `device` and default to `"cuda"`; asked for
`"cuda"` on a host without one they raise. Importing the package needs no
GPU, no `nvcc` and no `triton`: the kernel is built at its first launch.
"""

__version__ = "0.1.0"

from centerpose_tpu_torch.config import CenterPoseConfig, preset  # noqa: F401
from centerpose_tpu_torch.models.factory import create_model  # noqa: F401
from centerpose_tpu_torch.ops.dcn import dcn_v2  # noqa: F401
from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward  # noqa: F401
from centerpose_tpu_torch.inference.detector import Detector  # noqa: F401
