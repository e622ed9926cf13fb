#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

drives `centerpose_tpu_torch`'s serving path and its training paths (float32,
bf16 mixed precision, and the training CLI on the package's own synthetic
data) at the full width of the flagship model (dlav1_34 at 512x512, random
weights from seed 0), its video-tracking path with the CenterPoseTrack
model (dla_34 at 512x512, one frame per call), its evaluation CLI (AP of
both models over generated frames, and the validation loss), and the other
architectures (res_18, resdcn_18, dlav0_34, hourglass at 512x512, served
and trained) through the entry points a user calls, builds the CUDA
kernels from the sources in this checkout, holds each against its plain
PyTorch version on the card, and shows that every path really went through
them. Every phase prints one JSON line; a phase
that fails raises and the process exits non-zero. Without a CUDA device it
exits with code 2 and prints no result. It imports nothing of JAX.

Phases:
  env      versions, the card's name and power limit.
  build    nvcc builds csrc/*.cu, one compiler per source, all started
           together (seconds; the compiler's register / shared memory report
           is printed).
  kernels  `dcn_v2_forward` against `dcn_v2` on the 7 distinct DCN shapes of
           one dlav1_34 (or dla_34) forward at 512x512, float32 and bfloat16:
           uniform +-3 offsets, integer offsets, every sample off the image,
           and |dy| up to 20 (where the TPU's `_row_kernel` would drop taps),
           each at B=2 and at B=1 (what `Detector.run` and the tracking path
           give it; times at B=1 too); then agreement and times at the
           serving batch B=8; then tails (C, Co) in TAIL_SHAPES on a 9x11 map
           at B=1 and 2, uniform and off-image offsets, in both types (the
           float32 ones with the K loop split). Each body's tile, grid and
           dynamic shared memory per shape (float32: also the split and the
           scratch) are printed, and must be what `ops/dcn_fwd.py::bf16_plan`
           and `f32_plan` state, at B=8 and B=1 and at the tails. The
           float32 output must be the same bits in two calls at every shape
           at B=8 and B=1; the float32 call's weight split is timed alone.
           Per-call times are the device's: the calls are queued behind a
           device sleep, so a call shorter than its launch from Python is not
           timed by the host's pace. With `--compare LABEL=PATH`, each other
           build of the forward source is also held against the plain
           version and timed in turns with this one (other, this, this,
           other) at every shape at B=8 and B=1, in both types (a build
           without `dcn_v2_fwd_f32_plan` through its own float32 interface),
           and the sums over one forward's 16 calls are printed after the
           model phase (`compared_totals`). Operands
           are made as the network makes them: offset (and, in one case, the
           mask) a channel slice of one [B, H, W, 27] tensor, the weight in
           the kernel's memory layout.
           Tolerances: float32 1e-4 absolute (summation order of a
           9*C-term product); bfloat16 3e-2 of the output's largest
           magnitude (bf16 inputs and one rounding of columns and output).
           float32 comparisons run with TF32 switched off for cuDNN and
           matmul.
  kernels_bwd
           The four backward kernels, float32, on the same 7 shapes:
           `dcn_v2_grads(fused=True)` (one launch) and `(fused=False)` (the
           dX, coordinate and dW kernels) against `dcn_v2_grads_plain`, each
           of the five terms by name, for the four offset kinds at B=2 and
           at the training batch B=8, then on the tails BWD_TAIL_SHAPES (a
           9x11 map at B=1 and 2; the last has Co > 256, which the wrapper
           cuts into two launches); tolerance per term 1e-4 of the term's
           largest magnitude plus 1e-5 (sums of up to B*H*W or 9*C*Co terms
           of 3xTF32 products, dX in the order the atomics land). Each
           kernel's tiling, grid, shared memory and scratch per shape is
           printed and must be what `ops/dcn_bwd.py::bwd_plan` states; each
           kernel is called twice on the same operands and dW, d_offset and
           d_mask must be the same bits (dX, a sum of atomics, is only
           reported). Times per shape at B=8 are device times (calls queued
           behind a device sleep). With `--compare LABEL=PATH` naming a
           `dcn_v2_bwd.cu`, that build's four kernels are held against the
           plain version and timed in turns with this checkout's (other,
           this, this, other) at every shape.
  kernels_bwd_bf16
           The same four kernels on bf16 operands (their bf16 body, what the
           mixed-precision train step runs) against `dcn_v2_grads_plain` on
           the same bf16 values (float32 products and sums): the 7 shapes x 4
           offset kinds at B=2, one case at B=8, the tails; per term within
           TOL_BWD_BF16 (2e-2 of the term's largest magnitude + 1e-3: the
           kernels also round gs and the modulated samples to bf16 as the TPU
           kernels do, 2^-9 each, and return bf16 terms); the worst error
           relative to each term's largest magnitude is printed. Plans equal
           to `bwd_plan(dtype=bf16)`, dW / d_offset / d_mask the same bits in
           two calls, device times per call at B=8 with bounds at the bf16
           rate (989 TFLOP/s) and 3.35 TB/s.
  model    the bf16 network + decode on a [8, 512, 512, 3] batch as the JAX
           package's bench.py runs it: the kernel launches of one forward
           counted by shape (16 in all), output
           shapes, finite values, ms per batch, share of the forward spent in
           the DCN kernel; then a float32 forward against the same network
           with the plain DCN, head by head (max abs diff <= 2e-3).
  serve    a `Detector` (bf16, vis_thresh 0.05 so that random weights give
           detections) answers three `run(image)` requests and one
           `run_batch` of 8; the launch counter is set to 0 just before and
           read just after, and every shape must have been launched 4 times
           what one forward launched. Then a planted-pose PnP check on the
           card.
  track    CenterPoseTrack: `Detector(preset("centerpose_track"))`, float32,
           512x512, weights from `track_weights` (He-normal from seed 0, five
           heads set so that random weights give a coherent video;
           vis_thresh and new_thresh 0.2), runs a synthetic 24-frame 480x640
           video (one seeded image moved by (2, 3) pixels a frame) through
           `run` frame by frame: warp, previous-frame render, stems, network,
           decode on the card; soft-NMS, fusion, PnP, association, Kalman
           filter, scale pool and the batched re-PnP. Required: 16 kernel
           launches in every frame (the counter set to 0 before each), a
           non-zero pre_hm, a track id detected in 3 consecutive frames after
           the 4 warm-up frames, and re-PnP solves. Stage medians from frame
           4 on, frames/s, the 16 launches of a frame timed in place; the
           same frames in bfloat16 (16 launches per frame); and the float32
           network with previous-frame inputs through the kernel against the
           plain DCN, head by head (max abs diff <= 2e-3).

  train    `create_train_state` + `make_train_step` for the float32 network at
           512x512, batch 8 (lowered, and said so, only if the card's memory
           does not hold it), on a synthetic batch from `render_targets`: a
           warm-up step and 3 timed steps, then two fine-tuning steps (the
           DCN weights frozen; only the DCN weights trained), which send
           `DCNv2Function.backward` through the three single-term kernels.
           Every launch counter is set to 0 just before and read just after.
           Required: finite losses, the loss of the last full step below the
           first's, every parameter's gradient finite, 16 forward and 16
           fused-backward launches per full step, by shape as the model
           phase counted them. Then, at 128x128 and batch 2, the network
           through the kernels against the same network through the plain
           DCN: every gradient with BatchNorm on running statistics within
           1e-3 of the parameter's largest gradient (ten times the kernels'
           tolerance, for 16 blocks in sequence), and one train step's loss
           within 1e-4 relative and gradient within 1 % in L2 norm (through
           thirty BatchNorms on the batch statistics of 2 images the order
           in which the atomics land is amplified: float32 holds that
           gradient to about a percent between two libraries, and between these
           two routes, which share every other kernel, to about 1e-4).
           One more step under `torch.profiler`: device time by kernel family.
  train_bf16
           The mixed-precision step (`compute_dtype="bfloat16"`: float32
           parameters, BatchNorm statistics and Adam, the forward under
           autocast, the DCN kernels on bf16 operands) at 512x512, batch 8:
           one float32 and one bf16 step from the same weights on the same
           batch, global gradient norms within 5 %; then a warm-up and 3
           timed bf16 steps and the two fine-tuning steps, the counters set
           to 0 just before and read just after: 16 bf16 forward and 16 bf16
           fused backward launches per full step, the bf16 dX, coordinate and
           dW bodies in the fine-tuning steps, no float32 launch, finite
           losses, float32 gradients. ms per step, images/s and peak memory
           beside the float32 step's, and a profiled step.
  train_cli
           `python -m centerpose_tpu_torch.train` in process: the package's
           generator writes two videos of 8 frames of 640x480 into a
           temporary directory; one epoch (2 steps) at 512x512, bf16, batch
           8, 2 loader workers, with validation and checkpoints, then
           `--resume` for one more. The step 2 -> 4, finite losses,
           checkpoints, bf16 launches per step and per validation batch; ms
           per step and the share spent waiting for the loader.
  evaluate `python -m centerpose_tpu_torch.evaluate` in process: the
           package's generator writes 2 videos of 8 frames of 640x480 into a
           temporary directory (and `data/tfrecord.py::pack_dope_dataset`
           packs them); at 512x512 float32 with a fresh process's TF32
           switches, `--mode metric` on dlav1_34 (a `.pth` of seed 0 with
           offset convs drawn), `--tracking` on the dla_34 tracking model
           (`track_weights`), both at vis_thresh 0.05 so that random weights
           give detections, PnP, matching and AP work; the tfrecords with
           `--n_proc 2` (spawned workers on the card), whose report must
           equal the in-process one; `--mode loss` on a `save_checkpoint`
           directory. Counters set to 0 before each run and read after, DCN
           calls counted by shape: 16 float32 forward launches per image
           and per loss batch. images/s and ms per image split into
           `Detector.run` and the evaluator (`evaluate_image`; `report` +
           `report_dict`), num_gt / num_pred, AP at the report points,
           losses, ms per batch.
  kernels_r50
           resdcn_50's first DCN at 512x512 (16x16, C 2048 -> Co 256, K = 9 x
           2048, a K no DLA shape has) at batch 8: the forward in float32 and
           bf16 and the fused backward in float32 and bf16 against the plain
           versions at the kernels phases' tolerances; plans, times and
           bounds (not part of the 16-call totals).
  archs    res_18, resdcn_18, dlav0_34 and hourglass, `preset("centerpose_dla",
           arch=A)` at 512x512 (head_conv 256; the hourglass's heads are 256
           wide by construction), random weights from seed 0, resdcn's offset
           convs drawn by `randomize_offset_convs`. Each: a bf16 `Detector`
           loads a reference checkpoint of another model of the arch
           (`{epoch, state_dict}`, `module.` prefixes, dlav0 with the
           trunk's `base.fc.*`) through `load_reference_state_dict`, and its
           outputs must be that model's to the bit; then `run_batch` on 8
           frames of 480x640 and one `run` (counters set to 0 just before,
           read just after), net + decode ms per batch of 8; then
           `make_train_step` at batch 8 in float32 (TF32 off) and in bf16
           mixed precision: a warm-up and 3 timed steps each, ms per step,
           images/s, peak memory. resdcn_18 must launch the forward kernel
           3 times per forward and the fused backward 3 times per step, in
           each type, at shapes the kernels phase holds (PRODUCTION_SHAPES);
           the other three none. resdcn_18 also goes through the kernels
           against the plain DCN at 128x128 (the train phase's bounds), and
           its kernels' share of each step is computed from this run's
           per-call times. One line per architecture.

Bounds: float32 operations are counted at the rate of float32-accurate
products on the tensor cores (3xTF32: a third of 495 TFLOP/s), bf16 at 989
TFLOP/s, bytes at 3.35 TB/s; a kernel timed under its bound fails the run.

`--out DIR` also writes every phase's line and the kernel table to
`DIR/chip_smoke_kernels.json`. `--compare LABEL=PATH` (repeatable) adds an
earlier version of `csrc/dcn_v2_fwd.cu` to the kernels phase's timings (both
bodies), or of `csrc/dcn_v2_bwd.cu` to the kernels_bwd phase, e.g. the
parent commit's, unpacked into a git-ignored directory:

    git archive HEAD~1 centerpose_tpu_torch/csrc | tar -x -C _parent
    python3 chip_smoke.py --out DIR --compare parent=_parent/centerpose_tpu_torch/csrc/dcn_v2_fwd.cu

`--clock` adds to the kernels_bwd phase, per production shape, the cycles a
block of the fused backward kernel spends per 64-pixel tile in each of its
phases (clock64() at its barriers, thread 0 of every block), for this
checkout's source and each compared one that has a plan, for its float32
body and, where the build has one, its bf16 body.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
    sys.exit(2)

from centerpose_tpu_torch import _build  # noqa: E402
from centerpose_tpu_torch.config import preset  # noqa: E402
from centerpose_tpu_torch.data.targets import ObjectAnnotation, render_targets, stack_batch  # noqa: E402
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices  # noqa: E402
from centerpose_tpu_torch.inference.detector import DEFAULT_CAMERA, Detector  # noqa: E402
from centerpose_tpu_torch.models import layers  # noqa: E402
from centerpose_tpu_torch.models.factory import create_model  # noqa: E402
from centerpose_tpu_torch.ops import dcn_bwd  # noqa: E402
from centerpose_tpu_torch.ops.dcn import dcn_v2  # noqa: E402
from centerpose_tpu_torch.ops import dcn_fwd  # noqa: E402
from centerpose_tpu_torch.ops.dcn_fwd import (  # noqa: E402
    bf16_plan,
    dcn_v2_forward,
    f32_plan,
    kernel_bf16_plan,
    kernel_f32_plan,
    kernel_weight,
)
from centerpose_tpu_torch.ops.decode import object_pose_decode  # noqa: E402
from centerpose_tpu_torch.ops.pnp import solve_pnp_batch_padded  # noqa: E402
from centerpose_tpu_torch.training.losses import centerpose_loss  # noqa: E402
from centerpose_tpu_torch.training.trainer import (  # noqa: E402
    create_train_state,
    loss_config_from,
    make_train_step,
)

DEVICE = torch.device("cuda")
# A fresh process's TF32 switches (cuDNN's convolutions, matmuls), read before
# the kernels phase turns them off: what the CLIs and their workers run with.
TF32_DEFAULTS = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
# `--out DIR`: also write the phases' lines and the kernel table to
# DIR/chip_smoke_kernels.json.
OUT_DIR = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv[1:-1] else None
# `--compare LABEL=PATH` (repeatable): another build of a kernel's source, an
# earlier version of csrc/dcn_v2_fwd.cu (timed in turns with this checkout's at
# every shape of the kernels phase, both types) or of csrc/dcn_v2_bwd.cu (every
# backward kernel at every production shape of the kernels_bwd phase).
COMPARE = [sys.argv[i + 1].split("=", 1) for i, a in enumerate(sys.argv[:-1]) if a == "--compare"]
def _is_backward_source(path: str) -> bool:
    with open(path) as fh:
        return "dcn_v2_bwd_fused_launch" in fh.read()


COMPARE_FWD = [(k, p) for k, p in COMPARE if not _is_backward_source(p)]
COMPARE_BWD = [(k, p) for k, p in COMPARE if _is_backward_source(p)]
# `--clock`: the kernels_bwd phase also builds a copy of each backward source
# with clock64() read at its block barriers and reports, per shape, the
# cycles a block spends per 64-pixel tile in each phase of the fused kernel.
CLOCK = "--clock" in sys.argv[1:]
PHASES = []

# The distinct (H = W, C, Co) of the 16 DCN blocks of one dlav1_34 forward at
# 512x512 (centerpose_tpu/models/dla.py:382-405, models/centerpose.py:112-133).
# It only chooses what the kernels phase tests: how often the network launches
# each is counted in the model phase, and a shape missing here fails there.
PRODUCTION_SHAPES = (
    (128, 64, 64), (64, 128, 128), (64, 128, 64), (32, 256, 256),
    (32, 256, 128), (32, 256, 64), (16, 512, 256),
)
INPUT = 512
SERVE_BATCH = 8
# (C, Co) of the forward's tail cases on a 9x11 map: a channel chunk, an
# output tile and a pixel tile that the kernel's tiles do not divide.
TAIL_SHAPES = ((8, 8), (24, 40), (72, 200), (64, 136))
TAIL_HW = (9, 11)
# The backward's tails: the same, and a Co wider than one launch takes.
BWD_TAIL_SHAPES = TAIL_SHAPES + ((16, 264),)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the yardstick of
# `bound_ms`, whatever power limit the card in hand is set to. A float32-
# accurate product is three TF32 products on the tensor cores (3xTF32: a_hi.b_hi
# + a_hi.b_lo + a_lo.b_hi), so float32 operations are counted at a third of the
# TF32 rate, whatever implements them (the FMA units' 67 TFLOP/s are slower).
PEAK_TF32 = 495e12
TF32_PRODUCTS_PER_F32 = 3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: PEAK_TF32 / TF32_PRODUCTS_PER_F32}
PEAK_BYTES = 3.35e12
# Device sleep before a queued timing: ~3 ms at the H100's 1.98 GHz boost,
# more than the host takes to enqueue 20 kernel calls from Python.
QUEUE_CYCLES = 6_000_000
TOL_F32 = 1e-4
TOL_BF16_REL = 3e-2

KERNEL_SOURCE = "centerpose_tpu_torch/csrc/dcn_v2_fwd.cu"
KERNEL_REPLACES = "centerpose_tpu/ops/dcn_onehot.py:237"

# The track phase (see `track_weights`): frames, frames before the medians,
# thresholds lowered from 0.3 for random weights, and the heatmap bias shift.
TRACK_FRAMES = 24
TRACK_WARMUP = 4
TRACK_VIS_THRESH = 0.2
TRACK_NEW_THRESH = 0.2
TRACK_HM_SHIFT = 7.0
ROW_KERNEL_REPLACES = "centerpose_tpu/ops/dcn_onehot.py:97"

TRAIN_BATCH = 8
TRAIN_STEPS = 3
# Per term of the gradient: |err| <= TOL_BWD_REL * max|plain| + TOL_BWD_ABS.
TOL_BWD_REL = 1e-4
TOL_BWD_ABS = 1e-5
# The same on bf16 operands, against the plain version on the same bf16
# values summed in float32: the kernels also round gs and the modulated
# samples to bf16 (2^-9 of each, as the TPU kernels do), and the output to
# bf16 (2^-9 of the term); a few 2^-8 of the term's largest magnitude, plus
# an absolute floor for terms that cancel to near 0.
TOL_BWD_BF16 = {"rel": 2e-2, "abs": 1e-3}
GRAD_NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")
BWD_SOURCE = "centerpose_tpu_torch/csrc/dcn_v2_bwd.cu"
# name -> (wrapper, the TPU kernel it replaces, products it runs, terms it yields)
BWD_KERNELS = {
    "dcn_v2_bwd_fused": (dcn_bwd.dcn_v2_bwd_fused, "centerpose_tpu/ops/dcn_bwd.py:246", 2, (0, 1, 2, 3)),
    "dcn_v2_bwd_dx": (dcn_bwd.dcn_v2_bwd_dx, "centerpose_tpu/ops/dcn_bwd.py:121", 1, (0,)),
    "dcn_v2_bwd_dcoord": (dcn_bwd.dcn_v2_bwd_dcoord, "centerpose_tpu/ops/dcn_bwd.py:159", 1, (1, 2)),
    "dcn_v2_bwd_dw": (dcn_bwd.dcn_v2_bwd_dw, "centerpose_tpu/ops/dcn_bwd.py:203", 1, (3,)),
}


def require(cond, message) -> None:
    """A check that also holds under `python -O`."""
    if not cond:
        raise RuntimeError(str(message))


def emit(obj) -> None:
    if "phase" in obj:
        PHASES.append(obj)
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean time of fn() in ms: CUDA events around `iters` back-to-back calls
    after a warm-up. `queued`: the device first sleeps for ~QUEUE_MS, so the
    host has enqueued the calls before the first starts, and the time is the
    device's alone even for a call shorter than its launch from Python."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- env
def phase_env() -> str:
    smi = nvidia_smi_line()
    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[-2:]
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc, "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
    })
    return smi


def reset_launches() -> None:
    dcn_v2_forward.launches = dcn_v2_forward.launches_bf16 = 0
    for fn, *_ in BWD_KERNELS.values():
        fn.launches = fn.launches_bf16 = 0


# ------------------------------------------------------------------- build
def phase_build() -> None:
    t0 = time.time()
    compared = start_compared_builds()
    logs = _build.build_all()
    for label, job in compared:
        log, _ = job.communicate(timeout=900)
        require(job.returncode == 0, f"nvcc failed for --compare {label}:\n{log}")
        logs[f"compare:{label}"] = log
    args = make_case(0, 1, 8, 8, 8, torch.float32, "uniform")
    dout = dcn_v2_forward(*args)
    for fused in (True, False):                          # loads every entry point
        dcn_bwd.dcn_v2_grads(*args, dout, fused=fused)
    torch.cuda.synchronize()
    reset_launches()
    report = {
        name: [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln or "error" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "sources": _build.sources(), "ptxas": report})


# ----------------------------------------------------------------- kernels
def make_case(seed, b, hw, c, co, dtype, kind):
    """Operands of one DCN call on the card on an hw x hw map (or h x w for
    `hw = (h, w)`), made with numpy from `seed` and
    laid out as `models/layers.py::DCN.operands` lays them out: `offset` is
    the [..., :18] slice of a [B, H, W, 27] tensor (pixel stride 27), `mask`
    the sigmoid of its [..., 18:] slice (a tensor of its own, pixel stride
    9), and the weight starts as [Co, C, 3, 3] and goes through
    `kernel_weight`. The "integer" case instead holds gates in the last 9
    channels and hands the kernel that slice itself, so the mask's pixel
    stride is 27 there."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c)
    om = np.empty((b, h, w, 27))
    if kind == "uniform":
        om[..., :18] = (rng.rand(b, h, w, 18) * 2 - 1) * 3.0
    elif kind == "integer":
        om[..., :18] = rng.randint(-3, 4, (b, h, w, 18))
    elif kind == "off_image":
        om[..., 0:18:2] = -(h + 5.25)
        om[..., 1:18:2] = w + 7.5
    elif kind == "dy20":
        om[..., :18] = (rng.rand(b, h, w, 18) * 2 - 1) * 2.0
        om[..., 0:18:2] = (rng.rand(b, h, w, 9) * 2 - 1) * 20.0
    else:
        raise ValueError(kind)
    if kind == "integer":
        om[..., 18:] = rng.rand(b, h, w, 9)
    else:
        om[..., 18:] = rng.randn(b, h, w, 9) * 2.0
    weight = rng.randn(co, c, 3, 3) / np.sqrt(9 * c)
    bias = rng.randn(co) * 0.1
    x, om, weight, bias = (
        torch.from_numpy(a.astype(np.float32)).to(DEVICE, dtype) for a in (x, om, weight, bias)
    )
    offset = om[..., :18]
    mask = om[..., 18:] if kind == "integer" else torch.sigmoid(om[..., 18:])
    return [x, offset, mask, kernel_weight(weight), bias]


def dcn_bound_ms(b, hw, c, co, dtype):
    """Least time the card could take: max(operations / peak rate of the type,
    bytes of x + offset + mask + weight + bias + out / memory rate)."""
    flops = 2.0 * b * hw * hw * 9 * c * co
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = elem * (b * hw * hw * (c + 18 + 9 + co) + 9 * c * co + co)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def check_case(args, dtype):
    """max |kernel - plain| and the plain output's largest magnitude."""
    out = dcn_v2_forward(*args)
    torch.cuda.synchronize()
    ref = dcn_v2(*args)
    require(out.shape == ref.shape and out.dtype == dtype, "kernel output has the wrong shape or type")
    require(torch.isfinite(out).all(), "kernel output not finite")
    err = (out.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def plan_of(b, h, w, c, co):
    """The bf16 kernel's tile, grid and shared memory for one call, as the
    built kernel reports it; it must be the plan `ops/dcn_fwd.py` states."""
    plan = kernel_bf16_plan(b, h, w, c, co)
    require(plan == bf16_plan(b, h, w, c, co),
            f"kernel plan {plan} != bf16_plan {bf16_plan(b, h, w, c, co)} at {(b, h, w, c, co)}")
    return plan


def f32_plan_of(b, h, w, c, co):
    """The float32 kernel's tile, grid, split, shared memory and scratch for
    one call, as the built kernel reports it; it must be `f32_plan`'s."""
    plan = kernel_f32_plan(b, h, w, c, co)
    require(plan == f32_plan(b, h, w, c, co),
            f"kernel plan {plan} != f32_plan {f32_plan(b, h, w, c, co)} at {(b, h, w, c, co)}")
    return plan


def same_bits_f32(args):
    """The float32 kernel called twice on the same operands: the same bits
    (no atomics; the partials of a split K loop are added in a fixed order)."""
    with torch.no_grad():
        one = dcn_v2_forward(*args)
        two = dcn_v2_forward(*args)
    torch.cuda.synchronize()
    return bool(torch.equal(one, two))


def weight_split_ms(args):
    """Device time of the float32 call's first launch alone: the weight's
    K-major hi/lo copy (`dcn_v2_fwd_f32_weight_split`), 20 calls queued."""
    import ctypes

    weight = args[3].contiguous()
    c, co = weight.shape[2], weight.shape[3]
    w_split = torch.empty((2, co, 9 * c), dtype=torch.float32, device=DEVICE)
    fn = dcn_fwd._library().dcn_v2_fwd_f32_weight_split
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        err = fn(weight.data_ptr(), w_split.data_ptr(), c, co, torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"weight split launch failed: {err}")

    return time_ms(run, iters=20, queued=True)


def compared_library(kind, label):
    """The built library of `--compare label=PATH` (kind "fwd" or "bwd")."""
    import ctypes

    return ctypes.CDLL(str(_build.BUILD / f"libcompare-{kind}-{label}.so"))


def start_compared_builds():
    """One nvcc for each `--compare` source, started together (the build phase
    waits for them beside its own)."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for kind, pairs in (("fwd", COMPARE_FWD), ("bwd", COMPARE_BWD)):
        for label, path in pairs:
            out = _build.BUILD / f"libcompare-{kind}-{label}.so"
            jobs.append((label, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return jobs


def compared_launchers():
    """{label: {dtype: launch(args) -> out}} for each `--compare LABEL=PATH`
    of the forward source: built as `_build` builds csrc/*.cu, loaded beside
    this checkout's kernel (no launch is counted). bfloat16 goes through
    `dcn_v2_fwd_launch`; float32 through this checkout's wrapper with the
    build's own plan where the build exports `dcn_v2_fwd_f32_plan`, else
    (an earlier build, whose float32 body had no scratch) through
    `dcn_v2_fwd_launch(dtype=0)` with the [9C, Co] weight."""
    import ctypes

    launchers = {}
    for label, path in COMPARE_FWD:
        lib = compared_library("fwd", label)
        fn = lib.dcn_v2_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int

        def launch(args, fn=fn):
            x, offset, mask, weight, bias = args
            b, h, w, c = x.shape
            co = weight.shape[3]
            dtype = 1 if x.dtype == torch.bfloat16 else 0
            w_mat = weight.permute(3, 0, 1, 2).contiguous() if dtype else weight.contiguous()
            out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
            err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), w_mat.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), b, h, w, c, co, offset.stride(2),
                     mask.stride(2), dtype, torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"compared kernel launch failed: {err}")
            return out

        f32 = launch
        if hasattr(lib, "dcn_v2_fwd_f32_plan"):
            f32 = lambda args, lib=lib: dcn_fwd._launch_forward(*args, lib=lib)  # noqa: E731
        launchers[label] = {torch.bfloat16: launch, torch.float32: f32}
    return launchers


def compare_bodies(launchers, args, b, bound):
    """This checkout's kernel and each compared one at one case, in the
    case's type: the compared body's error against the plain version (bf16:
    relative to the output's largest magnitude; float32: absolute), and times
    in turns (other, this, this, other), 20 launches each."""
    dtype = args[0].dtype
    ref = dcn_v2(*args).float()
    scale = max(ref.abs().max().item(), 1e-12) if dtype == torch.bfloat16 else 1.0
    tol = TOL_BF16_REL if dtype == torch.bfloat16 else TOL_F32
    rows = {}
    with torch.no_grad():
        for label, by_dtype in launchers.items():
            launch = by_dtype[dtype]
            err = (launch(args).float() - ref).abs().max().item() / scale
            require(err <= tol, f"compared body {label} ({dtype}) disagrees with dcn_v2: {err}")
            t = [time_ms(lambda: launch(args), iters=20, queued=True),
                 time_ms(lambda: dcn_v2_forward(*args), iters=20, queued=True),
                 time_ms(lambda: dcn_v2_forward(*args), iters=20, queued=True),
                 time_ms(lambda: launch(args), iters=20, queued=True)]
            rows[label] = {"batch": b, "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                           "ratio": (t[1] + t[2]) / (t[0] + t[3]), "bound_ms": bound,
                           "other_max_rel_err" if dtype == torch.bfloat16 else "other_max_abs_err": err}
    return rows


def phase_kernels():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # (seed, B, kind): four kinds of offsets at B=2 and at B=1, the batch of
    # `Detector.run` and of the tracking path (one frame per call; |dy| > 4
    # is where the TPU's `_row_kernel` would drop taps, and the kernel must
    # still equal the exact plain version there), then the serving batch.
    # The last B=1 case and the last case are the ones timed.
    kinds = ("uniform", "integer", "off_image", "dy20")
    cases = [(s, 2, k) for s, k in enumerate(kinds)]
    cases += [(11 + s, 1, k) for s, k in enumerate(kinds[::-1])]
    cases += [(9, SERVE_BATCH, "integer"), (10, SERVE_BATCH, "uniform")]
    entries = []
    n_cases = 0
    launchers = compared_launchers()
    for hw, c, co in PRODUCTION_SHAPES:
        entry = {
            "name": "dcn_v2_fwd", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "shape": [SERVE_BATCH, hw, hw, c, co],
            "dtype": "bfloat16", "library_ms": None,
            "plan": plan_of(SERVE_BATCH, hw, hw, c, co), "b1_plan": plan_of(1, hw, hw, c, co),
            "f32_plan": f32_plan_of(SERVE_BATCH, hw, hw, c, co), "b1_f32_plan": f32_plan_of(1, hw, hw, c, co),
        }
        for dtype, tag in ((torch.float32, "_f32"), (torch.bfloat16, "")):
            worst, worst_rel, worst_b1 = 0.0, 0.0, 0.0
            for seed, b, kind in cases:
                args = make_case(seed, b, hw, c, co, dtype, kind)
                err, ref_max = check_case(args, dtype)
                n_cases += 1
                rel = err / max(ref_max, 1e-12)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                ok = err <= TOL_F32 if dtype == torch.float32 else rel <= TOL_BF16_REL
                require(
                    ok,
                    f"dcn_v2_forward disagrees with dcn_v2: shape {(b, hw, hw, c, co)} "
                    f"{dtype} {kind}: max abs err {err}, output max {ref_max}",
                )
                if b == 1:
                    worst_b1 = max(worst_b1, err)
                    args_b1 = args
            # `args` is now the last case, at the serving batch, and
            # `args_b1` the last one at B=1: the times.
            for prefix, a, b in (("", args, SERVE_BATCH), ("b1_", args_b1, 1)):
                with torch.no_grad():
                    ms = time_ms(lambda: dcn_v2_forward(*a), iters=20, queued=True)
                    plain_ms = time_ms(lambda: dcn_v2(*a), iters=3, warmup=1)
                bound, bound_by, flops, nbytes = dcn_bound_ms(b, hw, c, co, dtype)
                entry.update({
                    prefix + "ms" + tag: ms, prefix + "plain_ms" + tag: plain_ms,
                    prefix + "bound_ms" + tag: bound, prefix + "bound_by" + tag: bound_by,
                    prefix + "tflops" + tag: flops / (ms * 1e-3) / 1e12,
                })
            entry.update({"max_abs_err" + tag: worst, "max_rel_err" + tag: worst_rel,
                          "b1_max_abs_err" + tag: worst_b1})
            if dtype == torch.float32:
                same = {"b8": same_bits_f32(args), "b1": same_bits_f32(args_b1)}
                require(all(same.values()), f"float32 output differs between two calls at {(hw, c, co)}: {same}")
                entry["bits_identical_f32"] = same
                entry["weight_split_ms_f32"] = weight_split_ms(args)
            if launchers:
                entry["compared" + tag] = {
                    "b8": compare_bodies(launchers, args, SERVE_BATCH, entry["bound_ms" + tag]),
                    "b1": compare_bodies(launchers, args_b1, 1, entry["b1_bound_ms" + tag]),
                }
            del args, args_b1
        entries.append(entry)

    # Tails: C not a multiple of the channel chunk (64 bf16, 32 float32), Co
    # not a multiple of the output tile, a last pixel tile that is partly
    # outside the map; float32 with its K loop split (the plans at B=1 and 2).
    tails, f32_tails = [], []
    tail_cases = ((40, 1, "uniform"), (41, 2, "uniform"), (42, 1, "off_image"), (43, 2, "off_image"))
    for c, co in TAIL_SHAPES:
        worst_rel = 0.0
        for seed, b, kind in tail_cases:
            args = make_case(seed, b, TAIL_HW, c, co, torch.bfloat16, kind)
            err, ref_max = check_case(args, torch.bfloat16)
            n_cases += 1
            rel = err / max(ref_max, 1e-12)
            require(rel <= TOL_BF16_REL,
                    f"dcn_v2_forward disagrees with dcn_v2: tail {(b, *TAIL_HW, c, co)} {kind}: "
                    f"max abs err {err}, output max {ref_max}")
            worst_rel = max(worst_rel, rel)
        tails.append({"shape": [2, *TAIL_HW, c, co], "plan": plan_of(2, *TAIL_HW, c, co),
                      "max_rel_err": worst_rel})
        worst = 0.0
        for seed, b, kind in tail_cases:
            args = make_case(seed, b, TAIL_HW, c, co, torch.float32, kind)
            err, ref_max = check_case(args, torch.float32)
            n_cases += 1
            require(err <= TOL_F32,
                    f"dcn_v2_forward disagrees with dcn_v2: float32 tail {(b, *TAIL_HW, c, co)} {kind}: "
                    f"max abs err {err}, output max {ref_max}")
            worst = max(worst, err)
        f32_tails.append({"shape": [2, *TAIL_HW, c, co], "max_abs_err": worst,
                          "plans": {f"b{b}": f32_plan_of(b, *TAIL_HW, c, co) for b in (1, 2)}})
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "cases": n_cases, "tf32": "off for cudnn and matmul",
          "batches": sorted({b for _, b, _ in cases}),
          "tolerance": {"float32_abs": TOL_F32, "bfloat16_rel_to_output_max": TOL_BF16_REL},
          "worst_f32_abs": max(e["max_abs_err_f32"] for e in entries),
          "worst_bf16_rel": max(e["max_rel_err"] for e in entries),
          "bf16_plans": {"x".join(map(str, e["shape"])): {"b8": e["plan"], "b1": e["b1_plan"]}
                         for e in entries},
          "f32_plans": {"x".join(map(str, e["shape"])): {"b8": e["f32_plan"], "b1": e["b1_f32_plan"]}
                        for e in entries},
          "bits_identical_f32": {"x".join(map(str, e["shape"])): e["bits_identical_f32"] for e in entries},
          "weight_split_ms_f32": {"x".join(map(str, e["shape"])): e["weight_split_ms_f32"] for e in entries},
          "bf16_tails": tails, "f32_tails": f32_tails,
          "compared": {"x".join(map(str, e["shape"])): e["compared"] for e in entries if "compared" in e},
          "compared_f32": {"x".join(map(str, e["shape"])): e["compared_f32"]
                           for e in entries if "compared_f32" in e}})
    return entries


# -------------------------------------------------------- backward kernels
def make_dout(seed, b, hw, co, dtype=torch.float32):
    h, w = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.RandomState(seed + 1000)
    return torch.from_numpy(rng.randn(b, h, w, co).astype(np.float32)).to(DEVICE, dtype)


def bwd_bound_ms(b, hw, c, co, products, terms, dtype=torch.float32):
    """Least time the card could take for one backward kernel: max(2 * B*HW
    * 9C * Co operations per product / the peak of the operands' type (for
    float32 the float32-accurate 3xTF32 one), bytes / memory rate) with each
    input read once (offset, mask, dout; x unless the kernel is the dX one;
    W unless it is the dW one) and each output written once, all in the
    operands' type (the kernels return each term in its primal type)."""
    m = b * hw * hw
    flops = products * 2.0 * m * 9 * c * co
    elems = m * (18 + 9 + co)                                        # offset, mask, dout
    elems += m * c if terms != (0,) else 0                           # x
    elems += 9 * c * co if terms != (3,) else 0                      # W
    elems += sum(n for i, n in enumerate((m * c, m * 18, m * 9, 9 * c * co)) if i in terms)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = torch.empty((), dtype=dtype).element_size() * elems / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_grads(args, dout, what, rel=TOL_BWD_REL, abs_=TOL_BWD_ABS):
    """Every term of the fused and of the split route against the plain
    version, |err| <= rel * max|plain| + abs_ per term; returns the worst
    |err| and the worst |err| / max|plain| per kernel name."""
    ref = dcn_bwd.dcn_v2_grads_plain(*args, dout)
    worst = {name: 0.0 for name in BWD_KERNELS}
    worst_rel = {name: 0.0 for name in BWD_KERNELS}
    for fused in (True, False):
        got = dcn_bwd.dcn_v2_grads(*args, dout, fused=fused)
        torch.cuda.synchronize()
        for i, (name, g, r) in enumerate(zip(GRAD_NAMES, got, ref)):
            require(g.shape == r.shape and g.dtype == r.dtype, f"{what}: {name} has the wrong shape or type")
            require(torch.isfinite(g).all(), f"{what}: {name} not finite")
            err = (g.float() - r.float()).abs().max().item()
            scale = r.float().abs().max().item()
            limit = rel * scale + abs_
            require(err <= limit, f"{what} fused={fused}: {name} off by {err}, limit {limit}")
            for kname, (_, _, _, terms) in BWD_KERNELS.items():
                if i in terms and (kname == "dcn_v2_bwd_fused") == fused:
                    worst[kname] = max(worst[kname], err)
                    worst_rel[kname] = max(worst_rel[kname], err / max(scale, 1e-30))
    return worst, worst_rel


def as_terms(name, out):
    """A backward wrapper's result as (dx, doffset, dmask, dweight), None for
    the terms the kernel does not compute."""
    terms = BWD_KERNELS[name][3]
    out = out if isinstance(out, tuple) else (out,)
    full = [None] * 4
    for i, t in zip(terms, out):
        full[i] = t
    return tuple(full)


def bwd_plans(b, hw, c, co, dtype=torch.float32):
    """The four backward kernels' plans at one call: `ops/dcn_bwd.py::bwd_plan`
    must state what the built source chooses."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for kind in dcn_bwd._KERNELS:
        mine = dcn_bwd.bwd_plan(kind, b, h, w, c, co, sms, dtype)
        built = dcn_bwd.kernel_bwd_plan(kind, b, h, w, c, co, sms, dtype=dtype)
        require({k: mine[k] for k in built} == built,
                f"dcn_v2_bwd_{kind} {dtype} at {(b, h, w, c, co)}: built plan {built} != bwd_plan {mine}")
        plans[kind] = {"grid": [mine["grid_x"], mine["grid_y"], mine["grid_z"]],
                       "tiles": mine["tiles"], "chunks_per_block": mine["chunks_per_block"],
                       "co_tiles": mine["co_tiles"], "smem_bytes": mine["smem_bytes"],
                       "blocks_per_sm": mine["blocks_per_sm"],
                       "scratch_mb": mine["scratch_floats"] * 4 / 2 ** 20}
    return plans


def bits_identical(args, dout):
    """Each kernel called twice on the same operands: are its terms the same
    bits? dW, d_offset and d_mask must be (sums of partials in a fixed
    order); dX is a sum of atomics and is only reported."""
    same = {}
    for name, (fn, _, _, terms) in BWD_KERNELS.items():
        one = as_terms(name, fn(*args[:4], dout))
        two = as_terms(name, fn(*args[:4], dout))
        torch.cuda.synchronize()
        same[name] = {GRAD_NAMES[i]: bool(torch.equal(one[i], two[i])) for i in terms}
        for i in terms:
            require(i == 0 or same[name][GRAD_NAMES[i]],
                    f"{name}: {GRAD_NAMES[i]} differs between two calls on the same operands")
    return same


def compared_bwd_launchers():
    """{label: run(kind, args, dout) -> (dx, doffset, dmask, dweight)} for each
    `--compare LABEL=PATH` of the backward source (no launch is counted). A
    build that exports `dcn_v2_bwd_plan` is driven through this checkout's
    wrapper with its own plan; an earlier one (no plan, no scratch, the weight
    as [9C, Co], dX and dW zeroed by the caller) through its own interface."""
    import ctypes

    def old_interface(lib):
        def run(kind, args, dout):
            x, offset, mask, weight = args[:4]
            b, h, w, c = x.shape
            co = weight.shape[3]
            fn = getattr(lib, f"dcn_v2_bwd_{kind}_launch")
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=DEVICE)  # noqa: E731
            dx = zeros(b, h, w, c) if kind in ("fused", "dx") else None
            doff = zeros(b, h, w, 18) if kind in ("fused", "dcoord") else None
            dmask = zeros(b, h, w, 9) if kind in ("fused", "dcoord") else None
            dw = zeros(3, 3, c, co) if kind in ("fused", "dw") else None
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            err = fn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.contiguous().data_ptr(),
                     dout.data_ptr(), ptr(dx), ptr(doff), ptr(dmask), ptr(dw), b, h, w, c, co,
                     dcn_bwd.pixel_stride(offset, "offset", "compare"),
                     dcn_bwd.pixel_stride(mask, "mask", "compare"),
                     torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"compared backward launch failed: {err}")
            return dx, doff, dmask, dw
        return run

    def new_interface(lib):
        def run(kind, args, dout):
            x, offset, mask, weight = args[:4]
            return dcn_bwd._launch(kind, None if kind == "dx" else x, offset, mask, weight, dout, lib=lib)
        return run

    runs = {}
    for label, _ in COMPARE_BWD:
        lib = compared_library("bwd", label)
        runs[label] = new_interface(lib) if hasattr(lib, "dcn_v2_bwd_plan") else old_interface(lib)
    return runs


def compare_bwd_bodies(runs, args, dout, ref, hw, c, co):
    """Every backward kernel of this checkout and of each compared build at one
    case: the compared build's terms against the plain version (the same
    tolerance), and device times in turns (other, this, this, other), 10
    calls each queued behind a device sleep."""
    rows = {}
    for label, run in runs.items():
        rows[label] = {}
        for name, (fn, _, _, terms) in BWD_KERNELS.items():
            kind = name[len("dcn_v2_bwd_"):]
            got = run(kind, args, dout)
            torch.cuda.synchronize()
            for i in terms:
                err = (got[i] - ref[i]).abs().max().item()
                limit = TOL_BWD_REL * ref[i].abs().max().item() + TOL_BWD_ABS
                require(err <= limit, f"compared {label} {name} at {(hw, c, co)}: {GRAD_NAMES[i]} off by {err}")
            t = [time_ms(lambda: run(kind, args, dout), iters=10, queued=True),
                 time_ms(lambda: fn(*args[:4], dout), iters=10, queued=True),
                 time_ms(lambda: fn(*args[:4], dout), iters=10, queued=True),
                 time_ms(lambda: run(kind, args, dout), iters=10, queued=True)]
            rows[label][name] = {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                                 "ratio": (t[1] + t[2]) / (t[0] + t[3])}
    return rows


# Phase boundaries of the fused backward kernel: each is the barrier that
# ends the phase, found by text in the source (`clock_source`).
CLOCK_PHASES = ("coordinate sums", "tile prologue", "gs product", "gather", "dW product")
CLOCK_MARK = ("{ const long long _n = clock64(); if (threadIdx.x == 0) _ph[%d] += _n - _last;"
              " _last = _n; }\n")


def clock_source(src: str) -> str:
    """The backward source with thread 0 of every block adding the clock64()
    cycles between consecutive barriers of a tile to per-phase counters, and
    `prof_read` / `prof_reset` to read them (summed over blocks) from the host."""
    def after(text, pos, mark):
        i = src.index(text, pos) + len(text)
        return src[:i] + "\n" + CLOCK_MARK % mark + src[i:], i

    src = src.replace("namespace {", "__device__ unsigned long long g_clock[8];\nnamespace {", 1)
    src = src.replace("  const int tid = threadIdx.x;\n", "  const int tid = threadIdx.x;\n"
                      "  long long _ph[5] = {0, 0, 0, 0, 0}; long long _last = clock64();\n", 1)
    src, _ = after("__syncthreads();   // every reader of the previous tile's buffers is done", 0, 0)
    end_prologue = src.rindex("__syncthreads();", 0, src.index("    float psum[4][3];"))
    src, _ = after("__syncthreads();", end_prologue, 1)
    end_gs = src.rindex("__syncthreads();", 0, src.index("// ---- 2. one gather"))
    src, _ = after("__syncthreads();", end_gs, 2)
    src, i = after("__syncthreads();   // the column tile is written", 0, 3)
    src, _ = after("__syncthreads();", i, 4)
    tail = src.index("  // ---- the slab's dW partial, written once")
    src = (src[:tail] + "  if (threadIdx.x == 0) { for (int i = 0; i < 5; ++i) atomicAdd(&g_clock[i], "
           "(unsigned long long)_ph[i]); atomicAdd(&g_clock[5], (unsigned long long)(tile1 - tile0)); }\n"
           + src[tail:])
    return src + ('\nextern "C" int prof_read(unsigned long long* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));\n}\n'
                  'extern "C" int prof_reset() {\n  unsigned long long z[8] = {0};\n'
                  '  return (int)cudaMemcpyToSymbol(g_clock, z, sizeof(z));\n}\n')


def phase_clocks():
    """Cycles per tile per block in each phase of the fused kernel, for this
    checkout's backward source and each compared one, at every production
    shape at B=8 (one queued run of 10 calls each), for each body a build
    has (float32; bf16 as `<shape>_bf16`)."""
    import ctypes

    def read(path):
        with open(path) as fh:
            return fh.read()

    sources = [("this", os.path.join(_build.CSRC, "dcn_v2_bwd.cu"))] + [
        (label, path) for label, path in COMPARE_BWD if "dcn_v2_bwd_plan" in read(path)]
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for label, path in sources:
        src = _build.BUILD / f"clock-{label}.cu"
        src.write_text(clock_source(read(path)))
        out = _build.BUILD / f"libclock-{label}.so"
        jobs.append((label, out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    rows = {}
    for label, out, job in jobs:
        log, _ = job.communicate(timeout=900)
        require(job.returncode == 0, f"nvcc failed for the clocked {label}:\n{log}")
        lib = ctypes.CDLL(str(out))
        counts = (ctypes.c_ulonglong * 8)()
        rows[label] = {}
        dtypes = [torch.float32] + ([torch.bfloat16] if hasattr(lib, "dcn_v2_bwd_fused_bf16_launch") else [])
        for (hw, c, co), dtype in ((shape, dt) for shape in PRODUCTION_SHAPES for dt in dtypes):
            args = make_case(30, TRAIN_BATCH, hw, c, co, dtype, "uniform")
            dout = make_dout(30, TRAIN_BATCH, hw, co, dtype)
            run = lambda: dcn_bwd._launch("fused", args[0], args[1], args[2], args[3], dout, lib=lib)  # noqa: E731
            run()
            torch.cuda.synchronize()
            require(lib.prof_reset() == 0, "clock reset failed")
            ms = time_ms(run, iters=10, warmup=0, queued=True)
            require(lib.prof_read(counts) == 0, "clock read failed")
            tiles = max(int(counts[5]), 1)
            key = f"{hw}x{c}x{co}" + ("_bf16" if dtype == torch.bfloat16 else "")
            rows[label][key] = {
                "ms": ms, "cycles_per_tile": dict(zip(CLOCK_PHASES, (counts[i] / tiles for i in range(5))))}
            del args, dout
    torch.cuda.empty_cache()
    return rows


def phase_kernels_bwd():
    """The four backward kernels on the 7 production shapes and the tails,
    float32: agreement, plans, bits across two calls, times (in turns with
    every compared build)."""
    cases = [(20 + s, 2, k) for s, k in enumerate(("uniform", "integer", "off_image", "dy20"))]
    cases.append((30, TRAIN_BATCH, "uniform"))
    per_shape = {name: [] for name in BWD_KERNELS}
    runs = compared_bwd_launchers()
    plans, same_bits, n_cases = {}, {}, 0
    for hw, c, co in PRODUCTION_SHAPES:
        key = f"{TRAIN_BATCH}x{hw}x{hw}x{c}x{co}"
        plans[key] = bwd_plans(TRAIN_BATCH, hw, c, co)
        worst = {name: 0.0 for name in BWD_KERNELS}
        for seed, b, kind in cases:
            args = make_case(seed, b, hw, c, co, torch.float32, kind)
            dout = make_dout(seed, b, hw, co)
            got, _ = check_grads(args, dout, f"shape {(b, hw, hw, c, co)} {kind}")
            worst = {k: max(worst[k], got[k]) for k in worst}
            n_cases += 1
        # `args`, `dout` are now the last case, at the training batch: bits
        # across two calls, then the times.
        same_bits[key] = bits_identical(args, dout)
        ref = dcn_bwd.dcn_v2_grads_plain(*args, dout)
        compared = compare_bwd_bodies(runs, args, dout, ref, hw, c, co)
        del ref
        plain_ms = time_ms(lambda: dcn_bwd.dcn_v2_grads_plain(*args, dout), iters=2, warmup=1)
        for name, (fn, _, products, terms) in BWD_KERNELS.items():
            ms = time_ms(lambda: fn(*args[:4], dout), iters=10, queued=True)
            bound, bound_by = bwd_bound_ms(TRAIN_BATCH, hw, c, co, products, terms)
            row = {"shape": [TRAIN_BATCH, hw, hw, c, co], "max_abs_err": worst[name], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                   "plan": plans[key][name[len("dcn_v2_bwd_"):]],
                   "bits_identical": same_bits[key][name]}
            if compared:
                row["compared"] = {label: rows[name] for label, rows in compared.items()}
            per_shape[name].append(row)
        del args, dout
    # Tails: C, Co and the pixels not multiples of the tiles; the last (Co >
    # 256) is cut into two launches by the wrapper.
    tails = []
    for c, co in BWD_TAIL_SHAPES:
        worst = {name: 0.0 for name in BWD_KERNELS}
        for seed, b, kind in ((40, 1, "uniform"), (41, 2, "uniform"), (42, 1, "off_image"), (43, 2, "integer")):
            args = make_case(seed, b, TAIL_HW, c, co, torch.float32, kind)
            dout = make_dout(seed, b, TAIL_HW, co)
            got, _ = check_grads(args, dout, f"tail {(b, *TAIL_HW, c, co)} {kind}")
            worst = {k: max(worst[k], got[k]) for k in worst}
            n_cases += 1
        tails.append({"shape": [2, *TAIL_HW, c, co], "max_abs_err": worst,
                      "plans": bwd_plans(2, TAIL_HW, c, co) if co <= dcn_bwd.BWD_MAX_CO else None})
    clocks = phase_clocks() if CLOCK else None
    torch.cuda.empty_cache()
    reset_launches()
    emit({"phase": "kernels_bwd", "cases": n_cases, "dtype": "float32", "clock_cycles_per_tile": clocks,
          "tolerance": {"rel_to_term_max": TOL_BWD_REL, "abs": TOL_BWD_ABS},
          "plain": "dcn_v2_grads_plain (all five terms; the yardstick of every kernel)",
          "library": None, "plans": plans, "bits_identical": same_bits, "tails": tails,
          "per_shape": per_shape})
    return per_shape


def phase_kernels_bwd_bf16():
    """The four backward kernels on bf16 operands (the mixed-precision train
    step's) against the plain version on the same bf16 values: the 7
    production shapes x 4 offset kinds at B=2, one case at B=8 and the
    tails, TOL_BWD_BF16 per term; plans equal to `bwd_plan(dtype=bf16)`;
    dW, d_offset and d_mask the same bits in two calls; device times per call
    at B=8 against the bound at the bf16 rate."""
    dt = torch.bfloat16
    cases = [(50 + s, 2, k) for s, k in enumerate(("uniform", "integer", "off_image", "dy20"))]
    cases.append((60, TRAIN_BATCH, "uniform"))
    per_shape = {name: [] for name in BWD_KERNELS}
    plans, same_bits, n_cases = {}, {}, 0
    worst_rel_all = {name: 0.0 for name in BWD_KERNELS}
    for hw, c, co in PRODUCTION_SHAPES:
        key = f"{TRAIN_BATCH}x{hw}x{hw}x{c}x{co}"
        plans[key] = bwd_plans(TRAIN_BATCH, hw, c, co, dt)
        worst = {name: 0.0 for name in BWD_KERNELS}
        for seed, b, kind in cases:
            args = make_case(seed, b, hw, c, co, dt, kind)
            dout = make_dout(seed, b, hw, co, dt)
            got, rel = check_grads(args, dout, f"bf16 shape {(b, hw, hw, c, co)} {kind}", **{
                "rel": TOL_BWD_BF16["rel"], "abs_": TOL_BWD_BF16["abs"]})
            worst = {k: max(worst[k], got[k]) for k in worst}
            worst_rel_all = {k: max(worst_rel_all[k], rel[k]) for k in worst_rel_all}
            n_cases += 1
        same_bits[key] = bits_identical(args, dout)
        plain_ms = time_ms(lambda: dcn_bwd.dcn_v2_grads_plain(*args, dout), iters=2, warmup=1)
        for name, (fn, _, products, terms) in BWD_KERNELS.items():
            ms = time_ms(lambda: fn(*args[:4], dout), iters=10, queued=True)
            bound, bound_by = bwd_bound_ms(TRAIN_BATCH, hw, c, co, products, terms, dt)
            per_shape[name].append({
                "shape": [TRAIN_BATCH, hw, hw, c, co], "max_abs_err": worst[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "plan": plans[key][name[len("dcn_v2_bwd_"):]], "bits_identical": same_bits[key][name]})
        del args, dout
    tails = []
    for c, co in BWD_TAIL_SHAPES:
        worst = {name: 0.0 for name in BWD_KERNELS}
        for seed, b, kind in ((70, 1, "uniform"), (71, 2, "uniform"), (72, 1, "off_image"), (73, 2, "integer")):
            args = make_case(seed, b, TAIL_HW, c, co, dt, kind)
            dout = make_dout(seed, b, TAIL_HW, co, dt)
            got, rel = check_grads(args, dout, f"bf16 tail {(b, *TAIL_HW, c, co)} {kind}", **{
                "rel": TOL_BWD_BF16["rel"], "abs_": TOL_BWD_BF16["abs"]})
            worst = {k: max(worst[k], got[k]) for k in worst}
            worst_rel_all = {k: max(worst_rel_all[k], rel[k]) for k in worst_rel_all}
            n_cases += 1
        tails.append({"shape": [2, *TAIL_HW, c, co], "max_abs_err": worst,
                      "plans": bwd_plans(2, TAIL_HW, c, co, dt) if co <= dcn_bwd.BWD_MAX_CO else None})
    torch.cuda.empty_cache()
    reset_launches()
    emit({"phase": "kernels_bwd_bf16", "cases": n_cases, "dtype": "bfloat16",
          "tolerance": {"rel_to_term_max": TOL_BWD_BF16["rel"], "abs": TOL_BWD_BF16["abs"]},
          "worst_err_rel_to_term_max": worst_rel_all,
          "plain": "dcn_v2_grads_plain on the bf16 operands (float32 products and sums)",
          "library": None, "plans": plans, "bits_identical": same_bits, "tails": tails,
          "per_shape": per_shape})
    return per_shape


# ------------------------------------------------------------------- model
def randomize_offset_convs(model, seed: int) -> None:
    """Fresh offset convs are zero, which samples on the grid only: draw them
    so that offsets are of the order of half a pixel and more."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, layers.DCN):
                w = mod.conv_offset_mask.weight
                fan_in = w[0].numel()
                w.copy_((torch.randn(w.shape, generator=gen) * 0.5 / fan_in ** 0.5).to(w))
                b = mod.conv_offset_mask.bias
                b.copy_((torch.randn(b.shape, generator=gen) * 0.5).to(b))


def count_dcn_shapes(model, counter: Counter):
    """Forward hooks that count the DCN calls of `model` by (H, C, Co)."""
    def hook(mod, inputs, output):
        x = inputs[0]
        counter[(x.shape[2], x.shape[1], output.shape[1])] += 1
    return [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, layers.DCN)]


def count_all_dcn_shapes(counter: Counter):
    """One global forward hook that counts the DCN calls of every model of
    this process by (H, C, Co), those built after it too (the CLIs build
    their own); the caller removes it."""
    def hook(mod, inputs, output):
        if isinstance(mod, layers.DCN):
            x = inputs[0]
            counter[(x.shape[2], x.shape[1], output.shape[1])] += 1
    return torch.nn.modules.module.register_module_forward_hook(hook)


def forward_decode(model, images, cfg):
    with torch.no_grad():
        out = model(images)
        return out, object_pose_decode(
            out, k=cfg.K, rep_mode=cfg.rep_mode, inference=True, fit_gaussian=True
        )


def phase_model():
    cfg32 = preset("centerpose", input_h=INPUT, input_w=INPUT)
    cfg = cfg32.replace(compute_dtype="bfloat16")
    model32 = create_model(cfg32, DEVICE, generator=torch.Generator().manual_seed(0))
    randomize_offset_convs(model32, seed=0)
    model = create_model(cfg, DEVICE)
    model.load_state_dict(model32.state_dict())          # same weights, bf16

    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(SERVE_BATCH, INPUT, INPUT, 3).astype(np.float32)
    ).to(DEVICE)

    # One forward, the launch counter set to 0 just before it: launches in
    # all, and by shape as forward hooks on the DCN modules see them.
    per_shape: Counter = Counter()
    hooks = count_dcn_shapes(model, per_shape)
    dcn_v2_forward.launches = 0
    out, dets = forward_decode(model, images, cfg)
    torch.cuda.synchronize()
    per_forward = dcn_v2_forward.launches
    for h in hooks:
        h.remove()
    require(per_forward == 16, f"{per_forward} kernel launches in one forward, expected 16")
    require(sum(per_shape.values()) == per_forward, "DCN calls counted by shape differ from the launch counter")
    require(set(per_shape) == set(PRODUCTION_SHAPES),
            f"the network's DCN shapes {sorted(per_shape)} are not the ones the kernels phase tested")
    q = INPUT // 4
    require(tuple(dets["scores"].shape) == (SERVE_BATCH, cfg.K, 1), f"scores {tuple(dets['scores'].shape)}")
    require(tuple(dets["kps"].shape) == (SERVE_BATCH, cfg.K, 16), f"kps {tuple(dets['kps'].shape)}")
    for name, n in cfg.heads.items():
        require(tuple(out[name].shape) == (SERVE_BATCH, q, q, n), (name, out[name].shape))
        require(torch.isfinite(out[name].float()).all(), f"head {name} not finite")
    for name, v in dets.items():
        require(torch.isfinite(v).all(), f"decode output {name} not finite")

    ms = time_ms(lambda: forward_decode(model, images, cfg), iters=6)
    with torch.no_grad():
        net_ms = time_ms(lambda: model(images), iters=3, warmup=0)

    # Time spent inside the DCN kernel during one forward: events around each
    # of the 16 launches, in place.
    spans = []
    real = layers.dcn_v2_forward

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = real(*args)
        b.record()
        spans.append((a, b))
        return res

    layers.dcn_v2_forward = timed
    try:
        forward_decode(model, images, cfg)
        torch.cuda.synchronize()
    finally:
        layers.dcn_v2_forward = real
    require(len(spans) == 16, f"{len(spans)} timed DCN calls in one forward, expected 16")
    dcn_ms = sum(a.elapsed_time(b) for a, b in spans)

    # float32: the network through the kernel against the same network with
    # the plain DCN, head by head (TF32 is off since the kernels phase).
    imgs2 = images[:2]
    with torch.no_grad():
        out_k = model32(imgs2)
        layers.dcn_v2_forward = dcn_v2
        try:
            out_p = model32(imgs2)
        finally:
            layers.dcn_v2_forward = real
    torch.cuda.synchronize()
    diffs = {h: (out_k[h] - out_p[h]).abs().max().item() for h in out_k}
    require(max(diffs.values()) <= 2e-3, f"f32 network, kernel vs plain DCN: {diffs}")

    emit({
        "phase": "model", "arch": cfg.arch, "input": [SERVE_BATCH, INPUT, INPUT, 3],
        "dtype": cfg.compute_dtype, "launches_per_forward": per_forward,
        "launches_per_forward_by_shape": {"x".join(map(str, k)): v for k, v in per_shape.items()},
        "ms_per_batch_net_decode": ms, "images_per_s": SERVE_BATCH / (ms * 1e-3),
        "ms_per_batch_net": net_ms, "dcn_kernel_ms_per_forward": dcn_ms,
        "dcn_share_of_net_decode": dcn_ms / ms,
        "f32_kernel_vs_plain_max_abs_diff": diffs,
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
    })
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model32, model, out, dets, out_k, out_p
    torch.cuda.empty_cache()
    return cfg, state, per_shape


# ------------------------------------------------------------------- serve
def phase_serve(cfg, state_dict):
    cfg = cfg.replace(vis_thresh=0.05)
    det = Detector(cfg, state_dict=state_dict, device=DEVICE, seed=0)
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(3 + SERVE_BATCH)]
    det.run(frames[0])                                   # warm-up, not counted
    torch.cuda.synchronize()

    shape_counts: Counter = Counter()
    hooks = count_dcn_shapes(det.model, shape_counts)
    dcn_v2_forward.launches = 0                          # ---- the main path starts
    t0 = time.perf_counter()
    singles = [det.run(f) for f in frames[:3]]
    t1 = time.perf_counter()
    batch = det.run_batch(frames[3:], timing=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dcn_v2_forward.launches                   # ---- and ends
    for h in hooks:
        h.remove()

    require(launches == 4 * 16, f"{launches} kernel launches in 4 forwards, expected 64")
    require(sum(shape_counts.values()) == launches, "DCN calls counted by shape differ from the launch counter")
    outs = singles + batch
    require(len(batch) == SERVE_BATCH, "run_batch returned the wrong number of outputs")
    n_pnp = 0
    for out in outs:
        require({"results", "boxes", "meta"} <= set(out), f"result keys {sorted(out)}")
        for d in out["results"]:
            require(np.isfinite(d["bbox"]).all() and np.isfinite(d["score"]), "bbox or score not finite")
            if "location" in d:
                n_pnp += 1
                require(np.isfinite(d["location"]).all(), "PnP location not finite")
                require(np.isfinite(d["quaternion_xyzw"]).all(), "PnP quaternion not finite")
                require(np.isfinite(d["projected_cuboid"]).all(), "PnP projection not finite")
    n_det = [len(o["results"]) for o in outs]
    require(max(n_det) > 0, "no image produced a detection")
    require(n_pnp > 0, "no detection got a PnP result")

    # Planted pose: project a known cuboid with the default camera, solve on
    # the card, recover the translation within 1e-3 relative.
    cub = cuboid_vertices([0.8, 1.0, 1.3])
    ang = 0.6
    rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t_true = np.array([0.15, -0.1, 4.0])
    pc = cub @ rot.T + t_true
    cam = DEFAULT_CAMERA
    uv = pc[:, :2] / pc[:, 2:] * [cam[0, 0], cam[1, 1]] + [cam[0, 2], cam[1, 2]]
    res = solve_pnp_batch_padded(
        np.repeat(uv, 2, axis=0)[None].astype(np.float32).repeat(3, 0),
        cub[None].astype(np.float32).repeat(3, 0), cam.astype(np.float32), device=DEVICE,
    )
    t_est = res.translation.cpu().numpy()
    rel = float(np.abs(t_est - t_true).max() / np.linalg.norm(t_true))
    require(bool(res.valid.all()) and rel <= 1e-3, f"planted pose: translation off by {rel} relative")

    emit({
        "phase": "serve", "requests": {"run": 3, "run_batch": [SERVE_BATCH]},
        "image": [480, 640, 3], "kernel_launches": launches,
        "detections_per_image": n_det, "pnp_results": n_pnp,
        "boxes_per_image": [len(o["boxes"]) for o in outs],
        "run_ms_each": (t1 - t0) * 1e3 / 3, "run_batch_ms": (t2 - t1) * 1e3,
        "run_times_s": singles[-1]["times"], "run_batch_times_s": batch[0]["times"],
        "planted_pose_translation_rel_err": rel,
    })
    return launches, shape_counts


# ------------------------------------------------------------------- track
def track_weights(model, cfg, frame_w: int, seed: int) -> None:
    """Random weights that give a random tracking network a coherent video.
    `create_model`'s uniform +-1/sqrt(fan_in) convolutions shrink the
    activations layer by layer until the heatmap is one constant (every cell
    sigmoid(-2.19), as the serve phase sees), so every convolution is drawn
    again He-normal (variance 2/fan_in) from `seed`, and the DCN offset convs
    as the model phase draws them. Then five heads are set, as
    `tests/test_torch_port_video.py` does on the CPU: the heatmap bias lowered
    by TRACK_HM_SHIFT so that only the strongest peaks pass the thresholds;
    boxes 12 output pixels wide, which is what lets the detections of
    consecutive frames associate; no keypoint-heatmap peak (PnP reads the
    displacement keypoints); displacement keypoints near the projection of a
    unit cube 8 units in front of the default camera and a near-unit scale,
    so that every PnP is well posed; small tracking offsets."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, layers.DCN)):      # not the upsamplers
                w = mod.weight
                w.copy_((torch.randn(w.shape, generator=gen) * (2.0 / w[0].numel()) ** 0.5).to(w))
    randomize_offset_convs(model, seed)
    out_px = frame_w / cfg.output_w                      # image pixels per output pixel
    yaw = np.array([[np.cos(0.5), 0, np.sin(0.5)], [0, 1, 0], [-np.sin(0.5), 0, np.cos(0.5)]])
    corners = cuboid_vertices(np.ones(3)) @ yaw.T + [0.0, 0.0, 8.0]
    offsets = corners[:, :2] / corners[:, 2:] * DEFAULT_CAMERA[0, 0] / out_px
    with torch.no_grad():
        model.hm[-1].bias.sub_(TRACK_HM_SHIFT)
        for head, gain, bias in (("wh", 0.1, 12.0), ("hm_hp", 0.1, -6.0), ("hps", 0.05, None),
                                 ("scale", 0.1, 1.0), ("tracking", 0.1, 0.0), ("tracking_hp", 0.1, 0.0)):
            out = getattr(model, head)[-1]
            out.weight.mul_(gain)
            if bias is not None:
                out.bias.fill_(bias)
        model.hps[-1].bias.copy_(torch.from_numpy(offsets.reshape(-1).astype(np.float32)))


def synthetic_video(n: int, seed: int):
    """n frames of 480x640 uint8: one smooth seeded image moved by (2, 3)
    pixels a frame, so that what was seen in one frame is seen again."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    base = np.asarray(Image.fromarray(base).resize((640 + 3 * n, 480 + 2 * n), Image.BILINEAR))
    return [np.ascontiguousarray(base[2 * i:2 * i + 480, 3 * i:3 * i + 640]) for i in range(n)]


def run_video(det, frames):
    """Every frame through `Detector.run`, the launch counter read around
    each; the maximum of the pre_hm the network was given and the re-PnP
    solves are recorded by wrapping the detector's `_forward_decode` and the
    tracker's `_re_pnp_batch`."""
    pre_hm_max, repnp = [], {"calls": 0, "valid": 0}
    real_forward, real_repnp = det._forward_decode, det.tracker._re_pnp_batch

    def forward_decode(images, pre_img=None, pre_hm=None, pre_hm_hp=None):
        pre_hm_max.append((len(per_frame), pre_hm.amax()))   # read after the frame
        return real_forward(images, pre_img, pre_hm, pre_hm_hp)

    def re_pnp(items):
        outs = real_repnp(items)
        repnp["calls"] += 1
        repnp["valid"] += sum(o is not None for o in outs)
        return outs

    det._forward_decode, det.tracker._re_pnp_batch = forward_decode, re_pnp
    per_frame = []
    try:
        for frame in frames:
            dcn_v2_forward.launches = 0
            t0 = time.perf_counter()
            out = det.run(frame, {"camera_matrix": DEFAULT_CAMERA})
            torch.cuda.synchronize()
            per_frame.append({
                "wall_ms": (time.perf_counter() - t0) * 1e3, "launches": dcn_v2_forward.launches,
                "times": out["times"], "tracks": len(out["results"]),
                # ids detected in this frame (matched or new; not the aging ones)
                "ids": [d["tracking_id"] for d in out["results"] if d["age"] == 1],
                "matched": sum(d["active"] > 1 for d in out["results"]),
                "boxes": len(out["boxes"]),
            })
    finally:
        del det._forward_decode, det.tracker._re_pnp_batch
    hm_max = {f: float(v) for f, v in pre_hm_max}
    return per_frame, hm_max, repnp


def stage_medians(per_frame):
    """Median ms of each stage over the frames after the warm-up ones."""
    steady = per_frame[TRACK_WARMUP:]
    keys = ("pre", "net", "post", "merge", "pnp", "track", "tot")
    med = {k: float(np.median([f["times"][k] for f in steady])) * 1e3 for k in keys}
    med["wall"] = float(np.median([f["wall_ms"] for f in steady]))
    return med


def longest_run(per_frame):
    """The most consecutive frames (from the warm-up on) in which one track
    id was detected (spawned or matched; a track that only ages does not
    count)."""
    best, runs = 0, {}
    for f in per_frame[TRACK_WARMUP:]:
        runs = {i: runs.get(i, 0) + 1 for i in f["ids"]}
        best = max([best] + list(runs.values()))
    return best


def phase_track(per_forward):
    """CenterPoseTrack: the dla_34 tracking model at 512x512, float32 (the
    demo's default), a synthetic video through `Detector.run` frame by frame,
    then the same frames in bfloat16, then the network through the kernel
    against the network through the plain DCN with previous-frame inputs."""
    torch.cuda.empty_cache()
    cfg = preset("centerpose_track", category="shoe", input_h=INPUT, input_w=INPUT,
                 vis_thresh=TRACK_VIS_THRESH, new_thresh=TRACK_NEW_THRESH)
    det = Detector(cfg, device=DEVICE, seed=0)
    frames = synthetic_video(TRACK_FRAMES, seed=4)
    track_weights(det.model, cfg, frames[0].shape[1], seed=0)
    state = {k: v.clone() for k, v in det.model.state_dict().items()}

    shape_counts: Counter = Counter()
    hooks = count_dcn_shapes(det.model, shape_counts)
    dcn_v2_forward.launches = 0                          # ---- the main path starts
    per_frame, hm_max, repnp = run_video(det, frames)    # ---- and ends (counted per frame)
    for h in hooks:
        h.remove()
    launches = [f["launches"] for f in per_frame]
    require(all(n == 16 for n in launches), f"DCN forward launches per frame {launches}, expected 16 each")
    require(sum(shape_counts.values()) == sum(launches), "DCN calls counted by shape differ from the launch counter")
    require(set(shape_counts) == set(per_forward),
            f"the tracking network's DCN shapes {sorted(shape_counts)} are not the image model's")
    require(max(hm_max.values(), default=0.0) > 0.0, f"pre_hm is zero on every frame: {hm_max}")
    carried = [0] + [len(set(a["ids"]) & set(b["ids"])) for a, b in zip(per_frame, per_frame[1:])]
    run = longest_run(per_frame)
    require(run >= 3, f"no track id persists over 3 consecutive frames after warm-up ({run})")
    require(repnp["calls"] > 0 and repnp["valid"] > 0, f"the tracker's re-PnP never ran: {repnp}")
    med = stage_medians(per_frame)

    # The 16 launches of one frame in place: CUDA events around each.
    spans = []
    real = layers.dcn_v2_forward

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = real(*args)
        b.record()
        spans.append((a, b))
        return res

    layers.dcn_v2_forward = timed
    try:
        det.run(frames[-1], {"camera_matrix": DEFAULT_CAMERA})
        torch.cuda.synchronize()
    finally:
        layers.dcn_v2_forward = real
    require(len(spans) == 16, f"{len(spans)} timed DCN calls in one frame, expected 16")
    dcn_ms = sum(a.elapsed_time(b) for a, b in spans)

    # The same frames in bfloat16.
    det16 = Detector(cfg.replace(compute_dtype="bfloat16"), state_dict=state, device=DEVICE)
    per_frame16, hm_max16, _ = run_video(det16, frames)
    launches16 = [f["launches"] for f in per_frame16]
    require(all(n == 16 for n in launches16), f"bf16: DCN forward launches per frame {launches16}")
    med16 = stage_medians(per_frame16)
    del det16

    # One frame of the network with previous-frame inputs, float32: through
    # the kernel and through the plain DCN, head by head (TF32 is off).
    rng = np.random.RandomState(6)
    inputs = [torch.from_numpy(rng.rand(1, INPUT, INPUT, n).astype(np.float32)).to(DEVICE)
              for n in (3, 3, 1, 8)]
    with torch.no_grad():
        out_k = det.model(*inputs)
        layers.dcn_v2_forward = dcn_v2
        try:
            out_p = det.model(*inputs)
        finally:
            layers.dcn_v2_forward = real
    torch.cuda.synchronize()
    require(set(out_k) == set(cfg.heads) and len(out_k) == 11, f"heads {sorted(out_k)}")
    diffs = {h: (out_k[h] - out_p[h]).abs().max().item() for h in out_k}
    require(all(torch.isfinite(v).all() for v in out_k.values()), "a tracking head is not finite")
    require(max(diffs.values()) <= 2e-3, f"f32 tracking network, kernel vs plain DCN: {diffs}")

    emit({
        "phase": "track", "arch": cfg.arch, "input": [1, INPUT, INPUT, 3], "frame": list(frames[0].shape),
        "frames": len(frames), "vis_thresh": cfg.vis_thresh, "new_thresh": cfg.new_thresh,
        "weights": "He-normal from seed 0, heads set by track_weights",
        "hm_bias_shift": TRACK_HM_SHIFT,
        "stage_ms_median_float32": med, "frames_per_s_float32": 1e3 / med["wall"],
        "stage_ms_median_bfloat16": med16, "frames_per_s_bfloat16": 1e3 / med16["wall"],
        "median_over_frames_from": TRACK_WARMUP,
        "launches_per_frame": launches, "launches_per_frame_bfloat16": launches16,
        "launches_by_shape": {"x".join(map(str, k)): v for k, v in shape_counts.items()},
        "live_tracks_per_frame": [f["tracks"] for f in per_frame],
        "detected_tracks_per_frame": [len(f["ids"]) for f in per_frame],
        "matched_per_frame": [f["matched"] for f in per_frame],
        "ids_carried_from_previous_frame": carried,
        "longest_id_run_after_warmup": run,
        "boxes_per_frame": [f["boxes"] for f in per_frame],
        "pre_hm_max_by_frame": hm_max, "pre_hm_max_by_frame_bfloat16": hm_max16,
        "re_pnp": repnp,
        "dcn_kernel_ms_per_frame_in_place": dcn_ms,
        "dcn_share_of_net_float32": dcn_ms / med["net"],
        "f32_kernel_vs_plain_max_abs_diff": diffs,
    })
    del det, out_k, out_p
    torch.cuda.empty_cache()
    return shape_counts, sum(launches), med


# ------------------------------------------------------------------- train
def synthetic_batch(cfg, batch_size: int, seed: int):
    """One object per image at the centre of the map with random keypoints,
    rendered by `render_targets`, and a random image; tensors on the card."""
    rng = np.random.RandomState(seed)
    out_res = cfg.output_h
    samples = []
    for _ in range(batch_size):
        obj = ObjectAnnotation(
            center=np.array([out_res / 2.0, out_res / 2.0]),
            size=np.array([out_res / 2.0, out_res / 2.0]),
            keypoints=rng.uniform(out_res / 4, 3 * out_res / 4, size=(1, 8, 2)).astype(np.float32),
            keypoints_visible=np.ones((1, 8), bool),
            scale_3d=np.array([1.0, 1.0, 1.0], np.float32),
        )
        samples.append(render_targets([obj], cfg))
    batch = stack_batch(samples)
    batch["input"] = rng.randn(batch_size, cfg.input_h, cfg.input_w, 3).astype(np.float32)
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def train_model(cfg):
    """The network to train: float32 parameters whatever `cfg.compute_dtype`
    (a bf16 config trains in mixed precision), from seed 0."""
    model = create_model(cfg, DEVICE, generator=torch.Generator().manual_seed(0), param_dtype="float32")
    randomize_offset_convs(model, seed=0)
    return model


def count_dcn_backward_shapes(model, counter: Counter):
    """Forward hooks that hang a gradient hook on every DCN output, counting
    the backward passes through the DCN blocks by (H, C, Co)."""
    def hook(mod, inputs, output):
        if output.requires_grad:
            key = (inputs[0].shape[2], inputs[0].shape[1], output.shape[1])
            output.register_hook(lambda grad, key=key: counter.update([key]))
    return [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, layers.DCN)]


def timed_step(step, state, batch):
    t0 = time.perf_counter()
    state, stats = step(state, batch)
    loss = stats["loss"].item()                          # waits for the device
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, loss


# Kernel families of a profiled step, by the first pattern a kernel's name
# contains (lower case); what matches none is "other".
KERNEL_KINDS = (
    ("dcn backward", ("dcn_v2_bwd", "weight_fragments", "sum_partials")),
    ("dcn forward", ("dcn_v2_fwd",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass", "dgrad", "wgrad", "sm90_")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduction", ("reduce",)),
    ("copy / cast", ("copy", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def profiled_step(step, state, batch):
    """One more step under `torch.profiler`: the device time of its kernels
    by family (KERNEL_KINDS) and the 20 longest kernels, against the step's
    host-clock time (busy share = kernel time / step time). "not measured"
    if the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms, _ = timed_step(step, state, batch)
    by_name = Counter()
    for e in prof.events():
        # Kernels and copies on the device; not the device-side spans of
        # annotations such as `Optimizer.step`, which cover kernels counted.
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    if not by_name:
        return {"step_ms": ms, "device_ms": "not measured"}
    by_kind = Counter()
    for name, t in by_name.items():
        low = name.lower()
        by_kind[next((k for k, pats in KERNEL_KINDS if any(p in low for p in pats)), "other")] += t
    device_ms = sum(by_name.values())
    return {"step_ms": ms, "device_ms": device_ms, "device_busy_share": device_ms / ms,
            "by_kind_ms": dict(by_kind.most_common()),
            "top_kernels_ms": [[n[:120], t] for n, t in by_name.most_common(20)]}


def flat_grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}


def l2(tensors) -> float:
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)))


def finetune_steps(cfg, model, batch, fwd_launches: Counter, count: str):
    """Two fine-tuning steps through the train step's entry points: (a) the
    DCN weights frozen, so that `DCNv2Function.backward` runs the dX and the
    coordinate kernel; (b) nothing but the DCN weights and biases trained, so
    that the blocks that read the frozen trunk run the dW kernel alone. The
    backward kernels' launches are read from the counters' attribute `count`
    ("launches", or "launches_bf16" for the bf16 body) and required to be
    those; the forward's are added to `fwd_launches` by shape."""
    finetune = {}
    dcns = [m for m in model.modules() if isinstance(m, layers.DCN)]
    for name, trainable in (
        ("dcn_weights_frozen", lambda p, own: not own),
        ("only_dcn_weights", lambda p, own: own),
    ):
        own = {id(m.weight) for m in dcns} | {id(m.bias) for m in dcns}
        for p in model.parameters():
            p.requires_grad_(trainable(p, id(p) in own))
        before = {k: getattr(fn, count) for k, (fn, *_rest) in BWD_KERNELS.items()}
        frozen = {k: p.detach().clone() for k, p in model.named_parameters() if not p.requires_grad}
        state_ft, tx_ft = create_train_state(cfg, model, steps_per_epoch=1000)
        fwd_ft = Counter()
        hooks = count_dcn_shapes(model, fwd_ft)
        ms, loss = timed_step(make_train_step(cfg, model, tx_ft), state_ft, batch)
        for h in hooks:
            h.remove()
        require(np.isfinite(loss), f"fine-tuning step {name}: loss {loss}")
        params = dict(model.named_parameters())
        require(all(torch.equal(params[k], v) for k, v in frozen.items()),
                f"fine-tuning step {name}: a frozen parameter changed")
        del frozen
        delta = {k: getattr(fn, count) - before[k] for k, (fn, *_rest) in BWD_KERNELS.items()}
        finetune[name] = {"ms": ms, "loss": loss, "backward_launches": delta}
        fwd_launches.update(fwd_ft)
    ft = finetune["dcn_weights_frozen"]["backward_launches"]
    require(ft == {"dcn_v2_bwd_fused": 0, "dcn_v2_bwd_dx": 16, "dcn_v2_bwd_dcoord": 16, "dcn_v2_bwd_dw": 0},
            f"DCN weights frozen: backward launches {ft}")
    ft = finetune["only_dcn_weights"]["backward_launches"]
    require(ft["dcn_v2_bwd_dw"] > 0 and ft["dcn_v2_bwd_dw"] + ft["dcn_v2_bwd_fused"] == 16
            and ft["dcn_v2_bwd_dx"] == 0 and ft["dcn_v2_bwd_dcoord"] == 0,
            f"only DCN weights trained: backward launches {ft}")
    for p in model.parameters():
        p.requires_grad_(True)
    return finetune


def kernels_vs_plain(small):
    """The network of `small` (128x128, batch 2) through the DCN kernels
    against the same network through the plain DCN, from the same weights
    on the same batch: every gradient with BatchNorm on running statistics
    within 1e-3 of the parameter's largest gradient, and one train step's
    loss within 1e-4 relative and gradient within 1 % in L2 norm."""
    batch = synthetic_batch(small, 2, seed=3)
    loss_cfg = loss_config_from(small)
    real = layers.dcn_v2_forward

    def through(route, fn):
        """fn(model) on a fresh copy of the same network, DCN through `route`."""
        model = train_model(small)
        layers.dcn_v2_forward = route
        try:
            return fn(model)
        finally:
            layers.dcn_v2_forward = real

    def running_stats_grads(model):
        model.eval()                                     # BatchNorm on running statistics
        loss = centerpose_loss(model(batch["input"]), batch, loss_cfg, "train")[0]
        loss.backward()
        return loss.item(), flat_grads(model)

    def one_step(model):
        state, tx = create_train_state(small, model, steps_per_epoch=1000)
        _, stats = make_train_step(small, model, tx)(state, batch)
        return stats["loss"].item(), flat_grads(model)

    worst_rel = 0.0
    loss_k, grads_k = through(real, running_stats_grads)
    loss_p, grads_p = through(dcn_v2, running_stats_grads)
    require(set(grads_k) == set(grads_p), "kernel and plain routes give gradients to different parameters")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"128x128 loss: kernels {loss_k}, plain {loss_p}")
    for k, ref in grads_p.items():
        err = (grads_k[k] - ref).abs().max().item()
        scale = ref.abs().max().item()
        require(err <= 1e-3 * scale + 1e-6, f"128x128, running statistics: gradient of {k} off by {err} (max {scale})")
        worst_rel = max(worst_rel, err / max(scale, 1e-6))
    step_loss_k, step_k = through(real, one_step)
    step_loss_p, step_p = through(dcn_v2, one_step)
    require(abs(step_loss_k - step_loss_p) <= 1e-4 * abs(step_loss_p),
            f"128x128 train step loss: kernels {step_loss_k}, plain {step_loss_p}")
    step_rel = l2([step_k[k] - step_p[k] for k in step_p]) / l2(step_p.values())
    require(step_rel <= 0.01, f"128x128 train step: gradients differ by {step_rel} in L2 norm")
    return {
        "arch": small.arch, "input": [2, small.input_h, small.input_w, 3],
        "running_statistics": {"loss": [loss_k, loss_p], "worst_grad_err_rel_to_param_max": worst_rel,
                               "limit": 1e-3},
        "train_step": {"loss": [step_loss_k, step_loss_p], "grad_rel_l2": step_rel, "limit": 0.01},
    }


def phase_train(per_forward, fwd_entries, bwd_per_shape):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd_launches = Counter()                             # forward launches by shape

    # ---- the main path: full steps, then two fine-tuning steps ------------
    reset_launches()
    batch_size = TRAIN_BATCH
    while True:
        cfg = preset("centerpose", input_h=INPUT, input_w=INPUT, batch_size=batch_size)
        model = train_model(cfg)
        state, tx = create_train_state(cfg, model, steps_per_epoch=1000)
        step = make_train_step(cfg, model, tx)
        batch = synthetic_batch(cfg, batch_size, seed=2)
        fwd_shapes, bwd_shapes = Counter(), Counter()
        hooks = count_dcn_shapes(model, fwd_shapes) + count_dcn_backward_shapes(model, bwd_shapes)
        try:
            first = timed_step(step, state, batch)       # also the warm-up
            break
        except torch.cuda.OutOfMemoryError:
            # The card does not hold the step at this batch: halve it (never
            # the width, depth or resolution) and say so in the result.
            require(batch_size > 1, "one image does not fit in the card's memory")
            del model, state, tx, step, batch, hooks
            torch.cuda.empty_cache()
            reset_launches()
            batch_size //= 2
    timed = [timed_step(step, state, batch) for _ in range(TRAIN_STEPS)]
    # The same steps with cuDNN's convolutions allowed TF32, PyTorch's own
    # default (it has been off since the kernels phase): one step to let
    # cuDNN choose again, then the timed ones.
    torch.backends.cudnn.allow_tf32 = True
    try:
        first_tf32 = timed_step(step, state, batch)
        timed_tf32 = [timed_step(step, state, batch) for _ in range(TRAIN_STEPS)]
    finally:
        torch.backends.cudnn.allow_tf32 = False
    steps = 2 * (1 + TRAIN_STEPS)
    losses = [loss for _, loss in [first] + timed + [first_tf32] + timed_tf32]
    for h in hooks:
        h.remove()
    grads = flat_grads(model)
    n_params = sum(1 for _ in model.parameters())

    require(all(np.isfinite(losses)), f"losses not finite: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall on the same batch: {losses}")
    require(len(grads) == n_params, f"{n_params - len(grads)} parameters have no gradient")
    require(all(torch.isfinite(g).all() for g in grads.values()), "a gradient is not finite")
    offset_grads = [g for k, g in grads.items() if "conv_offset_mask" in k]
    require(len(offset_grads) == 32 and all(g.abs().max() > 0 for g in offset_grads),
            "an offset conv got no gradient")
    require(dcn_v2_forward.launches == 16 * steps, f"{dcn_v2_forward.launches} forward launches in {steps} steps")
    require(dcn_bwd.dcn_v2_bwd_fused.launches == 16 * steps,
            f"{dcn_bwd.dcn_v2_bwd_fused.launches} fused backward launches in {steps} steps")
    for shape, n in per_forward.items():
        require(fwd_shapes[shape] == steps * n and bwd_shapes[shape] == steps * n,
                f"shape {shape}: {fwd_shapes[shape]} forward / {bwd_shapes[shape]} backward "
                f"passes in {steps} steps, {n} per forward in the model phase")
    require(sum(bwd_shapes.values()) == dcn_bwd.dcn_v2_bwd_fused.launches,
            "backward passes by shape differ from the fused kernel's counter")
    fwd_launches.update(fwd_shapes)
    full_step_memory = torch.cuda.max_memory_allocated()
    step_ms = sorted(ms for ms, _ in timed)[len(timed) // 2]
    step_ms_tf32 = sorted(ms for ms, _ in timed_tf32)[len(timed_tf32) // 2]

    # Fine-tuning, through the same entry points: (a) the DCN weights frozen,
    # so that `DCNv2Function.backward` runs the dX and the coordinate kernel;
    # (b) nothing but the DCN weights and biases trained, so that the blocks
    # that read the frozen trunk run the dW kernel alone.
    finetune = finetune_steps(cfg, model, batch, fwd_launches, "launches")
    counts = {"dcn_v2_fwd": dcn_v2_forward.launches,
              **{k: fn.launches for k, (fn, *_rest) in BWD_KERNELS.items()}}   # ---- the main path ends
    require(counts["dcn_v2_fwd"] == 16 * (steps + 2), f"{counts['dcn_v2_fwd']} forward launches on the training path")
    profile_f32 = profiled_step(step, state, batch)     # after the counts are read; TF32 off
    peak_memory = torch.cuda.max_memory_allocated()
    del model, state, tx, step, batch, grads
    torch.cuda.empty_cache()

    # Share of a full step inside its 16 + 16 DCN launches, from this run's
    # per-call times at the same shapes and batch (kernels phases).
    fwd_ms = {tuple(e["shape"][1:2] + e["shape"][3:]): e["ms_f32"] for e in fwd_entries}
    bwd_ms = {tuple(e["shape"][1:2] + e["shape"][3:]): e["ms"] for e in bwd_per_shape["dcn_v2_bwd_fused"]}
    dcn_fwd_ms = sum(n * fwd_ms[shape] for shape, n in per_forward.items())
    dcn_bwd_ms = sum(n * bwd_ms[shape] for shape, n in per_forward.items())

    # ---- kernels against the plain DCN through the whole network, 128x128 ---
    vs_plain = kernels_vs_plain(preset("centerpose", input_h=128, input_w=128, batch_size=2))

    emit({
        "phase": "train", "arch": cfg.arch, "input": [batch_size, INPUT, INPUT, 3], "dtype": "float32",
        "batch": batch_size, "batch_lowered_for_memory": batch_size != TRAIN_BATCH,
        "steps": steps, "losses": losses, "ms_per_step_each": [ms for ms, _ in timed],
        "first_step_ms": first[0], "ms_per_step": step_ms, "images_per_s": batch_size / (step_ms * 1e-3),
        "tf32": "off for cuDNN and matmul in ms_per_step; ms_per_step_cudnn_tf32 allows it for cuDNN",
        "ms_per_step_cudnn_tf32": step_ms_tf32, "images_per_s_cudnn_tf32": batch_size / (step_ms_tf32 * 1e-3),
        "launches": counts, "launches_per_step": {"dcn_v2_fwd": 16, "dcn_v2_bwd_fused": 16},
        "launches_per_step_by_shape": {"x".join(map(str, k)): v for k, v in per_forward.items()},
        "dcn_forward_ms_per_step": dcn_fwd_ms, "dcn_backward_ms_per_step": dcn_bwd_ms,
        "dcn_share_of_step": (dcn_fwd_ms + dcn_bwd_ms) / step_ms,
        "peak_memory_mb": peak_memory / 2 ** 20, "peak_memory_full_step_mb": full_step_memory / 2 ** 20,
        "finetune": finetune, "profiled_step": profile_f32,
        "kernels_vs_plain_128": vs_plain,
    })
    return fwd_launches, counts


def phase_train_bf16(per_forward):
    """The mixed-precision train step (`compute_dtype="bfloat16"`: float32
    parameters, the forward under autocast, the DCN kernels on bf16
    operands) at 512x512, batch 8, beside the float32 step of the train
    phase: one float32 step and one bf16 step from the same weights on the
    same batch (their global gradient norms within 5 %), then the bf16 main
    path: a warm-up and TRAIN_STEPS timed steps and the two fine-tuning
    steps, with every launch counter set to 0 just before and read just
    after. Required: finite losses, float32 gradients, 16 bf16 forward and 16
    bf16 fused backward launches per full step (none on float32 operands),
    the bf16 dX, coordinate and dW bodies launched by the fine-tuning steps."""
    torch.cuda.empty_cache()
    cfg = preset("centerpose", input_h=INPUT, input_w=INPUT, batch_size=TRAIN_BATCH,
                 compute_dtype="bfloat16")
    batch = synthetic_batch(cfg, TRAIN_BATCH, seed=2)

    norms = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        model = train_model(c)
        state, tx = create_train_state(c, model, steps_per_epoch=1000)
        _, loss = timed_step(make_train_step(c, model, tx), state, batch)
        require(np.isfinite(loss), f"{dtype} step: loss {loss}")
        norms[dtype] = tx.norm.item()
        del model, state, tx
        torch.cuda.empty_cache()
    norm_rel = abs(norms["bfloat16"] - norms["float32"]) / norms["float32"]
    require(norm_rel <= 0.05, f"bf16 step: gradient norm {norms['bfloat16']} against float32 {norms['float32']}")

    # ---- the bf16 main path -------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    model = train_model(cfg)
    state, tx = create_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(cfg, model, tx)
    fwd_shapes = Counter()
    hooks = count_dcn_shapes(model, fwd_shapes)
    first = timed_step(step, state, batch)
    timed = [timed_step(step, state, batch) for _ in range(TRAIN_STEPS)]
    for h in hooks:
        h.remove()
    steps = 1 + TRAIN_STEPS
    losses = [loss for _, loss in [first] + timed]
    grads = flat_grads(model)
    require(all(np.isfinite(losses)), f"bf16 losses not finite: {losses}")
    require(all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values()),
            "a bf16 step's gradient is not a finite float32 tensor")
    require(all(p.dtype == torch.float32 for p in model.parameters()), "a parameter left float32")
    fused = dcn_bwd.dcn_v2_bwd_fused
    require(dcn_v2_forward.launches_bf16 == 16 * steps == dcn_v2_forward.launches,
            f"{dcn_v2_forward.launches_bf16} bf16 forward launches ({dcn_v2_forward.launches} in all) "
            f"in {steps} bf16 steps")
    require(fused.launches_bf16 == 16 * steps == fused.launches,
            f"{fused.launches_bf16} bf16 fused backward launches ({fused.launches} in all) in {steps} bf16 steps")
    for shape, n in per_forward.items():
        require(fwd_shapes[shape] == steps * n, f"bf16 step, shape {shape}: {fwd_shapes[shape]} passes")
    full_step_memory = torch.cuda.max_memory_allocated()
    step_ms = sorted(ms for ms, _ in timed)[len(timed) // 2]
    finetune = finetune_steps(cfg, model, batch, Counter(), "launches_bf16")
    counts = {"dcn_v2_fwd": dcn_v2_forward.launches_bf16,
              **{k: fn.launches_bf16 for k, (fn, *_rest) in BWD_KERNELS.items()}}   # ---- the main path ends
    require(all(fn.launches == fn.launches_bf16 for fn, *_rest in BWD_KERNELS.values()),
            "a float32 backward launch on the bf16 path")
    profile = profiled_step(step, state, batch)
    del model, state, tx, step, batch, grads
    torch.cuda.empty_cache()
    f32 = next(p for p in PHASES if p["phase"] == "train")
    emit({
        "phase": "train_bf16", "arch": cfg.arch, "input": [TRAIN_BATCH, INPUT, INPUT, 3],
        "dtype": "bfloat16 compute, float32 parameters / BatchNorm statistics / Adam / loss",
        "steps": steps, "losses": losses, "ms_per_step_each": [ms for ms, _ in timed],
        "first_step_ms": first[0], "ms_per_step": step_ms, "images_per_s": TRAIN_BATCH / (step_ms * 1e-3),
        "peak_memory_full_step_mb": full_step_memory / 2 ** 20,
        "float32_step": {"ms_per_step": f32["ms_per_step"], "images_per_s": f32["images_per_s"],
                         "peak_memory_full_step_mb": f32["peak_memory_full_step_mb"]},
        "grad_norm": norms, "grad_norm_rel_diff": norm_rel, "grad_norm_limit": 0.05,
        "launches": counts, "launches_per_step": {"dcn_v2_fwd_bf16": 16, "dcn_v2_bwd_fused_bf16": 16},
        "finetune": finetune, "profiled_step": profile,
    })
    return counts


def phase_train_cli():
    """`python -m centerpose_tpu_torch.train` in process, on the card: the
    package's synthetic generator writes two videos of 8 frames of 640x480
    into a temporary directory, then `train.main` runs at 512x512, bf16,
    batch 8, 2 loader workers: one epoch (2 steps) with validation and
    checkpoints, then `--resume` for one more. Required: the step 2 -> 4,
    finite losses, checkpoints under ckpt/ and best/, bf16 kernels launched
    (16 forward per step and per validation batch, 16 fused backward per
    step). Prints ms per step and the share of it spent waiting for the
    loader."""
    import tempfile

    from centerpose_tpu_torch import train as train_cli
    from centerpose_tpu_torch.data.synthetic import generate_dataset
    from centerpose_tpu_torch.utils.checkpoint import latest_step

    torch.cuda.empty_cache()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.time()
        data = os.path.join(tmp, "data")
        frames = generate_dataset(data, n_videos=2, frames_per_video=8, seed=0, width=640, height=480)
        gen_s = time.time() - t0
        argv = ["--data_dir", data, "--input_res", str(INPUT), "--compute_dtype", "bfloat16",
                "--batch_size", str(TRAIN_BATCH), "--num_workers", "2", "--val_intervals", "1",
                "--exp_id", "chip_smoke"]
        os.chdir(tmp)
        try:
            reset_launches()
            t0 = time.time()
            first = train_cli.main(argv + ["--num_epochs", "1"])
            second = train_cli.main(argv + ["--num_epochs", "2", "--resume"])
            run_s = time.time() - t0
            counts = {"dcn_v2_fwd": dcn_v2_forward.launches_bf16,
                      "dcn_v2_bwd_fused": dcn_bwd.dcn_v2_bwd_fused.launches_bf16}   # ---- the path ends
            exp = os.path.join(tmp, first["exp_dir"])
            ckpts = {d: latest_step(os.path.join(exp, d)) for d in ("ckpt", "best")}
        finally:
            os.chdir(cwd)
    n_val = len(frames) // TRAIN_BATCH
    require(first["step"] == 2 and second["step"] == 4,
            f"train CLI: step {first['step']} after one epoch, {second['step']} after the resumed one")
    require(ckpts["ckpt"] == 4 and ckpts["best"] in (2, 4), f"train CLI checkpoints: {ckpts}")
    losses = [e["train"]["loss"] for e in first["epochs"] + second["epochs"]]
    losses += [e["val"]["loss"] for e in first["epochs"] + second["epochs"]]
    require(all(np.isfinite(losses)), f"train CLI losses not finite: {losses}")
    require(counts["dcn_v2_bwd_fused"] == 16 * 4, f"train CLI: {counts} bf16 launches in 4 steps")
    require(counts["dcn_v2_fwd"] == 16 * (4 + 2 * n_val),
            f"train CLI: {counts} bf16 launches in 4 steps and {2 * n_val} validation batches")
    step_ms = first["ms_per_step"] + second["ms_per_step"]
    wait_ms = first["loader_wait_ms"] + second["loader_wait_ms"]
    emit({
        "phase": "train_cli", "command": "python -m centerpose_tpu_torch.train " + " ".join(argv),
        "data": {"frames": len(frames), "size": [640, 480], "videos": 2, "generate_s": gen_s},
        "steps": [first["step"], second["step"]], "checkpoints": ckpts,
        "epochs": first["epochs"] + second["epochs"], "seconds": run_s,
        "ms_per_step_each": step_ms, "ms_per_step_median": sorted(step_ms)[len(step_ms) // 2],
        "loader_wait_ms_each": wait_ms, "loader_wait_share": sum(wait_ms) / sum(step_ms),
        "launches_bf16": counts,
    })


# ---------------------------------------------------------------- evaluate
EVAL_VIDEOS, EVAL_FRAMES = 2, 8            # 640x480 frames from the package's generator
EVAL_VIS_THRESH = 0.05                     # random weights score ~0.1: detections, PnP and matching


class MethodTimer:
    """Wall seconds of every call of some methods, by wrapping them on their
    class for the duration of a `with` block (the library carries no timers)."""

    def __init__(self, **targets):
        self.targets = targets                          # label -> (class, method name)
        self.times = {label: [] for label in targets}

    def __enter__(self):
        self.saved = {}
        for label, (cls, name) in self.targets.items():
            fn = getattr(cls, name)
            self.saved[label] = fn

            def timed(*args, _fn=fn, _label=label, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.times[_label].append(time.perf_counter() - t0)

            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for label, (cls, name) in self.targets.items():
            setattr(cls, name, self.saved[label])


def phase_evaluate():
    """`python -m centerpose_tpu_torch.evaluate` in process, on the card
    (`main(argv)`): the package's generator writes 2 videos of 8 frames of
    640x480 (the camera orbiting fixed objects) into a temporary directory,
    packed as tfrecords too. Four runs at 512x512 float32: `--mode metric`
    on dlav1_34 (weights from seed 0, DCN offset convs drawn as the model
    phase draws them, loaded from a `.pth`), the same with `--tracking` on
    the dla_34 tracking model (`track_weights`), the tfrecords with `--n_proc 2` (two spawned
    workers, each with its own `Detector` on the card), and `--mode loss` on
    a checkpoint of the image model's weights written by `save_checkpoint`.
    The runs use a fresh process's TF32 switches (`TF32_DEFAULTS`), as the
    CLI and its spawned workers do, and restore the script's after. The
    launch counters are set to 0 just before each run and read just after,
    and every DCN call of the run is counted by shape (`count_all_dcn_shapes`):
    16 float32 forward launches per image (and per loss batch), the shapes
    those of one forward of the model phase, the shape counts adding up to
    the launch counter. Required: every GT object counted, detections
    matched and scored (num_pred > 0, finite APs), the workers' report on
    the tfrecords equal to the in-process report on the same frames and
    weights, finite losses. Prints images/s and ms per image split into
    `Detector.run` and the evaluator (`evaluate_image`: matching, IoU,
    metrics; `report_dict`: AP). Returns the runs' DCN calls by shape: the
    image model's (image and loss runs) and the tracking model's."""
    import tempfile

    from centerpose_tpu_torch import evaluate as evaluate_cli
    from centerpose_tpu_torch.data.synthetic import generate_dataset
    from centerpose_tpu_torch.data.tfrecord import pack_dope_dataset
    from centerpose_tpu_torch.evaluation.evaluator import Evaluator
    from centerpose_tpu_torch.utils.checkpoint import save_checkpoint

    torch.cuda.empty_cache()
    n_images = EVAL_VIDEOS * EVAL_FRAMES
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        t0 = time.time()
        data = os.path.join(tmp, "frames")
        frames = generate_dataset(data, n_videos=EVAL_VIDEOS, frames_per_video=EVAL_FRAMES, seed=0,
                                  width=640, height=480, video_motion=True)
        records = pack_dope_dataset(data, os.path.join(tmp, "tfrecords"), "shoe")
        n_gt = 0
        for png in frames:
            with open(png[:-4] + ".json") as fh:
                n_gt += len(json.load(fh)["objects"])
        cfg = preset("centerpose", input_h=INPUT, input_w=INPUT)
        model = create_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
        randomize_offset_convs(model, 0)
        torch.save(model.state_dict(), os.path.join(tmp, "image.pth"))
        state, _ = create_train_state(cfg, model)
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, state, 1)
        tcfg = preset("centerpose_track", input_h=INPUT, input_w=INPUT)
        tmodel = create_model(tcfg, "cpu", generator=torch.Generator().manual_seed(0))
        track_weights(tmodel, tcfg, 640, seed=0)
        torch.save(tmodel.state_dict(), os.path.join(tmp, "track.pth"))
        setup_s = time.time() - t0

        runs = {}
        common = ["--data_dir", data, "--input_res", str(INPUT), "--c", "shoe"]
        script_tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = TF32_DEFAULTS
        for label, argv in (
            ("image", [*common, "--load_model", os.path.join(tmp, "image.pth"),
                       "--vis_thresh", str(EVAL_VIS_THRESH)]),
            ("tracking", [*common, "--tracking", "--load_model", os.path.join(tmp, "track.pth"),
                          "--vis_thresh", str(EVAL_VIS_THRESH)]),
            ("tfrecords_n_proc_2", ["--tfrecords", os.path.join(tmp, "tfrecords", "*.tfrecord"),
                                    "--input_res", str(INPUT), "--n_proc", "2",
                                    "--load_model", os.path.join(tmp, "image.pth"),
                                    "--vis_thresh", str(EVAL_VIS_THRESH),
                                    "--report_json", os.path.join(tmp, "n_proc.json")]),
            ("loss", ["--mode", "loss", *common, "--load_model", ckpt]),
        ):
            shapes: Counter = Counter()
            hook = count_all_dcn_shapes(shapes)
            try:
                with MethodTimer(detector=(Detector, "run"), match=(Evaluator, "evaluate_image"),
                                 report=(Evaluator, "report"), report_dict=(Evaluator, "report_dict")) as timer:
                    reset_launches()
                    t0 = time.perf_counter()
                    out = evaluate_cli.main(argv)                  # ---- the path
                    seconds = time.perf_counter() - t0
                    launches = dcn_v2_forward.launches - dcn_v2_forward.launches_bf16   # ---- ends
            finally:
                hook.remove()
            require(sum(shapes.values()) == launches,
                    f"evaluate {label}: DCN calls counted by shape {dict(shapes)} differ from the "
                    f"launch counter {launches}")
            runs[label] = {"out": out, "seconds": seconds, "launches": launches, "times": timer.times,
                           "shapes": shapes}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = script_tf32

    lines = {}
    for label in ("image", "tracking", "tfrecords_n_proc_2"):
        run, rep = runs[label], runs[label]["out"]["report"]
        fams = rep["families"]
        require(rep["num_gt"] == n_gt, f"evaluate {label}: num_gt {rep['num_gt']}, {n_gt} GT objects written")
        require(all(np.isfinite(f["curve"]).all() for f in fams.values()), f"evaluate {label}: AP not finite")
        det = run["times"]["detector"]
        match_s = sum(run["times"]["match"])
        ap_s = sum(run["times"]["report"]) + sum(run["times"]["report_dict"])
        lines[label] = {
            "seconds": run["seconds"], "images_per_s": n_images / run["seconds"],
            "ms_per_image": 1e3 * run["seconds"] / n_images,
            "launches": run["launches"], "launches_per_image": run["launches"] / n_images,
            "num_gt": rep["num_gt"], "num_pred": rep["num_pred"],
            "ap": {f: v["ap"] for f, v in fams.items()}, "consistency": rep.get("consistency"),
        }
        if det:                                     # in this process (not the n_proc workers)
            lines[label].update({
                "detector_ms_per_image": 1e3 * sum(det) / len(det), "detector_calls": len(det),
                "detector_ms_first": 1e3 * det[0], "detector_ms_median": 1e3 * float(np.median(det)),
                "evaluator_ms_per_image": 1e3 * (match_s + ap_s) / n_images,
                "evaluate_image_ms_per_image": 1e3 * match_s / n_images, "ap_report_ms": 1e3 * ap_s,
            })
    for label in ("image", "tracking"):
        line = lines[label]
        require(line.get("detector_calls") == n_images,
                f"evaluate {label}: {line.get('detector_calls')} Detector.run calls for {n_images} images")
        require(line["launches"] == 16 * n_images,
                f"evaluate {label}: {line['launches']} float32 DCN launches for {n_images} images")
        require(line["num_pred"] > 0, f"evaluate {label}: no detection reached the evaluator")
    require(runs["tfrecords_n_proc_2"]["launches"] == 0, "the n_proc workers' launches reached this process")
    same = (json.dumps(runs["tfrecords_n_proc_2"]["out"]["report"], sort_keys=True)
            == json.dumps(runs["image"]["out"]["report"], sort_keys=True))
    require(same, "evaluate: the n_proc workers' report on the tfrecords "
            f"({lines['tfrecords_n_proc_2']['num_pred']} boxes) is not the in-process report on "
            f"the same frames ({lines['image']['num_pred']} boxes)")
    loss = runs["loss"]["out"]["runs"][0]
    require(loss["samples"] == n_images and all(np.isfinite(list(loss["losses"].values()))),
            f"evaluate loss: {loss['samples']} samples, losses {loss['losses']}")
    n_batches = len(loss["ms_per_batch"])
    require(runs["loss"]["launches"] == 16 * n_batches,
            f"evaluate loss: {runs['loss']['launches']} float32 DCN launches for {n_batches} batches")
    emit({
        "phase": "evaluate", "config": "dlav1_34 (tracking: dla_34) 512x512 float32",
        "data": {"frames": n_images, "videos": EVAL_VIDEOS, "size": [640, 480], "gt_objects": n_gt,
                 "tfrecords": len(records), "setup_s": setup_s},
        "vis_thresh": EVAL_VIS_THRESH,
        **lines,
        "loss": {"losses": loss["losses"], "samples": loss["samples"], "ms_per_batch": loss["ms_per_batch"],
                 "seconds": runs["loss"]["seconds"], "launches": runs["loss"]["launches"]},
    })
    return {"image": runs["image"]["shapes"] + runs["loss"]["shapes"],
            "tracking": runs["tracking"]["shapes"]}


# ------------------------------------------------------------------- archs
# The other architectures of the factory, at full width and depth (512x512,
# the JAX preset's head_conv 256): their DCN blocks per forward (resdcn's
# three deconv stages) and the (H, C, Co) the kernels see there.
ARCHS = {"res_18": 0, "resdcn_18": 3, "dlav0_34": 0, "hourglass": 0}
ARCH_TRAIN_STEPS = 3
# resdcn_50's first DCN at 512x512: the stride-32 map of 2048 channels, K = 9
# x 2048, which no DLA shape has (held alone, out of the 16-call totals).
R50_SHAPE = (16, 2048, 256)


def reference_checkpoint(model, arch):
    """`model`'s weights as a reference checkpoint: `{epoch, state_dict}`
    with DataParallel's `module.` prefixes, and for dlav0 the trunk's
    ImageNet classifier that released checkpoints keep (`base.fc.*`)."""
    sd = {"module." + k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if arch.startswith("dlav0"):
        sd["module.base.fc.weight"] = torch.zeros(1000, 512, 1, 1)
        sd["module.base.fc.bias"] = torch.zeros(1000)
    return {"epoch": 1, "state_dict": sd}


def launches_now():
    fused = dcn_bwd.dcn_v2_bwd_fused
    return {"dcn_v2_fwd": dcn_v2_forward.launches - dcn_v2_forward.launches_bf16,
            "dcn_v2_fwd_bf16": dcn_v2_forward.launches_bf16,
            "dcn_v2_bwd_fused": fused.launches - fused.launches_bf16,
            "dcn_v2_bwd_fused_bf16": fused.launches_bf16,
            "dcn_v2_bwd_single_term": sum(fn.launches for name, (fn, *_r) in BWD_KERNELS.items()
                                          if name != "dcn_v2_bwd_fused")}


def arch_serve(arch, n_dcn, fwd_shapes):
    """A bf16 `Detector` whose weights come in as a reference checkpoint of
    another model (through `load_reference_state_dict`): its outputs must be
    that model's to the bit. Then the served path, the counters set to 0
    just before and read just after: `run_batch` on 8 frames of 480x640 and
    one `run`, the forwards through the DCN blocks counted by shape into
    `fwd_shapes`. Times: net + decode on a [8, 512, 512, 3] batch,
    `run_batch` and `run` with their stage split."""
    cfg = preset("centerpose_dla", arch=arch, input_h=INPUT, input_w=INPUT,
                 compute_dtype="bfloat16", vis_thresh=0.05)
    src = create_model(cfg, DEVICE, generator=torch.Generator().manual_seed(0))
    randomize_offset_convs(src, seed=0)
    det = Detector(cfg, state_dict=reference_checkpoint(src, arch), device=DEVICE, seed=1)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, INPUT, INPUT, 3).astype(np.float32)).to(DEVICE)
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            a, b = src(x), det.model(x)
        same = {h: bool(torch.equal(a[h], b[h])) for h in a}
    finally:
        torch.backends.cudnn.deterministic = False
    require(all(same.values()), f"{arch}: a model loaded from its reference checkpoint differs: {same}")
    del src, a, b, x

    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8) for _ in range(SERVE_BATCH + 1)]
    det.run(frames[0])                                   # warm-up, not counted
    det.run_batch(frames[1:], timing=True)
    torch.cuda.synchronize()
    shapes = Counter()
    hooks = count_dcn_shapes(det.model, shapes)
    reset_launches()                                     # ---- the main path starts
    t0 = time.perf_counter()
    batch = det.run_batch(frames[1:], timing=True)
    t1 = time.perf_counter()
    single = det.run(frames[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launches_now()                              # ---- and ends
    for h in hooks:
        h.remove()
    require(sum(shapes.values()) == counts["dcn_v2_fwd_bf16"] and set(shapes) <= set(PRODUCTION_SHAPES),
            f"{arch}: served DCN passes by shape {dict(shapes)}, launches {counts}")
    fwd_shapes.update(shapes)
    require(counts["dcn_v2_fwd_bf16"] == 2 * n_dcn and counts["dcn_v2_fwd"] == 0,
            f"{arch} served 2 forwards with {counts} launches, expected {n_dcn} bf16 per forward")
    outs = batch + [single]
    require(all(np.isfinite(d["bbox"]).all() and np.isfinite(d["score"]) for o in outs for d in o["results"]),
            f"{arch}: a served box or score is not finite")
    images = torch.from_numpy(np.random.RandomState(0).randn(
        SERVE_BATCH, INPUT, INPUT, 3).astype(np.float32)).to(DEVICE)
    out, dets = forward_decode(det.model, images, cfg)
    for name, n in cfg.heads.items():
        require(tuple(out[name].shape) == (SERVE_BATCH, INPUT // 4, INPUT // 4, n), (arch, name, out[name].shape))
        require(torch.isfinite(out[name].float()).all(), f"{arch}: head {name} not finite")
    ms = time_ms(lambda: forward_decode(det.model, images, cfg), iters=6)
    reset_launches()
    del det, images, out, dets
    torch.cuda.empty_cache()
    return {"reference_checkpoint_same_bits": same, "launches": counts,
            "ms_per_batch_net_decode": ms, "images_per_s": SERVE_BATCH / (ms * 1e-3),
            "run_batch_ms": (t1 - t0) * 1e3, "run_batch_times_s": batch[0]["times"],
            "run_ms": (t2 - t1) * 1e3, "run_times_s": single["times"],
            "detections_per_image": [len(o["results"]) for o in outs]}


def arch_train(arch, n_dcn, dtype, fwd_shapes):
    """`make_train_step` at 512x512, batch 8, float32 (TF32 off) or bf16
    mixed precision (float32 parameters), on a `render_targets` batch: a
    warm-up step and ARCH_TRAIN_STEPS timed ones, the counters set to 0 just
    before and read just after; forward passes through the DCN blocks
    counted by shape into `fwd_shapes`."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = preset("centerpose_dla", arch=arch, input_h=INPUT, input_w=INPUT, batch_size=TRAIN_BATCH,
                 compute_dtype=dtype)
    model = train_model(cfg)
    state, tx = create_train_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(cfg, model, tx)
    batch = synthetic_batch(cfg, TRAIN_BATCH, seed=5)
    shapes, bwd = Counter(), Counter()
    hooks = count_dcn_shapes(model, shapes) + count_dcn_backward_shapes(model, bwd)
    reset_launches()                                     # ---- the main path starts
    first = timed_step(step, state, batch)
    timed = [timed_step(step, state, batch) for _ in range(ARCH_TRAIN_STEPS)]
    counts = launches_now()                              # ---- and ends
    for h in hooks:
        h.remove()
    steps = 1 + ARCH_TRAIN_STEPS
    losses = [loss for _, loss in [first] + timed]
    require(all(np.isfinite(losses)), f"{arch} {dtype}: losses {losses}")
    require(all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters()),
            f"{arch} {dtype}: a gradient is not finite")
    tag = "" if dtype == "float32" else "_bf16"
    other = "_bf16" if dtype == "float32" else ""
    require(counts["dcn_v2_fwd" + tag] == counts["dcn_v2_bwd_fused" + tag] == steps * n_dcn
            and counts["dcn_v2_fwd" + other] == counts["dcn_v2_bwd_fused" + other] == 0
            and counts["dcn_v2_bwd_single_term"] == 0,
            f"{arch} {dtype}: {counts} launches in {steps} steps, expected {n_dcn} forward and "
            f"{n_dcn} fused backward per step")
    require(sum(shapes.values()) == sum(bwd.values()) == steps * n_dcn and set(shapes) <= set(PRODUCTION_SHAPES),
            f"{arch} {dtype}: DCN passes by shape {dict(shapes)} / {dict(bwd)}")
    fwd_shapes.update(shapes)
    step_ms = sorted(ms for ms, _ in timed)[len(timed) // 2]
    peak = torch.cuda.max_memory_allocated()
    del model, state, tx, step, batch
    torch.cuda.empty_cache()
    return {"ms_per_step": step_ms, "ms_per_step_each": [ms for ms, _ in timed], "first_step_ms": first[0],
            "images_per_s": TRAIN_BATCH / (step_ms * 1e-3), "peak_memory_mb": peak / 2 ** 20,
            "losses": losses, "launches": counts,
            "dcn_passes_per_step_by_shape": {"x".join(map(str, k)): v // steps for k, v in shapes.items()}}


def phase_archs(fwd_entries, bwd_per_shape, bwd_bf16_per_shape):
    """res_18, resdcn_18, dlav0_34 and hourglass at 512x512 (`preset(
    "centerpose_dla", arch=A)`, random weights from seed 0, resdcn's offset
    convs drawn as `randomize_offset_convs` draws them): served in bf16 and
    trained in float32 and in bf16 mixed precision at batch 8; resdcn_18
    launches the forward and the fused backward kernel at each of its three
    DCN blocks, the others launch none. One line per architecture; then
    resdcn_18 through the kernels against the plain DCN at 128x128. Returns
    the forward launches by (H, C, Co) over the phase's main paths and the
    fused backward launches by type."""
    fwd_shapes, fused = Counter(), Counter()
    fwd_ms = {tuple(e["shape"][1:2] + e["shape"][3:]): e for e in fwd_entries}
    for arch, n_dcn in ARCHS.items():
        serve = arch_serve(arch, n_dcn, fwd_shapes)
        shapes = Counter()
        train = {dt: arch_train(arch, n_dcn, dt, shapes) for dt in ("float32", "bfloat16")}
        fused["float32"] += train["float32"]["launches"]["dcn_v2_bwd_fused"]
        fused["bfloat16"] += train["bfloat16"]["launches"]["dcn_v2_bwd_fused_bf16"]
        fwd_shapes.update(shapes)
        per_forward = Counter({k: v // (2 * (1 + ARCH_TRAIN_STEPS)) for k, v in shapes.items()})
        line = {"phase": "archs", "arch": arch, "input": [TRAIN_BATCH, INPUT, INPUT, 3],
                "head_conv": preset("centerpose_dla", arch=arch).head_conv,
                "dcn_blocks": n_dcn, "serve_bf16": serve, "train_float32": train["float32"],
                "train_bf16": train["bfloat16"]}
        if n_dcn:
            bwd = {dt: {tuple(r["shape"][1:2] + r["shape"][3:]): r["ms"]
                        for r in rows["dcn_v2_bwd_fused"]}
                   for dt, rows in (("float32", bwd_per_shape), ("bfloat16", bwd_bf16_per_shape))}
            share = {}
            for dt, key in (("float32", "ms_f32"), ("bfloat16", "ms")):
                k_ms = sum(n * (fwd_ms[s][key] + bwd[dt][s]) for s, n in per_forward.items())
                share[dt] = {"dcn_kernels_ms_per_step": k_ms,
                             "share_of_step": k_ms / train[dt]["ms_per_step"]}
            line["dcn_kernels_per_step"] = share
            line["kernels_vs_plain_128"] = kernels_vs_plain(
                preset("centerpose_dla", arch=arch, input_h=128, input_w=128, batch_size=2))
        emit(line)
    return fwd_shapes, fused


def phase_kernels_r50():
    """resdcn_50's first DCN (16x16, C 2048 -> Co 256, batch 8): the forward
    in float32 and bf16 and the fused backward in float32 and bf16 against
    the plain versions, at the kernels phases' tolerances, with plans, times
    and bounds. These calls are not part of any counted path."""
    hw, c, co = R50_SHAPE
    out = {"shape": [TRAIN_BATCH, hw, hw, c, co],
           "plans": {"bf16": plan_of(TRAIN_BATCH, hw, hw, c, co),
                     "f32": f32_plan_of(TRAIN_BATCH, hw, hw, c, co),
                     "backward_f32": bwd_plans(TRAIN_BATCH, hw, c, co)["fused"],
                     "backward_bf16": bwd_plans(TRAIN_BATCH, hw, c, co, torch.bfloat16)["fused"]}}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args = make_case(80, TRAIN_BATCH, hw, c, co, dtype, "uniform")
        err, ref_max = check_case(args, dtype)
        ok = err <= TOL_F32 if dtype == torch.float32 else err <= TOL_BF16_REL * ref_max
        require(ok, f"resdcn_50 shape {dtype}: forward off by {err} (output max {ref_max})")
        with torch.no_grad():
            ms = time_ms(lambda: dcn_v2_forward(*args), iters=10, queued=True)
            plain_ms = time_ms(lambda: dcn_v2(*args), iters=2, warmup=1)
        bound, bound_by, _, _ = dcn_bound_ms(TRAIN_BATCH, hw, c, co, dtype)
        require(bound <= ms, f"resdcn_50 forward {dtype}: {ms} ms under its bound {bound}")
        dout = make_dout(80, TRAIN_BATCH, hw, co, dtype)
        ref = dcn_bwd.dcn_v2_grads_plain(*args, dout)
        got = dcn_bwd.dcn_v2_bwd_fused(*args[:4], dout)
        tol = (TOL_BWD_REL, TOL_BWD_ABS) if dtype == torch.float32 else (TOL_BWD_BF16["rel"], TOL_BWD_BF16["abs"])
        bwd_err = {}
        for name, g, r in zip(GRAD_NAMES, got, ref):
            e = (g.float() - r.float()).abs().max().item()
            limit = tol[0] * r.float().abs().max().item() + tol[1]
            require(torch.isfinite(g).all() and e <= limit, f"resdcn_50 fused backward {dtype}: {name} off by {e}, limit {limit}")
            bwd_err[name] = e
        del ref, got
        bwd_ms = time_ms(lambda: dcn_bwd.dcn_v2_bwd_fused(*args[:4], dout), iters=5, queued=True)
        bwd_plain_ms = time_ms(lambda: dcn_bwd.dcn_v2_grads_plain(*args, dout), iters=2, warmup=1)
        b_bound, b_by = bwd_bound_ms(TRAIN_BATCH, hw, c, co, 2, (0, 1, 2, 3), dtype)
        require(b_bound <= bwd_ms, f"resdcn_50 fused backward {dtype}: {bwd_ms} ms under its bound {b_bound}")
        out[tag] = {"forward": {"max_abs_err": err, "output_max": ref_max, "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": bound_by},
                    "fused_backward": {"max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                                       "bound_ms": b_bound, "bound_by": b_by}}
        del args, dout
    torch.cuda.empty_cache()
    reset_launches()
    emit({"phase": "kernels_r50", "arch": "resdcn_50", "what": "first DCN at 512x512, K = 9 x 2048",
          "tolerance": {"forward_f32_abs": TOL_F32, "forward_bf16_rel_to_output_max": TOL_BF16_REL,
                        "backward_f32": [TOL_BWD_REL, TOL_BWD_ABS],
                        "backward_bf16": [TOL_BWD_BF16["rel"], TOL_BWD_BF16["abs"]]},
          "totals": "not part of the 16-call totals", **out})


def backward_entries(bwd_per_shape, per_forward, counts, dtype="float32"):
    """One entry per backward kernel (a bf16 body's named with `_bf16`):
    error the worst over the 7 shapes, times and bound summed over the 16
    calls of one train step (each shape times the number of blocks of that
    shape), launches from the train phase of that type."""
    entries = []
    suffix = "" if dtype == "float32" else "_bf16"
    for name, (_, replaces, _, _) in BWD_KERNELS.items():
        rows = bwd_per_shape[name]
        weight = [per_forward[tuple(r["shape"][1:2] + r["shape"][3:])] for r in rows]
        by = Counter()
        for n, r in zip(weight, rows):
            by[r["bound_by"]] += n * r["bound_ms"]
        entries.append({
            "name": name + suffix, "route": "cuda", "source": BWD_SOURCE, "replaces": replaces,
            "dtype": dtype, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(n * r["ms"] for n, r in zip(weight, rows)),
            "plain_ms": sum(n * r["plain_ms"] for n, r in zip(weight, rows)),
            "bound_ms": sum(n * r["bound_ms"] for n, r in zip(weight, rows)),
            "bound_by": by.most_common(1)[0][0],
            "library_ms": None,
            "times_are": "sums over the 16 DCN calls of one train step at batch %d" % TRAIN_BATCH,
            "per_shape": rows,
        })
        require(counts[name] > 0, f"the {dtype} training path never launched {name}")
    return entries


def row_kernel_entry(entries, per_forward, launches_track):
    """The entry of the TPU kernel `_row_kernel` (B2): its counterpart is the
    same CUDA kernel, on the tracking path, one frame per call. Times and
    bound are float32 at B=1 (the demo's default type), summed over the 16
    DCN calls of one frame; per-shape rows in both types."""
    rows, by = [], Counter()
    for e in entries:
        _, hw, _, c, co = e["shape"]
        n = per_forward[(hw, c, co)]
        rows.append({"shape": [1, hw, hw, c, co], "calls_per_frame": n,
                     **{k: e[k] for k in e if k.startswith("b1_")}})
        by[e["b1_bound_by_f32"]] += n * e["b1_bound_ms_f32"]

    def total(key):
        return sum(r["calls_per_frame"] * r[key] for r in rows)

    return {
        "name": "dcn_v2_fwd", "tpu_kernel": "_row_kernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": ROW_KERNEL_REPLACES, "dtype": "float32", "launches": launches_track,
        "max_abs_err": max(r["b1_max_abs_err_f32"] for r in rows),
        "ms": total("b1_ms_f32"), "plain_ms": total("b1_plain_ms_f32"),
        "bound_ms": total("b1_bound_ms_f32"), "bound_by": by.most_common(1)[0][0],
        "library_ms": None,
        "bfloat16": {"ms": total("b1_ms"), "plain_ms": total("b1_plain_ms"),
                     "bound_ms": total("b1_bound_ms")},
        "times_are": "sums over the 16 DCN calls of one frame at batch 1 (per-call CUDA events)",
        "launches_are": "the track phase's float32 pass over the video",
        "per_shape": rows,
    }


def compared_totals(entries, per_forward):
    """Each `--compare` build of the forward against this checkout's, summed
    over the 16 calls of one forward at the network's shape counts: at B=8
    (a train step in float32, a served batch in bf16) and at B=1 (a tracked
    frame); the means of the two turns of each."""
    totals = {}
    for key, dtype in (("compared_f32", "float32"), ("compared", "bfloat16")):
        for e in entries:
            _, hw, _, c, co = e["shape"]
            n = per_forward[(hw, c, co)]
            for batch, rows in e.get(key, {}).items():
                for label, r in rows.items():
                    t = totals.setdefault(dtype, {}).setdefault(label, {}).setdefault(
                        batch, {"other_ms": 0.0, "this_ms": 0.0, "bound_ms": 0.0})
                    t["other_ms"] += n * sum(r["other_ms"]) / 2
                    t["this_ms"] += n * sum(r["this_ms"]) / 2
                    t["bound_ms"] += n * r["bound_ms"]
    for by_label in totals.values():
        for by_batch in by_label.values():
            for t in by_batch.values():
                t["ratio"] = t["this_ms"] / t["other_ms"]
    return totals


def main() -> int:
    t_start = time.time()
    smi = phase_env()
    phase_build()
    entries = phase_kernels()
    bwd_per_shape = phase_kernels_bwd()
    bwd_bf16_per_shape = phase_kernels_bwd_bf16()
    cfg, state, per_forward = phase_model()
    if COMPARE_FWD:
        emit({"phase": "compared_totals", "per": "the 16 calls of one forward, b8: batch 8, b1: batch 1",
              **compared_totals(entries, per_forward)})
    launches, shape_counts = phase_serve(cfg, state)
    track_counts, track_launches, _ = phase_track(per_forward)
    train_fwd_launches, train_counts = phase_train(per_forward, entries, bwd_per_shape)
    train_bf16_counts = phase_train_bf16(per_forward)
    phase_train_cli()
    eval_counts = phase_evaluate()
    phase_kernels_r50()
    archs_fwd, archs_fused = phase_archs(entries, bwd_per_shape, bwd_bf16_per_shape)

    # All counts are this run's: one forward of the model phase, the serve
    # phase's four forwards (3 `run` + 1 `run_batch`), the train phase's steps.
    for e in entries:
        _, hw, _, c, co = e["shape"]
        e["launches_per_forward"] = per_forward.get((hw, c, co), 0)
        e["launches"] = shape_counts.get((hw, c, co), 0)
        require(e["launches"] > 0, f"the serving path never launched the kernel at {e['shape']}")
        require(e["launches"] == 4 * e["launches_per_forward"],
                f"{e['shape']}: {e['launches']} launches in 4 served forwards, "
                f"{e['launches_per_forward']} in the model phase's one")
        e["launches_track"] = track_counts.get((hw, c, co), 0)
        require(e["launches_track"] > 0, f"the tracking path never launched the kernel at {e['shape']}")
        e["launches_train"] = train_fwd_launches.get((hw, c, co), 0)
        require(e["launches_train"] > 0, f"the training path never launched the forward kernel at {e['shape']}")
        e["launches_archs"] = archs_fwd.get((hw, c, co), 0)
        e["launches_evaluate"] = eval_counts["image"].get((hw, c, co), 0)
        require(e["launches_evaluate"] > 0, f"the evaluate path never launched the kernel at {e['shape']}")
    require(sum(e["launches"] for e in entries) == launches, "launches by shape do not add up to the counter")
    require(sum(e["launches_train"] for e in entries) == train_counts["dcn_v2_fwd"],
            "training launches by shape do not add up to the counter")
    require(sum(e["launches_track"] for e in entries) == track_launches,
            "tracking launches by shape do not add up to the counter")
    require(sum(e["launches_archs"] for e in entries) == sum(archs_fwd.values()) > 0,
            "the archs phase's forward launches are not all at production shapes")
    require(sum(e["launches_evaluate"] for e in entries) == sum(eval_counts["image"].values()),
            "the evaluate phase's image-model launches are not all at production shapes")
    fused_entries = {dt: backward_entries(rows, per_forward, counts, dt) for dt, rows, counts in (
        ("float32", bwd_per_shape, train_counts), ("bfloat16", bwd_bf16_per_shape, train_bf16_counts))}
    for dt, rows in fused_entries.items():
        entry = next(e for e in rows if e["name"].startswith("dcn_v2_bwd_fused"))
        entry["launches_archs"] = archs_fused[dt]
        require(entry["launches_archs"] > 0, f"the archs phase never launched the fused backward ({dt})")
    row_entry = row_kernel_entry(entries, per_forward, track_launches)
    for row in row_entry["per_shape"]:
        _, hw, _, c, co = row["shape"]
        row["launches_evaluate"] = eval_counts["tracking"].get((hw, c, co), 0)
    row_entry["launches_evaluate"] = sum(row["launches_evaluate"] for row in row_entry["per_shape"])
    require(row_entry["launches_evaluate"] == sum(eval_counts["tracking"].values()) > 0,
            "the evaluate phase's tracking launches are not all at production shapes")
    summary = {"kernels": entries + [row_entry]
               + fused_entries["float32"] + fused_entries["bfloat16"]}
    # A kernel faster than its bound would mean a wrong bound, not a fast
    # kernel: every entry's time, and the float32 times (B=8, B=1) of the
    # forward's entries.
    for e in summary["kernels"]:
        for ms_key, bound_key in (("ms", "bound_ms"), ("ms_f32", "bound_ms_f32"),
                                  ("b1_ms_f32", "b1_bound_ms_f32")):
            if ms_key in e:
                require(e[bound_key] <= e[ms_key],
                        f"{e['name']} {e.get('shape', '')}: {ms_key} {e[ms_key]} ms under its bound {e[bound_key]}")
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    if OUT_DIR:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "phases": PHASES, **summary}, fh, indent=1)
    emit(summary)
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
