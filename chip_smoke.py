#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

drives `centerpose_tpu_torch`'s serving path at the full width of the flagship
model (dlav1_34 at 512x512, random weights from seed 0) through the entry
points a user calls, builds the CUDA kernel from the sources in this checkout,
holds it against its plain PyTorch version on the card, and shows that the
serving path really went through it. Every phase prints one JSON line; a phase
that fails raises and the process exits non-zero. Without a CUDA device it
exits with code 2 and prints no result. It imports nothing of JAX.

Phases:
  env      versions, the card's name and power limit.
  build    nvcc builds csrc/*.cu (seconds; the compiler's register / shared
           memory report is printed).
  kernels  `dcn_v2_forward` against `dcn_v2` on the 7 distinct DCN shapes of
           one dlav1_34 forward at 512x512, float32 and bfloat16: B=2 cases
           with uniform +-3 offsets, integer offsets, every sample off the
           image, and |dy| up to 20; a B=1 case (what `Detector.run` gives
           it); then agreement and times at the serving batch B=8. Operands
           are made as the network makes them: offset (and, in one case, the
           mask) a channel slice of one [B, H, W, 27] tensor, the weight in
           the kernel's memory layout.
           Tolerances: float32 1e-4 absolute (summation order of a
           9*C-term product); bfloat16 3e-2 of the output's largest
           magnitude (bf16 inputs and one rounding of columns and output).
           float32 comparisons run with TF32 switched off for cuDNN and
           matmul.
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

`--out DIR` also writes every phase's line and the kernel table to
`DIR/chip_smoke_kernels.json`.
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
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices  # noqa: E402
from centerpose_tpu_torch.inference.detector import DEFAULT_CAMERA, Detector  # noqa: E402
from centerpose_tpu_torch.models import layers  # noqa: E402
from centerpose_tpu_torch.models.factory import create_model  # noqa: E402
from centerpose_tpu_torch.ops.dcn import dcn_v2  # noqa: E402
from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward, kernel_weight  # noqa: E402
from centerpose_tpu_torch.ops.decode import object_pose_decode  # noqa: E402
from centerpose_tpu_torch.ops.pnp import solve_pnp_batch_padded  # noqa: E402

DEVICE = torch.device("cuda")
# `--out DIR`: also write the phases' lines and the kernel table to
# DIR/chip_smoke_kernels.json.
OUT_DIR = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv[1:-1] else None
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

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the yardstick of
# `bound_ms`, whatever power limit the card in hand is set to.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL_F32 = 1e-4
TOL_BF16_REL = 3e-2

KERNEL_SOURCE = "centerpose_tpu_torch/csrc/dcn_v2_fwd.cu"
KERNEL_REPLACES = "centerpose_tpu/ops/dcn_onehot.py:237"


def require(cond, message) -> None:
    """A check that also holds under `python -O`."""
    if not cond:
        raise RuntimeError(str(message))


def emit(obj) -> None:
    if "phase" in obj:
        PHASES.append(obj)
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() in ms: CUDA events around `iters` back-to-back calls
    after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


# ------------------------------------------------------------------- build
def phase_build() -> None:
    t0 = time.time()
    logs = _build.build_all()
    dcn_v2_forward(*make_case(0, 1, 8, 8, 8, torch.float32, "uniform"))
    torch.cuda.synchronize()
    dcn_v2_forward.launches = 0
    report = {
        name: [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln or "error" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "sources": _build.sources(), "ptxas": report})


# ----------------------------------------------------------------- kernels
def make_case(seed, b, hw, c, co, dtype, kind):
    """Operands of one DCN call on the card, made with numpy from `seed` and
    laid out as `models/layers.py::DCN.operands` lays them out: `offset` is
    the [..., :18] slice of a [B, H, W, 27] tensor (pixel stride 27), `mask`
    the sigmoid of its [..., 18:] slice (a tensor of its own, pixel stride
    9), and the weight starts as [Co, C, 3, 3] and goes through
    `kernel_weight`. The "integer" case instead holds gates in the last 9
    channels and hands the kernel that slice itself, so the mask's pixel
    stride is 27 there."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, hw, hw, c)
    om = np.empty((b, hw, hw, 27))
    if kind == "uniform":
        om[..., :18] = (rng.rand(b, hw, hw, 18) * 2 - 1) * 3.0
    elif kind == "integer":
        om[..., :18] = rng.randint(-3, 4, (b, hw, hw, 18))
    elif kind == "off_image":
        om[..., 0:18:2] = -(hw + 5.25)
        om[..., 1:18:2] = hw + 7.5
    elif kind == "dy20":
        om[..., :18] = (rng.rand(b, hw, hw, 18) * 2 - 1) * 2.0
        om[..., 0:18:2] = (rng.rand(b, hw, hw, 9) * 2 - 1) * 20.0
    else:
        raise ValueError(kind)
    if kind == "integer":
        om[..., 18:] = rng.rand(b, hw, hw, 9)
    else:
        om[..., 18:] = rng.randn(b, hw, hw, 9) * 2.0
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


def phase_kernels():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # (seed, B, kind): four kinds of offsets at B=2, the batch of
    # `Detector.run`, and the serving batch, which is also the one timed.
    cases = [(s, 2, k) for s, k in enumerate(("uniform", "integer", "off_image", "dy20"))]
    cases += [(7, 1, "uniform"), (8, 1, "integer"), (9, SERVE_BATCH, "integer"), (10, SERVE_BATCH, "uniform")]
    entries = []
    n_cases = 0
    for hw, c, co in PRODUCTION_SHAPES:
        entry = {
            "name": "dcn_v2_fwd", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "shape": [SERVE_BATCH, hw, hw, c, co],
            "dtype": "bfloat16", "library_ms": None,
        }
        for dtype, tag in ((torch.float32, "_f32"), (torch.bfloat16, "")):
            worst, worst_rel = 0.0, 0.0
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
            # `args` is now the last case, at the serving batch: the times.
            with torch.no_grad():
                ms = time_ms(lambda: dcn_v2_forward(*args), iters=20)
                plain_ms = time_ms(lambda: dcn_v2(*args), iters=3, warmup=1)
            bound, bound_by, flops, nbytes = dcn_bound_ms(SERVE_BATCH, hw, c, co, dtype)
            entry.update({
                "max_abs_err" + tag: worst, "max_rel_err" + tag: worst_rel,
                "ms" + tag: ms, "plain_ms" + tag: plain_ms,
                "bound_ms" + tag: bound, "bound_by" + tag: bound_by,
                "tflops" + tag: flops / (ms * 1e-3) / 1e12,
            })
            del args
        entries.append(entry)
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "cases": n_cases, "tf32": "off for cudnn and matmul",
          "batches": sorted({b for _, b, _ in cases}),
          "tolerance": {"float32_abs": TOL_F32, "bfloat16_rel_to_output_max": TOL_BF16_REL},
          "worst_f32_abs": max(e["max_abs_err_f32"] for e in entries),
          "worst_bf16_rel": max(e["max_rel_err"] for e in entries)})
    return entries


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


def main() -> int:
    t_start = time.time()
    smi = phase_env()
    phase_build()
    entries = phase_kernels()
    cfg, state, per_forward = phase_model()
    launches, shape_counts = phase_serve(cfg, state)

    # Both counts are this run's: one forward of the model phase, and the
    # serve phase's four forwards (3 `run` + 1 `run_batch`).
    for e in entries:
        _, hw, _, c, co = e["shape"]
        e["launches_per_forward"] = per_forward.get((hw, c, co), 0)
        e["launches"] = shape_counts.get((hw, c, co), 0)
        require(e["launches"] > 0, f"the serving path never launched the kernel at {e['shape']}")
        require(e["launches"] == 4 * e["launches_per_forward"],
                f"{e['shape']}: {e['launches']} launches in 4 served forwards, "
                f"{e['launches_per_forward']} in the model phase's one")
    require(sum(e["launches"] for e in entries) == launches, "launches by shape do not add up to the counter")
    summary = {"kernels": entries}
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
