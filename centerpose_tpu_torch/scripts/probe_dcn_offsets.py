"""Probe whether the DCN offsets moved during training.

    python -m centerpose_tpu_torch.scripts.probe_dcn_offsets --ckpt exp/dlav1_34/accuracy_loop/best \\
        --data_dir DATA --input_res 512 --out probe.json
    python -m centerpose_tpu_torch.scripts.probe_dcn_offsets --init --data_dir DATA --device cpu

Twin of the JAX package's `scripts/probe_dcn_offsets.py`. Every DCN block
computes its (offset, mask) from a zero-initialised `conv_offset_mask` conv
(DCNv2/dcn_v2.py:114-116, `models/layers.py::DCN`), so at init every offset
is exactly 0 and every gate sigmoid(0) = 0.5: the block is a plain 3x3 conv.
Training moves them only through the d_offset and d_mask terms of the DCN
backward kernel. This script runs real frames through the network, catches
each `conv_offset_mask` output with a forward hook (where the JAX script uses
flax's `capture_intermediates`) and reports per layer the |offset| mean, 90th
percentile and maximum (in feature-grid pixels), the mean gate and the gate's
mean distance from 0.5, and their means (maximum for the offset maximum)
over the layers. Layers carry the JAX package's module paths
(`dla_up/ida_0/stage_1/proj`, ...), so the two reports compare key for key.

Frames are the first `--n_frames` `.png` files under `--data_dir` in sorted
order, centre-cropped and warped to `--input_res` as the detector does.
`--init` probes a freshly built model (weights from seed 0): offsets must be
exactly 0 and gates exactly 0.5. Runs on the GPU (`--device cuda`, the
default) unless asked for the CPU; the network runs in float32.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from centerpose_tpu_torch.config import DATA_MEAN, DATA_STD, preset
from centerpose_tpu_torch.geometry.affine import get_affine_transform, warp_affine


def load_frames(data_dir: str, n: int, input_res: int) -> np.ndarray:
    """[n, input_res, input_res, 3] normalised float32 frames."""
    from PIL import Image

    paths = []
    for root, _, files in os.walk(data_dir):
        paths.extend(os.path.join(root, f) for f in sorted(files) if f.endswith(".png"))
    paths = sorted(paths)[:n]
    if not paths:
        raise SystemExit(f"no .png frames under {data_dir}")
    batch = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.float32)
        h, w = img.shape[:2]
        c = np.array([w / 2.0, h / 2.0], np.float32)
        trans = get_affine_transform(c, max(h, w) * 1.0, 0, (input_res, input_res))
        inp = warp_affine(img, trans, (input_res, input_res))
        batch.append((inp / 255.0 - np.asarray(DATA_MEAN)) / np.asarray(DATA_STD))
    return np.stack(batch).astype(np.float32)


def jax_name(name: str) -> str:
    """This package's module name of an offset conv -> the JAX package's
    path of its block: `dla_up.ida_0.proj_1.conv.conv_offset_mask` ->
    `dla_up/ida_0/stage_1/proj`."""
    parts = name.split(".")
    if parts[-2:] != ["conv", "conv_offset_mask"]:
        raise ValueError(f"not the offset conv of a DeformConvBlock: {name}")
    out = []
    for part in parts[:-2]:
        kind, _, index = part.rpartition("_")
        out += [f"stage_{index}", kind] if kind in ("proj", "node") and index.isdigit() else [part]
    return "/".join(out)


def offset_stats(om: np.ndarray) -> Dict[str, float]:
    """Statistics of one NHWC `conv_offset_mask` output: channels [0:18] the
    offsets, [18:27] the mask logits."""
    off = om[..., :18]
    mask = 1.0 / (1.0 + np.exp(-om[..., 18:]))
    mag = np.abs(off)
    return {
        "offset_abs_mean": float(mag.mean()),
        "offset_abs_p90": float(np.percentile(mag, 90)),
        "offset_abs_max": float(mag.max()),
        "mask_mean": float(mask.mean()),
        "mask_dev_from_half_mean": float(np.abs(mask - 0.5).mean()),
    }


def capture_offset_masks(model: torch.nn.Module, x: torch.Tensor) -> Dict[str, np.ndarray]:
    """One eval forward of `x` (NHWC); every `conv_offset_mask` output as
    float32 NHWC numpy, keyed by its block's JAX path, in forward order."""
    caught: Dict[str, np.ndarray] = {}

    def hook(name):
        def keep(_mod, _inputs, output):
            caught[name] = output.permute(0, 2, 3, 1).float().cpu().numpy()
        return keep

    hooks = [mod.register_forward_hook(hook(jax_name(name)))
             for name, mod in model.named_modules() if name.endswith("conv_offset_mask")]
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return caught


def probe(model: torch.nn.Module, frames: np.ndarray) -> dict:
    """`{"overall": ..., "layers": {path: stats}}` of `model` on `frames`."""
    device = next(model.parameters()).device
    layers = {name: offset_stats(om) for name, om in
              capture_offset_masks(model, torch.from_numpy(frames).to(device)).items()}

    def over(key, reduce):
        return float(reduce([v[key] for v in layers.values()])) if layers else None

    overall = {
        "n_dcn_layers": len(layers),
        "offset_abs_mean": over("offset_abs_mean", np.mean),
        "offset_abs_max": over("offset_abs_max", np.max),
        "mask_dev_from_half_mean": over("mask_dev_from_half_mean", np.mean),
        "unit": "feature-grid pixels",
    }
    return {"overall": overall, "layers": layers}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DCN offset and gate statistics of a model")
    p.add_argument("--ckpt", default="",
                   help="checkpoint (train.py checkpoint dir, e.g. .../best, or a reference .pth)")
    p.add_argument("--arch", default="dlav1_34")
    p.add_argument("--input_res", type=int, default=256)
    p.add_argument("--data_dir", required=True, help="frames to probe on")
    p.add_argument("--n_frames", type=int, default=8)
    p.add_argument("--out", default="", help="write the stats json here")
    p.add_argument("--init", action="store_true",
                   help="probe the freshly built model instead of the checkpoint "
                        "(sanity: offsets must be exactly 0)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    if not args.init and not args.ckpt:
        p.error("--ckpt is required unless --init")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    from centerpose_tpu_torch.models.factory import create_model
    from centerpose_tpu_torch.utils.checkpoint import load_for_inference

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass --device cpu to probe on the CPU)")
    cfg = preset(
        "centerpose" if args.arch.startswith("dlav1") else "centerpose_dla",
        category="shoe", arch=args.arch, input_h=args.input_res, input_w=args.input_res,
    )
    model = create_model(cfg, device, generator=torch.Generator().manual_seed(0))
    if not args.init:
        load_for_inference(args.ckpt, model)
    report = probe(model, load_frames(args.data_dir, args.n_frames, args.input_res))
    report["overall"]["weights"] = "random-init" if args.init else args.ckpt
    print(json.dumps(report["overall"], indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
