"""Batch evaluation, sweeping categories x evaluation modes: the twin
of the JAX package's `scripts/batch_eval.py`.

    python -m centerpose_tpu_torch.scripts.batch_eval --data_root DATA --modes 0 2 --max_images 8

Parity target: the reference's shell scripts (src/tools/objectron_eval/
shell_eval_image_CenterPose.py, shell_eval_video_CenterPose.py,
shell_eval_video_CenterPoseTrack.py:8-87): one evaluation per category and
mode, as a subprocess; symmetric categories get `--eval_num_symmetry 100`.
Each run is `python -m centerpose_tpu_torch.evaluate --mode metric ...` with
the repo root as its working directory (the JAX script runs `evaluate.py`
from the caller's directory); `--data_root`, `--model_root` and
`--report_dir` are taken relative to the caller's directory and passed on
as absolute paths. The flags and the command lines are the JAX script's.

The 9 reference modes (shell_eval_video_CenterPoseTrack.py:24-52), kept as
the JAX script has them:
  0 dlav1_34 image model (baseline)
  1 dlav1_34 + refined Kalman + GT first-frame seed
  2 dla_34 tracking: Kalman + scale pool + previous heatmaps
  3 mode 2 + GT first-frame seed
  4 mode 3 + noise on the seeded GT keypoints
  5 mode 3 with CenterPose-initialization seeding (an image model's
    detections seed the tracker instead of GT)
  6 tracking + GT seed WITHOUT Kalman/scale pool
  7 tracking + GT seed WITHOUT previous heatmaps
  8 mode 3 with emptied previous heatmaps (tracking null test)
Modes 7 and 8 have identical flags (`--eval_gt_pre_hm_first
--eval_empty_pre_hm`): the reference's two presets differ in what they
mean, not in what this evaluator does with them.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVALUATE = ["-m", "centerpose_tpu_torch.evaluate"]

CATEGORIES = (
    "bike", "book", "bottle", "camera", "cereal_box", "chair", "cup", "laptop",
    "shoe",
)
SYMMETRIC = ("bottle", "cup")

_TRACK = ["--tracking", "--arch", "dla_34"]
MODES = {
    0: ["--arch", "dlav1_34"],
    1: ["--arch", "dlav1_34", "--refined_kalman", "--eval_gt_pre_hm_first"],
    2: _TRACK,
    3: _TRACK + ["--eval_gt_pre_hm_first"],
    4: _TRACK + ["--eval_gt_pre_hm_first", "--eval_add_noise"],
    5: _TRACK + ["--eval_gt_pre_hm_first", "--eval_CenterPose_initialization"],
    6: _TRACK + ["--eval_gt_pre_hm_first", "--no_kalman", "--no_scale_pool"],
    7: _TRACK + ["--eval_gt_pre_hm_first", "--eval_empty_pre_hm"],
    8: _TRACK + ["--eval_gt_pre_hm_first", "--eval_empty_pre_hm"],
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="evaluate categories x modes")
    p.add_argument("--data_root", required=True, help="root containing <category>/ dirs")
    p.add_argument("--model_root", default="", help="root containing <category> checkpoints")
    p.add_argument("--categories", nargs="*", default=list(CATEGORIES))
    p.add_argument("--modes", nargs="*", type=int, default=[0])
    p.add_argument("--tracking", action="store_true")
    p.add_argument("--report_dir", default="reports")
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--eval_continue", action="store_true",
                   help="skip category/mode combos whose report file already exists "
                        "(--eval_continue parity, eval_video_official.py:1599-1602)")
    args = p.parse_args(argv)
    data_root = os.path.abspath(args.data_root)
    model_root = os.path.abspath(args.model_root) if args.model_root else ""
    report_dir = os.path.abspath(args.report_dir)

    os.makedirs(report_dir, exist_ok=True)
    for cat in args.categories:
        for mode in args.modes:
            report = os.path.join(report_dir, f"{cat}_mode{mode}.txt")
            if args.eval_continue and os.path.exists(report):
                print("SKIP (exists)", report)
                continue
            cmd = [
                sys.executable, *EVALUATE,
                "--mode", "metric",
                "--data_dir", os.path.join(data_root, cat),
                "--c", cat,
                "--report_file", report,
            ]
            if model_root:
                cmd += ["--load_model", os.path.join(model_root, cat)]
            if args.tracking:
                cmd += ["--tracking"]
            if cat in SYMMETRIC:
                cmd += ["--eval_num_symmetry", "100"]
            if args.max_images:
                cmd += ["--max_images", str(args.max_images)]
            cmd += MODES.get(mode, [])
            print("RUN", " ".join(cmd))
            subprocess.run(cmd, check=False, cwd=REPO)


if __name__ == "__main__":
    main()
