"""CenterPoseTrack ablation: Kalman filter / scale pool on against off on a
noisy video, the twin of the JAX package's `scripts/track_ablation.py`.

    python -m centerpose_tpu_torch.scripts.track_ablation --tfrecords 'DATA/*.tfrecord' --max_images 16

Runs the evaluate CLI (`python -m centerpose_tpu_torch.evaluate`, with the
repo root as its working directory) over per-video TFRecords three times:
the full pipeline, `--no_kalman` and `--no_scale_pool`, each with the
GT-seeded noisy first frame (`--eval_gt_pre_hm_first --eval_add_noise`),
and records the consistency score and the AP families of each (the
reference's ablation presets: shell_eval_video_CenterPoseTrack.py:24-52).
A working tracker scores full >= no_kalman / no_scale_pool on consistency.
`--baseline` ablates the CenterPose + Kalman baseline
(`tracking/tracker_baseline.py`) of an image model of `--arch` instead:
`--refined_kalman` against raw detections under the same video evaluation.

Paths (`--tfrecords`, `--load_model`, `--work_dir`, `--out`) are taken
relative to the caller's directory. The artifact goes to `--out`, by default
`exp/track_ablation/TRACK_ABLATION.json` (the JAX script writes it at its
repo's root).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVALUATE = ["-m", "centerpose_tpu_torch.evaluate"]


def run_eval(args, extra, report_json):
    cmd = [
        sys.executable, *EVALUATE, "--mode", "metric",
        "--tfrecords", args.tfrecords, "--c", "shoe",
        "--input_res", str(args.input_res),
        "--report_json", report_json,
        "--compute_dtype", args.compute_dtype,
    ]
    if args.baseline:
        cmd += ["--arch", args.arch]
    else:
        cmd += ["--tracking", "--eval_gt_pre_hm_first", "--eval_add_noise"]
    cmd += extra
    if args.load_model:
        cmd += ["--load_model", args.load_model]
    if args.max_images:
        cmd += ["--max_images", str(args.max_images)]
    print("+ " + " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)
    with open(report_json) as f:
        return json.load(f)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Kalman / scale-pool ablation of the tracker")
    p.add_argument("--tfrecords", required=True, help="glob of video tfrecords")
    p.add_argument("--load_model", default="")
    p.add_argument("--input_res", type=int, default=256)
    p.add_argument("--compute_dtype", default="float32")
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--work_dir", default="exp/track_ablation")
    p.add_argument("--out", default="exp/track_ablation/TRACK_ABLATION.json")
    p.add_argument("--baseline", action="store_true",
                   help="ablate the CenterPose+KF baseline (tracker_baseline) instead of the "
                        "Track pipeline: usable with a trained image-model checkpoint of any --arch")
    p.add_argument("--arch", default="res_18", help="image arch for --baseline mode")
    args = p.parse_args(argv)
    args.tfrecords = os.path.abspath(args.tfrecords)
    args.load_model = os.path.abspath(args.load_model) if args.load_model else ""
    work_dir = os.path.abspath(args.work_dir)
    out = os.path.abspath(args.out)

    os.makedirs(work_dir, exist_ok=True)
    if args.baseline:
        configs = {
            "full": ["--refined_kalman"],
            # Raw detections under the same video-eval semantics (per-video
            # reset + consistency).
            "no_kalman": ["--video_eval"],
        }
    else:
        configs = {
            "full": [],
            "no_kalman": ["--no_kalman"],
            "no_scale_pool": ["--no_scale_pool"],
        }
    results = {}
    for name, extra in configs.items():
        rep = run_eval(args, extra, os.path.join(work_dir, f"{name}.json"))
        results[name] = {
            "consistency": rep.get("consistency"),
            "ap": {k: round(v["ap"], 4) for k, v in rep["families"].items()},
            "num_pred": rep["num_pred"],
            "num_gt": rep["num_gt"],
        }
        print(json.dumps({name: results[name]}))

    full_c = results["full"]["consistency"] or 0.0
    artifact = {
        "metric": ("kf_baseline_consistency_vs_raw" if args.baseline
                   else "track_consistency_full_vs_ablations"),
        "value": round(full_c, 4),
        "unit": "mean pairwise 3D IoU (window 10)",
        "delta_no_kalman": round(full_c - (results["no_kalman"]["consistency"] or 0.0), 4),
        "configs": results,
        "protocol": {
            "load_model": args.load_model or "random",
            "input_res": args.input_res,
            "pipeline": (f"CenterPose({args.arch}) + tracker_baseline KF vs raw" if args.baseline
                         else "CenterPoseTrack; GT first frame + gaussian noise "
                              "(--eval_gt_pre_hm_first --eval_add_noise)"),
        },
    }
    if not args.baseline:
        artifact["delta_no_scale_pool"] = round(
            full_c - (results["no_scale_pool"]["consistency"] or 0.0), 4)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {out}")
    return artifact


if __name__ == "__main__":
    main()
