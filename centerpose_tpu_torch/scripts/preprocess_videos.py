"""Objectron video + annotation `.pbdata` to DOPE-style png+json pairs, the
twin of the JAX package's `scripts/preprocess_videos.py` (its options, the
same PNG bytes and JSON).

    python -m centerpose_tpu_torch.scripts.preprocess_videos --video video.MOV \\
        --annotation geometry.pbdata --out_dir data/shoe/batch-1_0 --frame_rate 15

Parity target: the reference's data/preprocess.py (ffmpeg rawvideo frame
extraction at a chosen frame rate, x1/resolution_ratio downsize, one
DOPE/NDDS json per frame through data/utils.py export_to_ndds_file). The
`Sequence` protobuf is decoded by the package's dependency-free parser
(`data/objectron_pb.py`); the frames come from `data/video.py::open_video`:
a Motion-JPEG AVI or a Y4M stream in pure Python, a directory of frames,
anything else through ffmpeg (which must then be installed). Frame i is
paired with the annotation's frame i, and the video stops at the last
annotated frame. Writes `<out_dir>/<i:05d>.{png,json}`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from centerpose_tpu_torch.data.objectron_pb import frame_to_ndds_dict, parse_sequence
from centerpose_tpu_torch.data.video import open_video


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--video", required=True,
                   help="video file (needs ffmpeg) or directory of frames")
    p.add_argument("--annotation", required=True, help="Sequence .pbdata file")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--frame_rate", type=int, default=15,
                   help="15 for CenterPose, 1 for Track (data/README.md:19)")
    p.add_argument("--resolution_ratio", type=float, default=2.4)
    args = p.parse_args(argv)

    from PIL import Image

    with open(args.annotation, "rb") as f:
        seq = parse_sequence(f.read())
    n_frames = len(seq["frame_annotations"])
    print(f"annotation: {n_frames} frames, {len(seq['objects'])} objects")

    os.makedirs(args.out_dir, exist_ok=True)
    reader = open_video(args.video, fps=args.frame_rate)

    written = 0
    for idx, frame in enumerate(reader):
        if idx >= n_frames:
            break
        record = frame_to_ndds_dict(seq, idx, args.resolution_ratio)
        w = record["camera_data"]["width"]
        h = record["camera_data"]["height"]
        img = Image.fromarray(np.asarray(frame, np.uint8)).resize((w, h))
        img.save(os.path.join(args.out_dir, f"{idx:05d}.png"))
        with open(os.path.join(args.out_dir, f"{idx:05d}.json"), "w") as f:
            json.dump(record, f)
        written += 1
    print(f"wrote {written} frame pairs to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
