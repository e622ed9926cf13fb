"""Objectron TFRecords to DOPE-style png+json training pairs, the twin of the
JAX package's `scripts/preprocess_tfrecords.py` (its options, the same PNG
bytes and JSON).

    python -m centerpose_tpu_torch.scripts.preprocess_tfrecords --records 'records/*.tfrecord' \\
        --out_dir data/objectron --category shoe

Writes `<out_dir>/<category>/<record name>/<image id:05d>.{png,json}`, what
`python -m centerpose_tpu_torch.train --data_dir <out_dir>` reads. Parity
target: the reference's offline pipeline (data/preprocess.py + data/utils.py
export_to_ndds_file), which decodes the raw Objectron videos and Sequence
protobufs (`scripts/preprocess_videos.py` here); this one reads the public
records_shuffled or per-video TFRecords (`scripts/prepare_test_videos.py`)
through the package's reader (`data/tfrecord.py`), which carry the same
annotations. The records are not in the repository: downloading them needs
the network, so point `--records` at fetched files.

Conventions: the transposed intrinsics are swapped back; `projected_cuboid`
is [x * width, y * height] truncated to int; the quaternion (x, y, z, w) is
`scipy`'s of the stored rotation matrix; frames with no instance are
skipped; `--max_frames N` stops after N written frames (0: all).
"""

from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np

from centerpose_tpu_torch.data.tfrecord import parse_objectron_example, read_tfrecord, record_paths


def frame_record(ex: dict, category: str, w: int, h: int) -> dict:
    """The DOPE json of one parsed Objectron example of a w x h image."""
    from scipy.spatial.transform import Rotation

    objects = []
    for i in range(ex["num_instances"]):
        kps2d = np.asarray(ex["points_2d"][i])[:9].copy()
        kps2d[:, 0] *= w
        kps2d[:, 1] *= h
        objects.append({
            "name": f"{category}_{i}",
            "location": np.asarray(ex["translations"][i]).tolist(),
            "quaternion_xyzw": Rotation.from_matrix(ex["rotations"][i]).as_quat().tolist(),
            "projected_cuboid": kps2d.astype(int).tolist(),
            "scale": np.asarray(ex["scales"][i]).tolist(),
            "keypoints_3d": np.asarray(ex["points_3d"][i])[:9].tolist(),
        })
    cam = {}
    if "intrinsics" in ex:
        k = np.asarray(ex["intrinsics"])
        # Objectron stores intrinsics transposed relative to image x/y
        # (data/utils.py:115-121).
        cam["intrinsics"] = {"fx": float(k[1, 1]), "fy": float(k[0, 0]),
                             "cx": float(k[1, 2]), "cy": float(k[0, 2])}
    if "projection" in ex:
        cam["camera_projection_matrix"] = np.asarray(ex["projection"]).tolist()
    if "view" in ex:
        cam["camera_view_matrix"] = np.asarray(ex["view"]).tolist()
    record = {"camera_data": {"width": w, "height": h, **cam}, "objects": objects}
    if "plane" in ex:
        record["AR_data"] = {"plane_center": np.asarray(ex["plane"][0]).tolist(),
                             "plane_normal": np.asarray(ex["plane"][1]).tolist()}
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--records", required=True, help="tfrecord file or glob")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--category", default="shoe")
    p.add_argument("--max_frames", type=int, default=0)
    args = p.parse_args(argv)

    from PIL import Image

    count = 0
    for rpath in record_paths(args.records):
        vid = os.path.splitext(os.path.basename(rpath))[0]
        out_dir = os.path.join(args.out_dir, args.category, vid)
        os.makedirs(out_dir, exist_ok=True)
        for payload in read_tfrecord(rpath):
            if args.max_frames and count >= args.max_frames:
                print(f"wrote {count} frames")
                return count
            ex = parse_objectron_example(payload)
            if "image_bytes" not in ex or ex.get("num_instances", 0) == 0:
                continue
            img = Image.open(io.BytesIO(ex["image_bytes"])).convert("RGB")
            record = frame_record(ex, args.category, *img.size)
            frame_id = ex.get("image_id", count)
            img.save(os.path.join(out_dir, f"{frame_id:05d}.png"))
            with open(os.path.join(out_dir, f"{frame_id:05d}.json"), "w") as f:
                json.dump(record, f)
            count += 1
    print(f"wrote {count} frames")
    return count


if __name__ == "__main__":
    main()
