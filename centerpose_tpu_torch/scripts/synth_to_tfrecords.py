"""Convert a DOPE-format png+json dataset into per-video Objectron TFRecords,
the twin of the JAX package's `scripts/synth_to_tfrecords.py` (its options,
the same bytes).

    python -m centerpose_tpu_torch.scripts.synth_to_tfrecords --data_dir data/synth_val \\
        --out_dir data/synth_val_records --c shoe

One `<out_dir>/<video>.tfrecord` per video directory, frames in order, with
the tf.Example layout the evaluator's reader takes (`data/tfrecord.py`
`KEYS`, the Objectron schema keys): `point_2d` as [x / width, y / height, 1]
per keypoint, points, poses and plane in the OpenGL camera frame,
`camera/intrinsics` stored transposed as Objectron's are (the reader swaps
fx/fy and cx/cy back). The packing is `data/tfrecord.py::pack_dope_video`;
each frame is named `<category>/<video>/<index>`. The records feed
`python -m centerpose_tpu_torch.evaluate --tfrecords` (video tracking,
`--n_proc`, `--eval_continue`) and `scripts/preprocess_tfrecords.py`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

from centerpose_tpu_torch.data.tfrecord import pack_dope_dataset, pack_dope_video, read_tfrecord


def convert_video(vdir: str, out_path: str, category: str) -> int:
    """One video directory into `out_path`; returns its number of frames."""
    return pack_dope_video(vdir, out_path, category)


def main(argv=None) -> Dict[str, int]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True, help="DOPE dataset root")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--c", dest="category", default="shoe")
    args = p.parse_args(argv)

    frames = {}
    for out in pack_dope_dataset(args.data_dir, args.out_dir, args.category):
        frames[out] = sum(1 for _ in read_tfrecord(out))
        print(f"{os.path.splitext(os.path.basename(out))[0]}: {frames[out]} frames -> {out}")
    print(f"total {sum(frames.values())} frames")
    return frames


if __name__ == "__main__":
    main()
