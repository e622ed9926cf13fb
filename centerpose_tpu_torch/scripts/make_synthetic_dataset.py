"""Generate a synthetic DOPE-format dataset with exact ground truth, the twin
of the JAX package's `scripts/make_synthetic_dataset.py` (its options and
defaults, the same files from the same seed).

    python -m centerpose_tpu_torch.scripts.make_synthetic_dataset --out data/synth_train \\
        --n_videos 24 --frames 16 --seed 0
    python -m centerpose_tpu_torch.scripts.make_synthetic_dataset --out data/synth_val \\
        --n_videos 6 --frames 8 --seed 777

The png+json tree is what `python -m centerpose_tpu_torch.train --data_dir`
and `python -m centerpose_tpu_torch.evaluate --mode metric --data_dir`
read, closing the accuracy loop (train -> checkpoint -> detector ->
Objectron-style AP) without the real Objectron dataset. See
`data/synthetic.py` for the conventions.
"""

from __future__ import annotations

import argparse
from typing import List

from centerpose_tpu_torch.data.synthetic import generate_dataset


def main(argv=None) -> List[str]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--n_videos", type=int, default=10)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=480)
    p.add_argument(
        "--video_motion", action="store_true",
        help="fixed scene per video with a smoothly orbiting camera "
             "(tracking/consistency eval); default: independent frames",
    )
    args = p.parse_args(argv)

    paths = generate_dataset(
        args.out, n_videos=args.n_videos, frames_per_video=args.frames,
        seed=args.seed, width=args.width, height=args.height,
        video_motion=args.video_motion,
    )
    print(f"wrote {len(paths)} frames under {args.out}")
    return paths


if __name__ == "__main__":
    main()
