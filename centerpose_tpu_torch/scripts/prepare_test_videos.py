"""Re-sort shuffled Objectron TFRecords into per-video record files, the twin
of the JAX package's `scripts/prepare_test_videos.py` (its options, the same
bytes).

    python -m centerpose_tpu_torch.scripts.prepare_test_videos \\
        --records 'records_shuffled/shoe/shoe_test*' --out_dir data/shoe_videos

Parity target: src/tools/objectron_eval/prepare_test_video.py. The video
evaluator (`python -m centerpose_tpu_torch.evaluate --tfrecords --tracking`)
needs each video's frames in one file, in temporal order; the public
records_shuffled shards interleave videos. A frame's video is the first
three `/`-parts of its `image/filename` (`<category>/batch-N/M/...`) joined
by `_`, which names its `<out_dir>/<video>.tfrecord`; frames sort by
`image/id`; `--max_videos N` keeps the first N videos by name (0: all).
A record without a filename goes to `unknown`. The payloads are copied as
they are.

The records `scripts/synth_to_tfrecords.py` writes name a frame
`<category>/<video>/<index>`: three parts, so re-sorted here each frame is
a video of its own, as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict

from centerpose_tpu_torch.data.tfrecord import (
    parse_objectron_example,
    read_tfrecord,
    record_paths,
    write_tfrecord,
)


def main(argv=None) -> Dict[str, int]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--records", required=True, help="shuffled tfrecord file or glob")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_videos", type=int, default=0)
    args = p.parse_args(argv)

    by_video = defaultdict(list)  # video id -> [(frame id, payload)]
    for path in record_paths(args.records):
        for payload in read_tfrecord(path):
            ex = parse_objectron_example(payload)
            name = ex.get("filename", "")
            video = "_".join(name.split("/")[:3]) if name else "unknown"
            by_video[video].append((ex.get("image_id", 0), payload))

    os.makedirs(args.out_dir, exist_ok=True)
    videos = sorted(by_video)
    if args.max_videos:
        videos = videos[: args.max_videos]
    written = {}
    for video in videos:
        frames = sorted(by_video[video], key=lambda t: t[0])
        out = os.path.join(args.out_dir, f"{video}.tfrecord")
        write_tfrecord(out, [payload for _, payload in frames])
        written[out] = len(frames)
        print(f"{out}: {len(frames)} frames")
    return written


if __name__ == "__main__":
    main()
