"""Demo entry point of the PyTorch package: pose of every object in an image, a
folder of images, a video or a directory of video frames, with the
CenterPoseTrack tracker for videos.

    python -m centerpose_tpu_torch.demo --demo FRAMES_DIR --tracking --c shoe

Counterpart of the JAX package's `demo.py` (parity target: src/demo.py —
image/folder modes, per-stage times tot/pre/net/dec/post/merge/pnp/track,
demo.py:19,54-57). It writes one `<name>.json` per image or frame into
`--out_dir` (detections with score, pose, scale, keypoints and box, the
track id when tracking, and the stage times) and prints the stage times;
`--save_json` is accepted, as the JAX CLI's (default on), and changes
nothing. `--debug 1` also writes `<name>.png`, the detections drawn over the
image (`utils/visualize.py::draw_detections`); `--debug 2` adds the
reference's debug canvases (`Detector.render_debug`) as
`<out_dir>/debug/<name>_<canvas>.png` (out_hm_pred, out_hmhp_pred,
out_kps_processed_pred, out_img_pred; for tracking also out_tracking_pred,
pre_hm, pre_hmhp). `--demo webcam` (or a `/dev/videoN` path) reads frames
from a V4L2 camera (`data/webcam.py`).

Runs on the GPU (`--device cuda`, the default) unless asked for the CPU.
`--arch` takes every architecture of the factory (dla_34, dlav1_34,
dlav0_34, res_XX, resdcn_XX, hourglass). `--load_model` takes a reference
`.pth` checkpoint (`{epoch, state_dict}` or a bare state dict of the
reference's names, `module.` prefixes and a dlav0 trunk's `fc` allowed) or a
checkpoint directory of this package's `train.py` (`ckpt/`, `best/`,
`epoch_N/` or one `<step>/` under them): `utils/checkpoint.py::
load_for_inference`. The JAX package's orbax checkpoints belong to that
package. Every arch is built
at the preset's head_conv of 256, so a reference res/resdcn checkpoint, whose
heads are 64 wide, does not load.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="centerpose_tpu_torch demo")
    p.add_argument("--demo", required=True,
                   help="image, folder of images, video file, frame folder (with --tracking), "
                        "or webcam / /dev/videoN")
    p.add_argument("--arch", default="dlav1_34")
    p.add_argument("--c", dest="category", default="shoe")
    p.add_argument("--load_model", default="",
                   help="reference .pth checkpoint or state dict, or a train.py checkpoint directory")
    p.add_argument("--tracking", action="store_true",
                   help="CenterPoseTrack: dla_34 tracking model + tracker over the frames in order")
    p.add_argument("--vis_thresh", type=float, default=0.3)
    p.add_argument("--rep_mode", type=int, default=1)
    p.add_argument("--cam_intrinsic", type=float, nargs=9, default=None)
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--save_json", action="store_true", default=True,
                   help="accepted as the JAX CLI's: the JSON is always written")
    p.add_argument("--debug", type=int, default=0,
                   help="1: draw the detections into <name>.png; 2: also the debug canvases "
                        "under <out_dir>/debug/")
    p.add_argument("--batch_size", type=int, default=1,
                   help="folder mode: batch the network pass over N images")
    p.add_argument("--keep_res", action="store_true",
                   help="keep input resolution, pad to the arch's alignment (opts.py --keep_res)")
    p.add_argument("--fix_short", type=int, default=-1,
                   help="resize the short side to this, round the long side up to x64 "
                        "(opts.py --fix_short)")
    p.add_argument("--input_res", type=int, default=512)
    p.add_argument("--dcn_impl", default="gather", choices=("gather", "onehot", "onehot_exact"),
                   help="accepted and ignored: this package has one DCN kernel, which computes "
                        "what every sampler of the JAX package computes")
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def load_detector(args):
    from centerpose_tpu_torch.config import preset
    from centerpose_tpu_torch.inference.detector import Detector

    name = "centerpose_track" if args.tracking else (
        "centerpose" if args.arch.startswith("dlav1") else "centerpose_dla"
    )
    cfg = preset(
        name,
        arch=args.arch if not args.tracking else "dla_34",
        category=args.category,
        vis_thresh=args.vis_thresh,
        rep_mode=args.rep_mode,
        fix_res=not args.keep_res,
        fix_short=args.fix_short,
        input_h=args.input_res,
        input_w=args.input_res,
        compute_dtype=args.compute_dtype,
    )
    return Detector(cfg, device=args.device, load_model=args.load_model)


def _frames(args):
    """Yield (name, image). Video files and (with --tracking) frame folders
    stream in order; otherwise each image is independent."""
    from PIL import Image

    if args.demo == "webcam" or args.demo.startswith("/dev/video"):
        # Live capture (reference demo.py:31-57, cv2.VideoCapture(0)).
        from centerpose_tpu_torch.data.webcam import V4L2Camera

        device = "/dev/video0" if args.demo == "webcam" else args.demo
        with V4L2Camera(device) as cam:
            for i, frame in enumerate(cam):
                yield f"cam_{i:05d}", frame
        return
    is_video = args.demo.lower().endswith((".mp4", ".mov", ".webm", ".avi", ".y4m"))
    if is_video or (args.tracking and os.path.isdir(args.demo)):
        from centerpose_tpu_torch.data.video import open_video

        for i, frame in enumerate(open_video(args.demo)):
            yield f"frame_{i:05d}", frame
        return
    if os.path.isdir(args.demo):
        exts = ("*.png", "*.jpg", "*.jpeg")
        files = sorted(sum([glob.glob(os.path.join(args.demo, e)) for e in exts], []))
    else:
        files = [args.demo]
    for path in files:
        yield os.path.basename(path), np.asarray(Image.open(path).convert("RGB"))


def _record(name, out):
    def listed(v):
        return None if v is None else np.asarray(v, np.float64).tolist()

    detections = []
    for d in out["results"]:
        rec = {
            "score": float(d["score"]),
            "location": listed(d.get("location")),
            "quaternion_xyzw": listed(d.get("quaternion_xyzw")),
            "obj_scale": listed(d["obj_scale"]),
            "kps": listed(d["kps"]),
            "bbox": listed(d["bbox"]),
        }
        if "tracking_id" in d:
            rec["tracking_id"] = int(d["tracking_id"])
        detections.append(rec)
    return {"image": name, "detections": detections, "times": out.get("times")}


def main(argv=None) -> int:
    args = parse_args(argv)
    detector = load_detector(args)
    detector.debug_level = args.debug
    os.makedirs(args.out_dir, exist_ok=True)

    meta = {}
    if args.cam_intrinsic is not None:
        meta["camera_matrix"] = np.array(args.cam_intrinsic).reshape(3, 3)

    def emit(name, img, out):
        times = out.get("times")
        if times:
            print(f"{name}: " + "|".join(f"{k} {v:.3f}s" for k, v in times.items()), flush=True)
        base = os.path.splitext(os.path.basename(name))[0]
        with open(os.path.join(args.out_dir, base + ".json"), "w") as f:
            json.dump(_record(name, out), f, indent=1)
        if args.debug > 0:
            from PIL import Image

            from centerpose_tpu_torch.utils.visualize import draw_detections

            vis = draw_detections(img, out["results"], out["boxes"])
            Image.fromarray(vis).save(os.path.join(args.out_dir, base + ".png"))
        if args.debug >= 2:
            # The reference's canvas set (object_pose.py:199-313 debug levels).
            dbg = detector.render_debug(img, out)
            dbg.save_all_imgs(os.path.join(args.out_dir, "debug"), prefix=base + "_")

    if args.batch_size > 1 and not args.tracking:
        # Pipelined batched serving: chunk N's host post/merge/PnP overlaps
        # chunk N+1's device work (Detector.run_batch_stream).
        pending = []

        def feed():
            buf = []
            for item in _frames(args):
                buf.append(item)
                if len(buf) == args.batch_size:
                    pending.append(buf)
                    yield [im for _, im in buf], [meta or None] * len(buf)
                    buf = []
            if buf:
                pending.append(buf)
                yield [im for _, im in buf], [meta or None] * len(buf)

        for outs in detector.run_batch_stream(feed(), timing=True):
            for (name, img), out in zip(pending.pop(0), outs):
                emit(name, img, out)
        return 0

    for name, img in _frames(args):
        emit(name, img, detector.run(img, meta or None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
