"""Poses of one trained checkpoint through both packages' detectors, on the CPU.

    JAX_PLATFORMS=cpu python tests/pose_check.py --ckpt best.pth --arch res_18 --input_res 256 \
        --data_dir HELD_OUT [--n_frames 48] [--out poses.json]

On random weights the PnP problems are ill-posed, so the tests compare poses
only on planted problems; a trained model gives well-posed ones. This helper
loads a reference-names checkpoint (`{step, state_dict}`, float16 or float32
tensors, e.g. a `train.py` checkpoint's `state_dict` of this repo's
accuracy loop) into `centerpose_tpu_torch`'s `Detector` and, through
`centerpose_tpu.models.convert.convert_state_dict`, into the JAX package's,
both in float32 at the evaluate CLI's preset, runs both on the first
`--n_frames` frames under `--data_dir` (sorted), pairs each of the port's
detections with the JAX detection of the nearest box and reports the
largest and median differences of score, box and keypoints (pixels) and,
over the pairs with a pose in both, of location (the detector's units)
and rotation (degrees), listing the pairs whose poses differ by more than
1e-3 in location or 0.1 degree. It is not a test: it needs trained
weights, which the repository does not hold.
"""

import argparse
import json
import os

import numpy as np


def _frames(root, n):
    from PIL import Image

    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs if f.endswith(".png"))
    return [(p, np.asarray(Image.open(p).convert("RGB"))) for p in paths[:n]]


def _angle_deg(q1, q2):
    q1, q2 = np.asarray(q1, np.float64), np.asarray(q2, np.float64)
    dot = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return float(np.degrees(2 * np.arccos(min(1.0, dot))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--arch", default="res_18")
    p.add_argument("--input_res", type=int, default=256)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--n_frames", type=int, default=48)
    p.add_argument("--vis_thresh", type=float, default=0.3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from centerpose_tpu.config import preset as jax_preset
    from centerpose_tpu.inference.detector import Detector as JaxDetector
    from centerpose_tpu.models import create_model as jax_create_model
    from centerpose_tpu.models.convert import convert_state_dict
    from centerpose_tpu_torch.config import preset
    from centerpose_tpu_torch.inference.detector import Detector

    name = "centerpose" if args.arch.startswith("dlav1") else "centerpose_dla"
    kw = dict(arch=args.arch, input_h=args.input_res, input_w=args.input_res, vis_thresh=args.vis_thresh)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    sd = {k: v.float() if v.is_floating_point() else v for k, v in ckpt["state_dict"].items()}

    port = Detector(preset(name, **kw), state_dict=sd, device="cpu")
    jcfg = jax_preset(name, dcn_impl="gather", **kw)
    model = jax_create_model(jcfg)
    z = jnp.zeros((1, args.input_res, args.input_res, 3), jnp.float32)
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), z)))
    variables = convert_state_dict({k: v.numpy() for k, v in sd.items()}, like,
                                   use_gn=jcfg.use_conv_gru, strict=True)
    ref = JaxDetector(jcfg, variables=variables)

    diffs = {k: [] for k in ("score", "bbox_px", "kps_px", "location", "rotation_deg")}
    counts = {"frames": 0, "port_detections": 0, "jax_detections": 0, "pairs_with_pose": 0}
    for _, img in _frames(args.data_dir, args.n_frames):
        out, exp = port.run(img), ref.run(img)
        counts["frames"] += 1
        counts["port_detections"] += len(out["results"])
        counts["jax_detections"] += len(exp["results"])
        pool = list(exp["results"])
        for o in out["results"]:
            if not pool:
                break
            # the JAX detection with the nearest box (equal scores may come in either order)
            r = pool.pop(int(np.argmin([np.abs(np.subtract(o["bbox"], c["bbox"])).max() for c in pool])))
            diffs["score"].append(abs(o["score"] - r["score"]))
            diffs["bbox_px"].append(float(np.abs(np.subtract(o["bbox"], r["bbox"])).max()))
            diffs["kps_px"].append(float(np.abs(np.subtract(o["kps"], r["kps"])).max()))
            if "location" in o and "location" in r:
                counts["pairs_with_pose"] += 1
                diffs["location"].append(float(np.linalg.norm(np.subtract(o["location"], r["location"]))))
                diffs["rotation_deg"].append(_angle_deg(o["quaternion_xyzw"], r["quaternion_xyzw"]))
    off = [i for i, (dt, dr) in enumerate(zip(diffs["location"], diffs["rotation_deg"]))
           if dt > 1e-3 or dr > 0.1]
    report = {"ckpt": args.ckpt, "arch": args.arch, "input_res": args.input_res, **counts,
              "max": {k: max(v) if v else None for k, v in diffs.items()},
              "median": {k: float(np.median(v)) if v else None for k, v in diffs.items()},
              "poses_off_1e-3_or_0.1deg": [{k: diffs[k][i] for k in ("location", "rotation_deg")}
                                           for i in off]}
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
