"""Live tracking: `Detector.run` of the CenterPoseTrack model frame after
frame over one video, closed loop (the next frame goes in when the last
one's tracker step has returned), at batch 1.

Traffic parameters (`posebench/traffic/<name>.json`): `frames` distinct
frames of `frame_hw` made at set-up (`posebench/video.py`: two objects
moving at most `max_step_px` a frame), played forward then backward; `warmup_frames` (the first on the host warp,
the rest on the device warp with the previous-frame render); the detector's
`K` and `vis_thresh` (under every disc's peak); `box_px` (the box width
of `track_weights.py`, output pixels: wide enough that association's area
gate holds as a disc moves, while the two discs' boxes never overlap);
`tracks_per_frame`, the tracks that these give, which every frame after
the first matches, starting none (a window frame that matches or starts
other counts is off the load: `off_load_frames`, limited to 0);
`check_frames` (frames spread over the window whose starting state is kept
and stepped by the reference after the window); `profile_frames` (the
traced segment), `limits` per configuration and `limit_reasons`.

End-to-end: `serve_images_per_s` (frames whose tracked poses came out in
the window, over the window), `setup_s`. Counters: the work of one frame's
network counted from shapes, the frames of the traced segment. What is
kept at a checked frame (inside the window): a copy of the tracker's
tracks (Kalman states, scale pools) and id count, the frame's place in the
video (the reference warps the frame before it itself), and a copy of the
frame's output. Counted at every window frame (inside the window): the
tracks it matched and started, against the traffic's load.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from posebench import flops_track, track_checks, track_weights, video
from posebench.checks import judge
from posebench.harness import Cell, Result, exact_float32
from posebench.reference import track as reftrack
from posebench.reference import track_net
from posebench.trace import profile, span


def detector_config(cell: Cell):
    from centerpose_tpu_torch.config import preset

    c, t = cell.config, cell.traffic
    tr = c["tracker"]
    return preset(c["preset"], category=c["category"], input_h=c["input_h"], input_w=c["input_w"],
                  compute_dtype=c["serve_dtype"], vis_thresh=t["vis_thresh"], K=t["K"],
                  new_thresh=tr["new_thresh"], max_age=tr["max_age"], use_kalman=tr["use_kalman"],
                  use_scale_pool=tr["use_scale_pool"], use_hungarian=tr["use_hungarian"],
                  kf_r_velocity=tr["kf_r_velocity"], conf_border=tuple(tr["conf_border"]),
                  max_tracks=tr["max_tracks"], hm_hp_thresh=c["hm_hp_thresh"],
                  balance_coefficient=c["balance_coefficient"])


def reference_params(cell: Cell) -> dict:
    c, t = cell.config, cell.traffic
    return {"input": c["input_w"], "down_ratio": c["down_ratio"], "K": t["K"], "vis_thresh": t["vis_thresh"],
            "hm_hp_thresh": c["hm_hp_thresh"], "balance_coefficient": c["balance_coefficient"],
            **{k: v for k, v in c["tracker"].items()}}


def cell_state(cell: Cell, device):
    """The cell's weights from its seed (float32)."""
    c, t = cell.config, cell.traffic
    return track_weights.make_state(track_net.spec_of(c), cell.seed, device, t["frame_hw"][1],
                                    c["input_w"] // c["down_ratio"], t["box_px"])


def plant(det, fault):
    """Tests and readings only: break the timed path underneath the run."""
    tracker = det.tracker
    if fault == "drop_track":                     # the last track of each step lost
        real_step = tracker.step

        def step(dets, boxes, meta=None):
            ret, new_boxes = real_step(dets, boxes, meta)
            if ret:
                lost = ret.pop()
                new_boxes = [b for b in new_boxes if b[4] is not lost]
            return ret, new_boxes
        tracker.step = step
    elif fault == "no_kalman_update":             # predict only
        tracker._kf_update = lambda kf, det: None
    elif fault == "no_scale_pool":                # the frame's own scale, not the pool's
        tracker._pool = lambda pool: (np.asarray(pool[-1][0], np.float64), np.asarray(pool[-1][1], np.float64))
    elif fault == "zero_pre_hm":                  # previous-frame heatmaps left empty
        det.cfg = det.cfg.replace(empty_pre_hm=True)
    elif fault == "hm_off_by_one":                # the centre heatmap read one cell to the right
        real_forward = det.model.forward

        def forward(*args, **kwargs):
            out = real_forward(*args, **kwargs)
            out["hm"] = torch.roll(out["hm"], 1, dims=2)
            return out
        det.model.forward = forward
    elif fault == "re_pnp_unfiltered":            # the re-PnP given the frame's keypoints, not the filtered
        real_re_pnp = tracker._re_pnp_batch

        def re_pnp(items):
            return real_re_pnp([(t, np.where(k > -5000, np.asarray(t["kps"], np.float64).reshape(-1, 2), k), s, c)
                                for t, k, s, c in items])
        tracker._re_pnp_batch = re_pnp
    elif fault is not None:
        raise ValueError(fault)


def run(cell: Cell, t_process: float) -> Result:
    from centerpose_tpu_torch.inference.detector import Detector

    c, t = cell.config, cell.traffic
    device = torch.device(cell.device)
    cuda = device.type == "cuda"
    spec = track_net.spec_of(c)
    frame_hw = tuple(t["frame_hw"])
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = c["cudnn_tf32"], c["matmul_tf32"]

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    frames = video.frames(cell.seed, int(t["frames"]), frame_hw, t["max_step_px"], device)
    order = video.play_order(len(frames))
    state = cell_state(cell, device)
    det = Detector(detector_config(cell), state_dict=state, device=device)
    plant(det, cell.fault)
    played = [0]

    def next_frame():
        out = det.run(frames[order[played[0] % len(order)]])
        played[0] += 1
        return out

    for _ in range(int(t["warmup_frames"])):
        next_frame()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    n_checks = int(t["check_frames"])
    load = (int(t["tracks_per_frame"]), 0)
    kept = []                                     # (frame index, previous frame's, state, output)
    done = off_load = 0
    now = t0
    while True:
        ids = det.tracker.id_count
        if len(kept) < n_checks and now - t0 >= cell.seconds * len(kept) / n_checks:
            index, previous = (order[(played[0] + i) % len(order)] for i in (0, -1))
            start = track_checks.kept_state(det.tracker)
            out = next_frame()
            kept.append((index, previous, start, track_checks.program_frame(out, det.tracker)))
        else:
            out = next_frame()
        off_load += track_checks.frame_load(out, ids, det.tracker.id_count) != load
        done += 1
        now = time.perf_counter()
        if now - t0 >= cell.seconds:
            break
    window_s = now - t0
    trace = None
    if cell.trace:
        trace = traced_segment(next_frame, int(t["profile_frames"]))
    if cuda:
        torch.cuda.synchronize(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    work, dcn_calls = flops_track.network_work(spec, (c["input_h"], c["input_w"]))
    counters = {"images_per_s": done / window_s, "network_flops_per_image": work, "dcn_calls": dcn_calls,
                "dtype": c["serve_dtype"]}
    if cell.trace:
        counters["profiled_frames"] = int(t["profile_frames"])

    # ---- the window is closed: the program's state goes, then the reference.
    del det
    if cuda:
        torch.cuda.empty_cache()
    net = track_net.build(spec, device, state)
    params = reference_params(cell)
    pairs = []
    with torch.no_grad(), exact_float32():
        for index, previous, start, prog in kept:
            ref = reftrack.step(net, start, frames[previous], frames[index], track_checks.cells_of(prog), params,
                                device)
            pairs.append((prog, ref))
    numbers = track_checks.compare(pairs, frame_hw)
    numbers.update(checked_frames=float(len(pairs)), off_load_frames=float(off_load), off_load_share=off_load / done)
    verdicts = judge(numbers, t["limits"][c["name"]])
    if len(pairs) < n_checks:
        verdicts.append({"name": "checked_frames", "value": float(len(pairs)), "limit": float(n_checks),
                         "ok": False})
    return Result(attempted=done, failed=0,
                  end_to_end={"serve_images_per_s": done / window_s, "setup_s": setup_s},
                  counters=counters, checks=verdicts, memory_peak_bytes=int(memory_peak), trace=trace,
                  numbers=numbers)


def traced_segment(next_frame, n: int):
    """`n` frames of the run, in its steady state, under the profiler (one
    frame more leads in), each in the benchmark's span `frame`."""
    def segment():
        for _ in range(n + 1):
            with span("frame"):
                next_frame()
    return profile(segment, steady="frame")
