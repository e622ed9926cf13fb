"""Offline batched serving: `Detector.run_batch_stream` over chunks of uint8
frames, one chunk in flight on the device while the host finishes the one
before (post, merge, one padded PnP solve).

Traffic parameters (`posebench/traffic/<name>.json`): `chunk` frames a chunk,
`frame_hw`, `low_hw` (the smoothness of the frames), `pool_chunks` distinct
chunks made at set-up and fed in turn, `warmup_chunks`, the detector's `K`,
`vis_thresh`, `box_px` (the box width of `weights.py`, output pixels),
the `boxes_per_image` that these give (set from the reference's scores), `check_images` (the sample compared
with the reference after the window), `profile_chunks` (the traced segment)
and `limits` per configuration.

End-to-end: `serve_images_per_s` (images whose poses came out in the window
over the window), `setup_s`. Counters: the `pnp` stage of each chunk
(`Detector`'s own clock), the boxes that reached PnP per image, the work
counted from shapes.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from posebench import checks, flops, inputs, weights
from posebench.harness import Cell, Result, exact_float32
from posebench.reference import net as refnet
from posebench.reference import serve as refserve
from posebench.trace import profile, span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def detector_config(cell: Cell):
    from centerpose_tpu_torch.config import preset

    c, t = cell.config, cell.traffic
    return preset(c["preset"], category=c["category"], input_h=c["input_h"], input_w=c["input_w"],
                  compute_dtype=c["serve_dtype"], vis_thresh=t["vis_thresh"], K=t["K"])


def boxes_of_output(out: dict):
    """The program's detections of one image as reference `Box`es."""
    return [refserve.Box(ct=np.asarray(d["ct"], np.float64), score=float(d["score"]),
                         kps=np.asarray(d["kps"], np.float64).reshape(-1),
                         disp=np.asarray(d["kps_displacement_mean"], np.float64).reshape(-1),
                         projected=(np.asarray(d["projected_cuboid"], np.float64)
                                    if "location" in d else None),
                         scale=np.asarray(d["obj_scale"], np.float64))
            for d in out["results"]]


def plant(det, fault):
    """Tests and readings only: break the timed path underneath the stream."""
    if fault == "answer":                         # keypoints and scores altered where produced
        real = det.merge_outputs

        def merge(dets):
            out = real(dets)
            for d in out:
                d["kps"] = np.asarray(d["kps"]) + 2.0
                d["score"] = d["score"] * 0.9
            return out
        det.merge_outputs = merge
    elif fault == "half_batch":                   # half of each chunk left out
        real_finish = det._batch_finish

        def finish(handle, timing=False):
            outs = real_finish(handle, timing)
            return outs[: len(outs) // 2]
        det._batch_finish = finish
    elif fault in ("next_peaks", "no_peak_filter"):
        # decode's choice of cells: the K best peaks after the K best, or
        # the K best cells with no 3x3 peak filter
        from centerpose_tpu_torch.ops import decode

        real_decode = det._forward_decode

        def forward_decode(*args, **kw):
            real_topk, real_nms = decode.topk, decode.heat_nms
            if fault == "next_peaks":
                decode.topk = lambda scores, k: tuple(v[:, k:] for v in real_topk(scores, 2 * k))
            else:
                decode.heat_nms = lambda heat, kernel=3: heat
            try:
                return real_decode(*args, **kw)
            finally:
                decode.topk, decode.heat_nms = real_topk, real_nms
        det._forward_decode = forward_decode
    elif fault is not None:
        raise ValueError(fault)


def run(cell: Cell, t_process: float) -> Result:
    from centerpose_tpu_torch.inference.detector import Detector

    c, t = cell.config, cell.traffic
    device = torch.device(cell.device)
    cuda = device.type == "cuda"
    spec = refnet.spec_of(c)
    out_res = c["input_w"] // c["down_ratio"]
    frame_hw = tuple(t["frame_hw"])
    chunk = int(t["chunk"])

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    pool = inputs.smooth_frames(cell.seed, t["pool_chunks"] * chunk, frame_hw, t["low_hw"], device)
    state = served_state(cell, device)
    det = Detector(detector_config(cell), state_dict=state, device=device)
    plant(det, cell.fault)
    chunks = [list(pool[k * chunk:(k + 1) * chunk]) for k in range(t["pool_chunks"])]

    fed = collections.deque()
    stop = [False]

    def feed():
        k = 0
        while not stop[0]:
            fed.append(k % len(chunks))
            yield chunks[k % len(chunks)], None
            k += 1

    stream = det.run_batch_stream(feed(), timing=True)
    for _ in range(t["warmup_chunks"]):
        next(stream)
        fed.popleft()
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    sample = Reservoir(int(t["check_images"]), np.random.default_rng([cell.seed, 1]))
    chunks_done = done = boxes = 0
    pnp_ms = []
    while True:
        outs = next(stream)
        now = time.perf_counter()
        k = fed.popleft()
        chunks_done += 1
        done += len(outs)
        boxes += sum(len(o["results"]) for o in outs)
        if outs:
            pnp_ms.append(1e3 * outs[0]["times"]["pnp"])
        sample.offer([(k * chunk + i, outs[i] if i < len(outs) else None) for i in range(chunk)])
        if now - t0 >= cell.seconds:
            break
    window_s = now - t0
    trace = None
    if cell.trace:
        trace = traced_segment(det, stream, int(t["profile_chunks"]))
    stop[0] = True
    for _ in stream:                              # the chunk still in flight
        pass
    if cuda:
        torch.cuda.synchronize(device)
    attempted = chunk * chunks_done
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    work, dcn_calls = flops.network_work(spec, (c["input_h"], c["input_w"]))
    counters = {
        "images_per_s": done / window_s,
        "network_flops_per_image": work,
        "pnp_ms_per_chunk": pnp_ms,
        "boxes_per_image": boxes / max(done, 1),
        "dcn_calls": dcn_calls,
        "dtype": c["serve_dtype"],
    }
    if cell.trace:
        counters["profiled_chunks"] = int(t["profile_chunks"])
        counters["chunk"] = chunk

    # ---- the window is closed: the program's state goes, then the reference.
    sample = [(frame, boxes_of_output(out) if out is not None else None) for frame, out in sample.items]
    del det, stream
    if cuda:
        torch.cuda.empty_cache()
    net = refnet.build(spec, device, state)
    with torch.no_grad(), exact_float32():
        ref = refserve.detect(net, pool[[s for s, _ in sample]], reference_params(cell), device)
        numbers = checks.compare_boxes([b for _, b in sample], ref, t["vis_thresh"], c["hm_hp_thresh"],
                                       frame_hw, out_res, device)
    verdicts = checks.judge(numbers, t["limits"][c["name"]])
    failed = attempted - done
    return Result(attempted=attempted, failed=failed,
                  end_to_end={"serve_images_per_s": done / window_s, "setup_s": setup_s},
                  counters=counters, checks=verdicts, memory_peak_bytes=int(memory_peak), trace=trace,
                  numbers=numbers)


def served_state(cell: Cell, device):
    """The cell's weights from its seed, in the served type."""
    c, t = cell.config, cell.traffic
    return weights.make_state(refnet.spec_of(c), cell.seed, device, t["frame_hw"][1], c["input_w"] // c["down_ratio"],
                              t["box_px"], dtype=DTYPES[c["serve_dtype"]])


class Reservoir:
    """A uniform sample of `size` of the items offered, drawn from `rng`
    (Algorithm R), so that the window keeps no more than the sample."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, items) -> None:
        draws = self.rng.integers(0, np.arange(self.seen + 1, self.seen + len(items) + 1))
        for item, j in zip(items, draws):
            if len(self.items) < self.size:
                self.items.append(item)
            elif j < self.size:
                self.items[j] = item
        self.seen += len(items)


def reference_params(cell: Cell) -> dict:
    t = cell.traffic
    c = cell.config
    return {"input": c["input_w"], "K": t["K"], "vis_thresh": t["vis_thresh"],
            "hm_hp_thresh": c["hm_hp_thresh"], "balance_coefficient": c["balance_coefficient"]}


def traced_segment(det, stream, n: int):
    """`n` chunks of the window's own stream, in its steady state, under
    the profiler (one chunk more leads in), the detector's stages inside the
    benchmark's spans."""
    stages = (("_batch_submit", "submit"), ("_batch_finish", "finish"), ("post_process", "post"),
              ("merge_outputs", "merge"), ("run_pnp_multi", "pnp"))
    saved = {name: vars(det)[name] for name, _ in stages if name in vars(det)}
    for name, label in stages:
        real = getattr(det, name)

        def call(*args, _real=real, _label=label, **kw):
            with span(_label):
                return _real(*args, **kw)
        setattr(det, name, call)
    try:
        def segment():
            for _ in range(n + 1):
                with span("chunk"):
                    next(stream)
        return profile(segment, steady="chunk")
    finally:
        for name, _ in stages:
            if name in saved:
                setattr(det, name, saved[name])
            else:
                delattr(det, name)
