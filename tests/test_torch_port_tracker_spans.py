"""The tracker's telemetry on the CPU: four tracked 64x64 frames of the
CenterPoseTrack model through `Detector.run` give, frame by frame, the span
tree `run` > `net` > `render` and `run` > `track` > `associate`, `kalman`,
`pool`, `re_pnp` (> `assemble`, `wait.track_pnp.results`, `fetch`,
`consume`; `solve` too on the card), and the counters `tracks`,
`tracks.matched`, `tracks.new` and `re_pnp.rows` once a frame, tallied on
the frame's `run` span."""

import numpy as np
import pytest

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.utils import profiler

FRAMES = 4
COUNTERS = ("tracks", "tracks.matched", "tracks.new", "re_pnp.rows")


@pytest.fixture(scope="module")
def tracked():
    # thresholds at 0, so that every decoded box reaches PnP and spawns a track
    cfg = preset("centerpose_track", input_h=64, input_w=64, K=2, vis_thresh=0.0, new_thresh=0.0)
    det = Detector(cfg, device="cpu", seed=5)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    profiler.reset()
    outs = [det.run(np.roll(base, k, axis=1)) for k in range(FRAMES)]
    snap = profiler.snapshot()
    profiler.reset()
    return outs, snap


def _parents(snap, name):
    return {r["parent"] for r in snap["spans"][name]["records"]}


def test_span_tree_of_a_tracked_run(tracked):
    outs, snap = tracked
    spans = snap["spans"]
    assert spans["run"]["count"] == FRAMES
    assert _parents(snap, "render") == {"net"} and spans["render"]["count"] == FRAMES
    for name in ("associate", "kalman", "pool", "re_pnp"):
        assert _parents(snap, name) == {"track"} and spans[name]["count"] == FRAMES, name
    for name in ("assemble", "wait.track_pnp.results", "fetch", "consume"):
        assert "re_pnp" in _parents(snap, name), name
    assert sum(r["parent"] == "re_pnp" for r in spans["wait.track_pnp.results"]["records"]) == FRAMES
    # the stages run in order inside each frame's `track` span, under its frame id
    for frame in range(FRAMES):
        recs = [next(r for r in spans[n]["records"] if r["ids"]["frame"] == frame)
                for n in ("associate", "kalman", "pool", "re_pnp")]
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(recs, recs[1:]))
    assert all(len(o["results"]) > 0 for o in outs)


def test_counters_once_a_frame(tracked):
    outs, snap = tracked
    runs = snap["spans"]["run"]["records"]
    assert len(runs) == FRAMES
    for rec, out in zip(runs, outs):
        counts = rec["counts"]
        assert set(COUNTERS) <= set(counts)
        assert counts["tracks"] == len(out["results"])
        assert counts["re_pnp.rows"] == min(len(out["results"]), 16)
        assert counts["tracks.matched"] + counts["tracks.new"] <= counts["tracks"]
    first = runs[0]["counts"]
    assert first["tracks.matched"] == 0 and first["tracks.new"] == first["tracks"] > 0
    for name in COUNTERS:
        assert snap["counters"][name] == sum(r["counts"][name] for r in runs)
