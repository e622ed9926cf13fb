"""On the card: every synchronisation of a steady serving chunk and of a
steady tracked frame sits at a named `wait` site of `utils/profiler.py`,
and a train step has none.

Each test runs its work under `profiler.strict_syncs()`, which sets
`torch.cuda.set_sync_debug_mode("error")` and lifts it only inside each
`wait` span (a drain, or a call that synchronises by itself) and the copy
that a drain guards, so a synchronisation anywhere else raises. Skips without a CUDA device. Run with
`python -m pytest tests/test_torch_port_sync_sites.py`.
"""

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import targets
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training import trainer
from centerpose_tpu_torch.utils import profiler

# The wait sites of a steady chunk of `run_batch_stream` (PERF.md lists them):
# PnP's are its one packed upload and its one packed fetch.
CHUNK_SITES = {"frames", "transforms", "warp.mean", "warp.std", "dets", "pnp.inputs", "pnp.results"}
# The wait sites of a steady tracked frame of `Detector.run`: the render's
# upload, and the tracker's re-PnP (its packed upload at `pnp.inputs` again,
# its fetch at `track_pnp.results`). 10 waits: `pnp.inputs` twice.
FRAME_SITES = {"frames", "transforms", "render", "warp.mean", "warp.std", "dets", "pnp.inputs", "pnp.results",
               "track_pnp.results"}
FRAME_WAITS = 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the synchronisations checked are the card's")
    return torch.device("cuda")


@pytest.mark.card
def test_steady_chunk_syncs_only_at_wait_sites(card):
    cfg = preset("centerpose", compute_dtype="bfloat16", vis_thresh=0.05, K=2)
    det = Detector(cfg, device=card, seed=1)
    rng = np.random.default_rng(0)
    chunks = [[rng.integers(0, 255, (480, 640, 3), dtype=np.uint8) for _ in range(8)] for _ in range(2)]

    def feed():
        k = 0
        while True:
            yield chunks[k % 2], None
            k += 1

    stream = det.run_batch_stream(feed(), timing=True)
    for _ in range(3):
        next(stream)
    profiler.reset()
    before = profiler.snapshot()["counters"]
    with profiler.strict_syncs():
        outs = next(stream)
        phases = profiler.snapshot()["phases"]
    boxes = sum(len(o["results"]) for o in outs)
    assert boxes > 0, "no box reached PnP: its sites went unchecked"
    snap = profiler.snapshot()
    sites = {name[len("wait."):] for name in snap["spans"] if name.startswith("wait.")}
    assert sites == CHUNK_SITES
    assert all(snap["spans"]["wait." + site]["count"] == 1 for site in ("pnp.inputs", "pnp.results"))
    # the chunk's boxes went through the kernel, in one launch
    assert snap["counters"]["pnp.launches"] - before.get("pnp.launches", 0) == 1
    assert snap["counters"]["pnp.rows"] - before.get("pnp.rows", 0) == boxes
    assert phases["model"]["count"] >= 1 and phases["model"]["records"][0]["ms"]["model"] > 0
    profiler.reset()


@pytest.mark.card
def test_steady_tracked_frame_syncs_only_at_wait_sites(card):
    """One steady frame of the CenterPoseTrack model (float32, the device
    warp and render, two tracks carried): its sites, and two PnP launches,
    the Detector's rows and the tracker's 16-slot re-PnP."""
    cfg = preset("centerpose_track", vis_thresh=0.0, new_thresh=0.0, K=2)
    det = Detector(cfg, device=card, seed=1)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (480, 640, 3), dtype=np.uint8) for _ in range(2)]
    for k in range(3):
        det.run(frames[k % 2])
    torch.cuda.synchronize()
    profiler.reset()
    before = profiler.snapshot()["counters"]
    with profiler.strict_syncs():
        out = det.run(frames[1])
    assert len(out["results"]) > 0, "no track reached the re-PnP: its sites went unchecked"
    snap = profiler.snapshot()
    sites = {name[len("wait."):] for name in snap["spans"] if name.startswith("wait.")}
    assert sites == FRAME_SITES
    assert snap["counters"]["wait"] == FRAME_WAITS
    assert snap["counters"]["pnp.launches"] - before.get("pnp.launches", 0) == 2
    assert snap["counters"]["re_pnp.rows"] == min(len(out["results"]), cfg.max_tracks)
    profiler.reset()


@pytest.mark.card
def test_train_step_never_synchronises(card):
    cfg = preset("centerpose", input_h=128, input_w=128, batch_size=2)
    model = create_model(cfg, card, param_dtype="float32")
    state, tx = trainer.create_train_state(cfg, model)
    step = trainer.make_train_step(cfg, model, tx)
    # a batch of images with no objects, kept on the card as the benchmark's are
    host = targets.stack_batch([targets.render_targets([], cfg) for _ in range(2)])
    host["input"] = np.random.default_rng(0).standard_normal((2, 128, 128, 3)).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(card) for k, v in host.items()}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    profiler.reset()
    with profiler.strict_syncs():
        for _ in range(2):
            state, stats = step(state, batch)
    torch.cuda.synchronize()
    snap = profiler.snapshot()
    assert "wait" not in snap["counters"]
    assert snap["phases"]["step"]["count"] == 2
    assert all(ms > 0 for ms in snap["phases"]["step"]["records"][0]["ms"].values())
    assert torch.isfinite(stats["loss"]).item()
    profiler.reset()
