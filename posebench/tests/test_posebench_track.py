"""The tracking cell at a size the CPU holds (64x64 inputs, 96x128 frames,
a few frames), shrunk here since `conftest.py::tiny_cell` knows the serving
and training cells only; the paths, thresholds and limits are the cell's:

- the reference tracking network against the port's module on one seeded
  state, with the previous-frame inputs;
- tracked frames of `Detector.run` against the reference stepped from the
  kept states: the same track ids and counts, gaps far under a pixel;
- each planted fault fails the check;
- the load count: a frame's matched and started tracks, and a window off
  the traffic's load fails the check (a 16x16 heatmap does not hold the
  cell's two tracks steadily, so the other tests leave the load's limit
  out);
- the work count by hand on one stem and one head;
- the reference's new modules load nothing of the port, nor JAX."""

import json
import subprocess
import sys

import pytest
import torch

from posebench import flops_track, harness, track_checks, track_weights
from posebench.drivers import track
from posebench.reference import track_net
from posebench.tests.conftest import TINY_SEED

WORKLOAD = "track_b1.dla_34_track"


class StepClock:
    """The driver's clock made to advance a fixed step at each reading, so
    that the tiny window holds the same frames (and checked frames) however
    busy the CPU is."""

    def __init__(self, step: float = 0.1):
        self.now, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


def run_tiny(cell):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(track, "time", StepClock())
        return track.run(cell, 0.0)


def tiny_track_cell(seed: int = TINY_SEED, seconds: float = 1.0):
    cell = harness.cell(WORKLOAD, seed, seconds, False, device="cpu")
    cell.config.update(input_h=64, input_w=64)
    cell.traffic.update(frames=12, frame_hw=[96, 128], warmup_frames=3, check_frames=4,
                        profile_frames=2)
    del cell.traffic["limits"][cell.config["name"]]["off_load_frames"]
    return cell


def test_network_matches_port():
    from centerpose_tpu_torch.models.convert import load_reference_state_dict
    from centerpose_tpu_torch.models.factory import create_model

    cell = tiny_track_cell()
    spec = track_net.spec_of(cell.config)
    state = track_weights.make_state(spec, TINY_SEED, "cpu", 128, 16, cell.traffic["box_px"])
    port = create_model(track.detector_config(cell), "cpu")
    load_reference_state_dict(port, state)
    ref = track_net.build(spec, "cpu", state)
    gen = torch.Generator().manual_seed(3)
    x, pre_img = (torch.randn(1, 64, 64, 3, generator=gen) for _ in range(2))
    pre_hm, pre_hm_hp = torch.rand(1, 64, 64, 1, generator=gen), torch.rand(1, 64, 64, 8, generator=gen)
    with torch.no_grad():
        a, b = port(x, pre_img, pre_hm, pre_hm_hp), ref(x, pre_img, pre_hm, pre_hm_hp)
    assert list(a) == list(b) == [h for h, _ in track_net.TRACK_HEADS]
    for k in a:
        assert torch.allclose(a[k], b[k], rtol=2e-4, atol=2e-4), k   # the repo's DCN-arch tolerance


@pytest.fixture(scope="module")
def sound_run():
    cell = tiny_track_cell()
    return cell, run_tiny(cell)


def test_tracked_frames_match_reference(sound_run):
    cell, result = sound_run
    n = result.numbers
    assert result.correct, result.checks
    assert n["checked_frames"] == cell.traffic["check_frames"] and n["tracks_checked"] >= 4
    assert n["missing_boxes"] == 0 and n["track_id_mismatch"] == 0
    assert n["score_gap"] < 1e-4 and n["scale_gap"] < 1e-4
    assert max(n["kps_gap_px"], n["kf_kps_gap_px"], n["pose_gap_px"], n["fit_excess_px"]) < 1e-2
    assert n["rows_4_5_share"] == 1.0 and n["choice_gap"] == 0.0      # three joints gated: EPnP rows
    assert n["off_load_frames"] <= result.attempted and 0 <= n["off_load_share"] <= 1
    assert result.end_to_end["serve_images_per_s"] > 0 and result.attempted > 0


@pytest.mark.parametrize("fault", ["drop_track", "no_kalman_update", "no_scale_pool", "zero_pre_hm",
                                   "hm_off_by_one", "re_pnp_unfiltered"])
def test_planted_fault_is_not_correct(fault):
    cell = tiny_track_cell()
    cell.fault = fault
    result = run_tiny(cell)
    assert not result.correct, result.numbers


def test_frame_load_and_off_load_frames():
    out = {"results": [{"tracking_id": 1, "age": 1}, {"tracking_id": 2, "age": 2}, {"tracking_id": 4, "age": 1},
                       {"tracking_id": 3, "age": 1}]}
    assert track_checks.frame_load(out, 3, 4) == (2, 1)       # 1 and 3 matched, 2 aged, 4 started
    cell = tiny_track_cell()
    cell.traffic["tracks_per_frame"] = 99
    cell.traffic["limits"][cell.config["name"]]["off_load_frames"] = 0
    result = run_tiny(cell)
    assert result.numbers["off_load_frames"] == result.attempted and result.numbers["off_load_share"] == 1.0
    assert [c["name"] for c in result.checks if not c["ok"]] == ["off_load_frames"]


def test_work_counted_by_hand(monkeypatch):
    """One stem and one head, counted by hand: what the count loses when
    the network lacks them."""
    h = w = 64
    spec = track_net.TrackSpec("dla_34")
    total, calls = flops_track.network_work(spec, (h, w))
    assert len(calls) == 16 and calls[0] == (2, 2, 512, 256)
    # the tracking_hp head: 3x3 64 -> 256, then 1x1 256 -> 16, at the stride-4 map
    heads = tuple(hd for hd in track_net.TRACK_HEADS if hd[0] != "tracking_hp")
    without_head = flops_track.network_work(track_net.TrackSpec("dla_34", heads=heads), (h, w))[0]
    assert total - without_head == pytest.approx(2.0 * (h // 4) * (w // 4) * (9 * 64 * 256 + 256 * 16))
    # the keypoint-heatmap stem: 7x7, 8 -> 16, at the input size
    monkeypatch.setattr(track_net, "PRE_STEMS", track_net.PRE_STEMS[:2])
    without_stem = flops_track.network_work(spec, (h, w))[0]
    assert total - without_stem == pytest.approx(2.0 * h * w * 16 * 8 * 49)
    dcn = sum(2.0 * hh * ww * 9 * cc * oo for hh, ww, cc, oo in calls)
    assert 0 < dcn < total


@pytest.mark.parametrize("module", ["posebench.reference.track_net", "posebench.reference.track"])
def test_reference_loads_nothing_of_the_port(module):
    code = f"import json, sys; import {module}; print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(harness.ROOT), timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "centerpose_tpu", "centerpose_tpu_torch"}
