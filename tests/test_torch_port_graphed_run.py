"""On the card: `Detector.run` replays the network and decode as one CUDA
graph (`Detector._forward_decode_graphed`), captured once, and a tracked
video through it gives what the eager path gives, to the bit, with the same
count of DCN forward launches (one network a frame). Skips without
a CUDA device. Run with `python -m pytest tests/test_torch_port_graphed_run.py`."""

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.ops.dcn_fwd import dcn_v2_forward

FRAMES = 5
KEYS = ("score", "ct", "kps", "kps_fusion_mean", "kps_mean_kf", "obj_scale_kf", "kps_pnp_kf")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is the card's")
    return torch.device("cuda")


@pytest.mark.card
def test_graphed_video_matches_eager(card):
    cfg = preset("centerpose_track", input_h=128, input_w=128, K=2, vis_thresh=0.0, new_thresh=0.0)
    base = np.random.default_rng(3).integers(0, 255, (96, 128, 3), dtype=np.uint8)
    frames = [np.ascontiguousarray(np.roll(base, 2 * k, axis=1)) for k in range(FRAMES)]
    outs, launches = {}, {}
    for graphed in (False, True):
        det = Detector(cfg, device=card, seed=4)
        det.graphed = graphed
        before = dcn_v2_forward.launches, dict(dcn_v2_forward.launches_by_shape)
        outs[graphed] = [det.run(f) for f in frames]
        launches[graphed] = (dcn_v2_forward.launches - before[0],
                             {k: v - before[1].get(k, 0) for k, v in dcn_v2_forward.launches_by_shape.items()})
        assert len(det._graphs) == int(graphed)   # one capture serves every later frame
    assert launches[True] == launches[False] and launches[False][0] == 16 * FRAMES
    for eager, graph in zip(outs[False], outs[True]):
        assert [t["tracking_id"] for t in eager["results"]] == [t["tracking_id"] for t in graph["results"]]
        assert eager["results"], "no track: nothing compared"
        for a, b in zip(eager["results"], graph["results"]):
            for key in KEYS:
                if key in a:
                    np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]), err_msg=key)


def test_a_capture_takes_back_the_launches_it_counted():
    """The capture's counted launches are taken back whole, by shape too, and
    a replay adds them again (`inference/detector.py::_count_dcn_launches`)."""
    from centerpose_tpu_torch.inference.detector import _count_dcn_launches, _dcn_launches

    before = _dcn_launches()
    dcn_v2_forward.launches += 3
    dcn_v2_forward.launches_bf16 += 1
    dcn_v2_forward.launches_by_shape.update({(128, 64, 64): 2, (999, 8, 8): 1})
    launched = _dcn_launches(since=before)
    assert launched[:2] == (3, 1) and launched[2] == {(128, 64, 64): 2, (999, 8, 8): 1}
    _count_dcn_launches(launched, -1)
    assert _dcn_launches() == before and (999, 8, 8) not in dcn_v2_forward.launches_by_shape
    _count_dcn_launches(launched, 1)
    assert _dcn_launches(since=before) == launched
    _count_dcn_launches(launched, -1)
