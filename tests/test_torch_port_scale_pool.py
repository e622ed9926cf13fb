"""The tracker's scale pool (`tracking/tracker.py::ScalePool`): the sums it
keeps as a track's history grows give the published loop's fusion
(tracker.py:98-110) to the bit, and a tracked `Detector.run` keeps its
tracks' histories in it."""

import copy
import pickle

import numpy as np
import pytest

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.tracking.tracker import ScalePool, _pool_scale


def _history(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.1, 3.0, 3).astype(np.float32), rng.uniform(0.01, 2.0, 3).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_kept_sums_give_the_loop_to_the_bit(n):
    history = _history(n, n)
    pool = ScalePool(history[:1])
    for item in history[1:]:
        pool.append(item)
    assert list(pool) == history
    for got, want in zip(_pool_scale(pool), _pool_scale(list(history))):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clone", [copy.copy, copy.deepcopy, lambda p: pickle.loads(pickle.dumps(p))],
                         ids=["copy", "deepcopy", "pickle"])
def test_a_copy_keeps_the_sums_of_its_items(clone):
    history = _history(5, 11)
    pool = ScalePool(history)
    twin = clone(pool)
    assert isinstance(twin, ScalePool) and len(twin) == len(pool)
    np.testing.assert_array_equal(twin.prec, pool.prec)
    np.testing.assert_array_equal(twin.weighted, pool.weighted)


def test_tracked_run_keeps_its_histories_in_the_pool():
    cfg = preset("centerpose_track", input_h=64, input_w=64, K=2, vis_thresh=0.0, new_thresh=0.0)
    det = Detector(cfg, device="cpu", seed=5)
    base = np.random.default_rng(7).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    for k in range(3):
        out = det.run(np.roll(base, k, axis=1))
    tracks = out["results"]
    assert tracks and all(isinstance(t["scale_pool"], ScalePool) for t in tracks)
    for t in tracks:
        mean, std = _pool_scale(list(t["scale_pool"]))
        np.testing.assert_array_equal(t["obj_scale_kf"], mean)
        np.testing.assert_array_equal(t["obj_scale_uncertainty_kf"], std)
