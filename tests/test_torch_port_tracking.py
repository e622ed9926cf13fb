"""The PyTorch package's tracker against the JAX package's, on the CPU.

Kalman filter, assignment, scale pool, `Tracker` / `TrackerBaseline` over a
scripted 5-frame sequence of detections (spawn, match, age-out, a low score,
the ground-truth seed of `init_track`, more tracks than `max_tracks`), and
the previous-frame render. The filter is the same numpy code in both
packages, so its state must agree to 1e-10; the re-PnP is a float32 solve on
either side, held at the tolerance of `test_torch_port_serving.py`'s PnP
tests (pose 1e-3, projections 0.05 px).
"""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.tracking import kalman as jax_kalman
from centerpose_tpu.tracking import render as jax_render
from centerpose_tpu.tracking import tracker as jax_tracker
from centerpose_tpu.tracking.tracker_baseline import TrackerBaseline as JaxTrackerBaseline
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.inference.detector import DEFAULT_CAMERA
from centerpose_tpu_torch.tracking import kalman, render, tracker
from centerpose_tpu_torch.tracking.tracker_baseline import TrackerBaseline

WIDTH, HEIGHT = 640, 480
MAX_TRACKS = 4
META = {"camera_matrix": DEFAULT_CAMERA, "width": WIDTH, "height": HEIGHT,
        "c": np.array([WIDTH / 2.0, HEIGHT / 2.0], np.float32), "s": float(WIDTH)}


# -------------------------------------------------------------------- kalman
def test_kalman_matches_jax():
    """init / predict / update / position-only update / accessors, 1e-10."""
    rng = np.random.RandomState(0)
    mean, std, thp = rng.randn(16) * 50, rng.rand(16) * 3 + 0.5, rng.randn(16)
    ref = jax_kalman.KeypointKalman.init(mean, std, thp, 20.0)
    out = kalman.KeypointKalman.init(mean, std, thp, 20.0)
    for step in range(4):
        ref.predict()
        out.predict()
        args = (mean + rng.randn(16), rng.rand(16) * 3 + 0.5, rng.randn(16))
        if step % 2:
            ref.update_positions(*args[:2])
            out.update_positions(*args[:2])
        else:
            ref.update(*args)
            out.update(*args)
        np.testing.assert_allclose(out.x, ref.x, atol=1e-10, rtol=0)
        np.testing.assert_allclose(out.p, ref.p, atol=1e-10, rtol=0)
    for name in ("positions", "position_std", "mean_velocity"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), atol=1e-10, rtol=0)
    np.testing.assert_allclose(out.confidence((3.0, 9.0)), ref.confidence((3.0, 9.0)), atol=1e-10)
    np.testing.assert_array_equal(kalman._measurement_r(std, 20.0), jax_kalman._measurement_r(std, 20.0))
    np.testing.assert_array_equal(kalman._measurement_z(mean, thp), jax_kalman._measurement_z(mean, thp))


def test_greedy_assignment_and_pool_scale_match_jax():
    rng = np.random.RandomState(1)
    dist = rng.rand(6, 5) * 100
    dist[rng.rand(6, 5) < 0.3] = 1e18                 # gated pairs
    np.testing.assert_array_equal(tracker.greedy_assignment(dist), jax_tracker.greedy_assignment(dist))
    assert tracker.greedy_assignment(np.zeros((3, 0))).shape == (0, 2)
    pool = [(rng.rand(3) + 0.5, rng.rand(3) * 0.2 + 0.05) for _ in range(4)]
    for a, b in zip(tracker._pool_scale(pool), jax_tracker._pool_scale(pool)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the sequence
def _rodrigues(rvec):
    theta = np.linalg.norm(rvec)
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _det(rng, center_xy, depth, score, motion):
    """A detection whose keypoints are the projection of a planted cuboid (so
    that the re-PnP is well posed), with noisy fused keypoints."""
    scale = np.array([rng.uniform(0.6, 1.2), 1.0, rng.uniform(0.6, 1.4)])
    cub = cuboid_vertices(scale)
    cam = DEFAULT_CAMERA
    t = np.array([(center_xy[0] - cam[0, 2]) / cam[0, 0] * depth,
                  (center_xy[1] - cam[1, 2]) / cam[1, 1] * depth, depth])
    pc = cub @ _rodrigues(rng.randn(3) * 0.3 + [0.0, 0.6, 0.0]).T + t
    uv = pc[:, :2] / pc[:, 2:] * [cam[0, 0], cam[1, 1]] + [cam[0, 2], cam[1, 2]]
    kps = uv.reshape(-1)
    bbox = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])
    return {
        "score": score, "cls": 0,
        "bbox": bbox, "ct": [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
        "tracking": -np.asarray(motion, np.float64),
        "tracking_hp": np.tile(-np.asarray(motion, np.float64), 8) + rng.randn(16) * 0.2,
        "kps": kps,
        "kps_fusion_mean": kps + rng.randn(16) * 0.5,
        "kps_fusion_std": rng.uniform(1.0, 4.0, 16),
        "kps_heatmap_std": np.where(rng.rand(16) < 0.1, -10000.0, rng.uniform(1.0, 3.0, 16)),
        "kps_heatmap_height": rng.uniform(0.2, 0.9, 8),
        "obj_scale": scale / scale[1],
        "obj_scale_uncertainty": rng.uniform(0.05, 0.2, 3),
    }


def _sequence(seed=0):
    """Five frames of (detections) for up to five objects: A moves right all
    along; B is seen in frames 0-1 and then lost (it ages and, with max_age 2,
    is dropped); C appears in frame 1; D scores below new_thresh; in frame 3
    three more objects appear, more live tracks than MAX_TRACKS slots."""
    rng = np.random.RandomState(seed)
    frames = []
    for f in range(5):
        dets = [_det(rng, (200 + 12 * f, 220 + 3 * f), 5.0, 0.9, (12, 3))]
        if f <= 1:
            dets.append(_det(rng, (560, 420), 6.0, 0.8, (0, 0)))
        if f >= 1:
            dets.append(_det(rng, (420 - 6 * f, 330), 4.5, 0.7, (-6, 0)))
        dets.append(_det(rng, (90, 380), 5.0, 0.2, (0, 0)))
        if f >= 3:
            for x in (110, 330, 560):
                dets.append(_det(rng, (x, 90 + f), 7.0, 0.6, (0, 1)))
        frames.append(dets)
    return frames


def _boxes(dets):
    """pnp_shell tuples as `Detector.run_pnp` hands them to the tracker."""
    out = []
    for d in dets:
        kps9 = np.vstack([d["kps"].reshape(8, 2).mean(0, keepdims=True), d["kps"].reshape(8, 2)])
        kps9 /= [WIDTH, HEIGHT]
        out.append((kps9.copy(), np.zeros((9, 3)) + d["score"], d["obj_scale"], kps9, d))
    return out


def _run(trk, frames, seed_first):
    """Step `trk` over the frames; returns per frame (tracks, boxes)."""
    out = []
    for f, dets in enumerate(frames):
        dets = copy.deepcopy(dets)
        if f == 0 and seed_first:
            trk.init_track(dict(META, pre_dets=dets))
            out.append((list(trk.tracks), []))
            continue
        out.append(trk.step(dets, _boxes(dets), META))
    return out


def _assert_frames_match(got, ref):
    n_repnp = 0
    for f, ((tracks, boxes), (rtracks, rboxes)) in enumerate(zip(got, ref)):
        for key in ("tracking_id", "age", "active"):
            assert [t[key] for t in tracks] == [t[key] for t in rtracks], (f, key)
        for t, r in zip(tracks, rtracks):
            assert ("kf" in t) == ("kf" in r)
            if "kf" in t:
                np.testing.assert_allclose(t["kf"].x, r["kf"].x, atol=1e-10, rtol=0)
                np.testing.assert_allclose(t["kf"].p, r["kf"].p, atol=1e-10, rtol=0)
            for key in ("obj_scale_kf", "obj_scale_uncertainty_kf", "kps_mean_kf", "kps_std_kf"):
                assert (key in t) == (key in r), key
                if key in t:
                    np.testing.assert_allclose(t[key], r[key], atol=1e-10, rtol=0, err_msg=key)
            assert ("kps_pnp_kf" in t) == ("kps_pnp_kf" in r), f
            if "kps_pnp_kf" in t:
                n_repnp += 1
                np.testing.assert_allclose(t["location"], r["location"], atol=1e-3, rtol=0)
                np.testing.assert_allclose(t["quaternion_xyzw"], r["quaternion_xyzw"], atol=1e-3, rtol=0)
                np.testing.assert_allclose(
                    np.asarray(t["kps_pnp_kf"]) * [WIDTH, HEIGHT],
                    np.asarray(r["kps_pnp_kf"]) * [WIDTH, HEIGHT], atol=0.05, rtol=0)
                np.testing.assert_allclose(t["kps_3d_cam_kf"], r["kps_3d_cam_kf"], atol=1e-3, rtol=0)
        assert [b[4]["tracking_id"] for b in boxes] == [b[4]["tracking_id"] for b in rboxes], f
    return n_repnp


def _configs(**kw):
    kw = dict(category="shoe", max_age=2, max_tracks=MAX_TRACKS, new_thresh=0.3, **kw)
    return preset("centerpose_track", **kw), jax_preset("centerpose_track", **kw)


@pytest.mark.parametrize("hungarian,seed_first", [(False, False), (True, False), (False, True), (True, True)])
def test_tracker_matches_jax(hungarian, seed_first, capsys):
    cfg, jcfg = _configs(use_hungarian=hungarian)
    frames = _sequence()
    got = _run(tracker.Tracker(cfg, device="cpu"), frames, seed_first)
    ref = _run(jax_tracker.Tracker(jcfg), frames, seed_first)
    assert _assert_frames_match(got, ref) > 0
    ids = [sorted(t["tracking_id"] for t in tracks) for tracks, _ in got]
    # A keeps id 1 throughout; B (id 2) ages out after max_age frames; D
    # never spawns; frame 3 overflows the MAX_TRACKS re-PnP slots.
    assert all(1 in frame_ids for frame_ids in ids)
    assert 2 not in ids[-1]
    assert max(len(tracks) for tracks, _ in got) > MAX_TRACKS
    assert "exceed max_tracks" in capsys.readouterr().out


def test_tracker_baseline_matches_jax():
    cfg, jcfg = _configs(refined_kalman=True)
    frames = _sequence(1)
    got = _run(TrackerBaseline(cfg, device="cpu"), frames, False)
    ref = _run(JaxTrackerBaseline(jcfg), frames, False)
    assert _assert_frames_match(got, ref) > 0
    # The baseline leaves the velocity block of P0 at 1 and pools by mean.
    trk = got[0][0][0]
    assert np.all(trk["kf"].p[:, 2, 2] > 0)


# -------------------------------------------------------------------- render
@pytest.fixture(scope="module")
def tracked():
    """Tracks after four frames (Kalman state, re-PnP keypoints)."""
    cfg, _ = _configs()
    trk = tracker.Tracker(cfg, device="cpu")
    _run(trk, _sequence(2)[:4], False)
    return trk.tracks


def test_render_inputs_equal_jax(tracked):
    cfg = preset("centerpose_track", input_h=128, input_w=128, max_tracks=8)
    jcfg = jax_preset("centerpose_track", input_h=128, input_w=128, max_tracks=8)
    tracks = tracked + [dict(tracked[0], kps_heatmap_std=np.full(16, -10000.0))]
    got = render.render_inputs(tracks, META, cfg)
    ref = jax_render.render_inputs(tracks, META, jcfg)
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0][3].sum() == len(tracks)                 # every track drew its center
    assert got[1][3][:, -1].sum() == 0                     # the missing heatmaps drew no joint


def test_render_maps_match_jax(tracked):
    """The center map and the 8 keypoint maps, 128x128, atol 1e-6."""
    cfg = preset("centerpose_track", input_h=128, input_w=128)
    hm_p, hp_p = render.render_inputs(tracked, META, cfg)
    hm, hm_hp = render.render_maps(hm_p, hp_p, 128, 128, device="cpu")
    ref_hm, ref_hp = jax_render._render_maps(
        tuple(jnp.asarray(a) for a in hm_p), tuple(jnp.asarray(a) for a in hp_p), h=128, w=128)
    assert hm.shape == (1, 1, 128, 128) and hm_hp.shape == (1, 8, 128, 128)
    assert hm.dtype == torch.float32 and float(hm.max()) > 0.5 and float(hm_hp.max()) > 0.1
    np.testing.assert_allclose(hm.permute(0, 2, 3, 1).numpy(), np.asarray(ref_hm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(hm_hp.permute(0, 2, 3, 1).numpy(), np.asarray(ref_hp), atol=1e-6, rtol=0)
    pre_hm, pre_hp = render.render_previous_heatmaps(tracked, META, cfg, device="cpu")
    assert pre_hm.shape == (1, 128, 128, 1) and pre_hp.shape == (1, 128, 128, 8)
    assert torch.equal(pre_hp, hm_hp.permute(0, 2, 3, 1))
    empty = render.render_previous_heatmaps([], META, cfg, device="cpu")
    assert float(empty[0].max()) == 0.0 and float(empty[1].max()) == 0.0
