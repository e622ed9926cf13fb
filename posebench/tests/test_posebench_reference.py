"""The plain reference agrees with the port's path at a tiny size on the
CPU, in float32: the network, the serving pipeline from uint8 frames to
poses (and the count of boxes that reached PnP, which feeds
`boxes_per_image.serve`), and the first training steps."""


import numpy as np
import pytest
import torch

from posebench import inputs, weights
from posebench.drivers import serve, train
from posebench.reference import net as refnet
from posebench.reference import serve as refserve
from posebench.reference import train as reftrain
from posebench.tests.conftest import TINY_SEED, tiny_cell


@pytest.fixture(scope="module")
def serve_cell():
    cell = tiny_cell("serve_b64.dlav1_34")
    # float32 on both sides, and a threshold that lets boxes through the
    # tiny network's heatmap
    cell.config.update(serve_dtype="float32")
    return cell


def test_network_matches_port(serve_cell):
    from centerpose_tpu_torch.models.convert import load_reference_state_dict
    from centerpose_tpu_torch.models.factory import create_model

    spec = refnet.spec_of(serve_cell.config)
    state = weights.make_state(spec, TINY_SEED, "cpu", 80, 16, serve_cell.traffic["box_px"])
    port = create_model(serve.detector_config(serve_cell), "cpu")
    load_reference_state_dict(port, state)
    ref = refnet.build(spec, "cpu", state)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert list(a) == list(b)
    for k in a:
        assert torch.allclose(a[k], b[k], rtol=2e-4, atol=2e-4), k   # the repo's DCN-arch tolerance


def test_serving_matches_port_and_counts_boxes_alike(serve_cell):
    from centerpose_tpu_torch.inference.detector import Detector

    c, t = serve_cell.config, serve_cell.traffic
    spec = refnet.spec_of(c)
    state = weights.make_state(spec, TINY_SEED, "cpu", 80, 16, t["box_px"])
    det = Detector(serve.detector_config(serve_cell), state_dict=state, device="cpu")
    frames = inputs.smooth_frames(TINY_SEED, 8, t["frame_hw"], t["low_hw"], "cpu")
    outs = det.run_batch(list(frames))
    ref = refserve.detect(refnet.build(spec, "cpu", state), frames, serve.reference_params(serve_cell), "cpu")
    # the serve driver's count of boxes that reached PnP, image by image
    assert [len(o["results"]) for o in outs] == [len(r.boxes) for r in ref]
    assert sum(len(r.boxes) for r in ref) > 0
    prog = [serve.boxes_of_output(o) for o in outs]
    numbers = serve.checks.compare_boxes(prog, ref, t["vis_thresh"], 0.1, t["frame_hw"], 16, "cpu")
    assert numbers["missing_boxes"] == 0
    assert numbers["score_gap"] < 1e-4 and numbers["choice_gap"] < 1e-4 and numbers["scale_gap"] < 1e-4
    assert numbers["kps_gap_px"] < 1e-2 and numbers["pose_gap_px"] < 1e-2


def test_warp_matches_port():
    from centerpose_tpu_torch.geometry.affine import get_affine_transform
    from centerpose_tpu_torch.ops.resample import warp_axis_aligned_batch

    frames = inputs.smooth_frames(5, 3, (60, 80), (8, 10), "cpu")
    inv = get_affine_transform(np.array([40.0, 30.0]), 80.0, 0, (64, 64), inv=True).astype(np.float32)
    port = warp_axis_aligned_batch(torch.from_numpy(frames), torch.from_numpy(np.stack([inv] * 3)), 64, 64)
    ref = refserve.warp(torch.from_numpy(frames), 64)
    assert torch.allclose(port, ref, atol=1e-4)


def test_training_steps_match_port():
    cell = tiny_cell("train_b32.dlav1_34")
    c, t = cell.config, cell.traffic
    spec = refnet.spec_of(c)
    state = weights.make_state(spec, TINY_SEED, "cpu", 64, 16, t["box_px"])
    batches = reftrain.make_batches(TINY_SEED, 1, 4, (64, 64), 4, t["low_hw"], "cpu")
    model, tx, st, step = train.port_step(cell, state, torch.device("cpu"))
    st, stats = step(st, batches[0])
    names = {p: n for n, p in model.named_parameters()}
    grad = train.leaf_norms({names[p]: tx.adam.state[p]["exp_avg"] / 0.1 for p in tx.params})
    terms = {n: float(v) for n, v in stats.items() if n.endswith("_loss")}
    ref = train.reference_readings(cell, state, batches, "cpu")
    numbers = train.numbers_of(([float(stats["loss"])], terms, grad, ref[3]), ref)
    assert numbers["loss1_gap"] < 1e-5 and numbers["term1_gap"] < 1e-4
    # the worst leaf: early BatchNorm gradients, sums with much cancellation,
    # differ by summation order (on the card in float32: 0.5-1.2 %)
    assert numbers["grad_gap"] < 0.03 and numbers["grad_gap_median"] < 1e-3
