"""The PyTorch package's CenterPoseTrack training path against the JAX package's,
on the CPU.

`data/dataset.py`'s tracking branch (the previous frame, its noisy
heatmaps, the tracking targets; the detector-in-the-loop previous frame;
the pairing with the kept annotations) gives the JAX dataset's samples bit
for bit from one seed, on both wires (the compact one with the port's
documented 255 -> 254 exception). The dla_34 tracking model's train step
and eval step, on a batch of the port's tracking dataset, against the JAX
trainer's loss, gradients (the previous-frame stems and the tracking heads
among them) and Adam update. `train.py --tracking_task` and `evaluate.py
--mode loss --tracking` with `--device cpu`.

The JAX tracking model's variables come from `jax.eval_shape` and numpy
draws (`test_torch_port_video.py::jax_track_model`: a real flax init takes
half a minute); its train loss, gradients and eval loss are one jitted
program. 64x64 inputs on 160x120 frames keep every sample and step cheap.
"""

import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from PIL import Image

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.data import dataset as jax_dataset
from centerpose_tpu.models import create_model as jax_create_model
from centerpose_tpu.training import trainer as jax_trainer
from centerpose_tpu.training.losses import centerpose_loss as jax_centerpose_loss
from centerpose_tpu_torch import evaluate, train
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import dataset
from centerpose_tpu_torch.data.synthetic import generate_dataset
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.convert import load_jax_variables, to_jax_tree
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training import trainer
from centerpose_tpu_torch.training.losses import centerpose_loss
from centerpose_tpu_torch.utils import checkpoint

from test_torch_port_resnet import release_memory
from test_torch_port_video import jax_track_model

RES = 64
FRAME = (160, 120)
BATCH = 2
STEPS_PER_EPOCH = 7
STEMS = ("base.pre_img_layer.", "base.pre_hm_layer.", "base.pre_hm_hp_layer.")
TRACK_HEADS = ("tracking.", "tracking_hp.")
UNCERTAINTY_HEADS = ("hps_uncertainty.", "scale_uncertainty.")      # the tracking preset's too


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (small eager convolutions gain nothing from a
    pool, and under the suite's parallel workers pools oversubscribe the
    cores); this file's memory handed back at its end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """2 videos x 3 frames of 160x120; each object keeps its name through
    its video, which is what pairs it with the previous frame."""
    root = str(tmp_path_factory.mktemp("track_frames"))
    generate_dataset(root, n_videos=2, frames_per_video=3, seed=4, width=FRAME[0], height=FRAME[1])
    return root


@pytest.fixture(scope="module")
def big_frames(frames, tmp_path_factory):
    """The same frames with every cuboid blown up 3x about the image centre:
    previous-frame boxes of ~200 px at 256x256 inputs, whose gaussians
    (radius ~55) have shoulders above 254.5/255 next to their peak."""
    root = str(tmp_path_factory.mktemp("track_big"))
    shutil.rmtree(root)
    shutil.copytree(frames, root)
    centre = np.array(FRAME, np.float64) / 2
    for dirpath, _, files in os.walk(root):
        for path in (os.path.join(dirpath, n) for n in files if n.endswith(".json")):
            with open(path) as fh:
                ann = json.load(fh)
            for obj in ann["objects"]:
                pts = np.asarray(obj["projected_cuboid"], np.float64)
                obj["projected_cuboid"] = (centre + 3.0 * (pts - centre)).tolist()
            with open(path, "w") as fh:
                json.dump(ann, fh)
    return root


def _pair(root, split, category="shoe", res=RES, seed=5, **kw):
    over = dict(input_h=res, input_w=res, category=category)
    port = dataset.ObjectPoseDataset(root, preset("centerpose_track", **over), split=split, seed=seed, **kw)
    ref = jax_dataset.ObjectPoseDataset(root, jax_preset("centerpose_track", **over), split=split,
                                        seed=seed, **kw)
    return port, ref


def _same(got, ref, where):
    assert list(got) == list(ref), where
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (where, k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{where}: {k}")


# ------------------------------------------------------------------ dataset
@pytest.mark.parametrize("category", ["shoe", "bottle"])       # bottle: 12 symmetry copies
@pytest.mark.parametrize("split", ["train", "val"])
def test_tracking_samples_match_on_the_f32_wire(frames, split, category):
    """Every sample of both tracking datasets, in order, from one seed: the
    train split draws the current frame's augmentation, the previous frame's
    shift and scale and every noise draw of its heatmaps from one stream, so
    a draw out of place would shift every later sample. Every key the same
    dtype, shape and values."""
    port, ref = _pair(frames, split, category)
    assert port.videos == ref.videos and len(port) == 6
    tracked = heat = 0
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert (got is None) == (want is None)
        _same(got, want, f"{split} sample {i}")
        assert {"pre_img", "pre_hm", "pre_hm_hp", "tracking", "tracking_hp"} <= set(got)
        assert got["pre_img"].dtype == got["pre_hm"].dtype == np.float32
        tracked += int(want["tracking_mask"].sum() > 0)
        heat += int(want["pre_hm"].max() > 0)
    assert tracked >= 3 and heat >= 3
    if category == "bottle":
        assert want["tracking"].shape[0] == 12


@pytest.mark.parametrize("which", ["frames", "big_frames"])
def test_tracking_compact_wire_differs_only_where_documented(which, request):
    """The compact wire: uint8 images (`pre_img` back to raw, the exact
    inverse of its normalisation) and heatmaps. Equal to the JAX package's,
    key for key, except where the JAX encoding rounds a `pre_hm` /
    `pre_hm_hp` (or `hm` / `hm_hp`) value below 1 to 255: there the port has
    254. On the blown-up cuboids at 256x256 such shoulders exist."""
    root = request.getfixturevalue(which)
    res = RES if which == "frames" else 256
    exceptions = 0
    for split in ("train", "val"):
        port, ref = _pair(root, split, res=res, compact_wire=True)
        port_f32, _ = _pair(root, split, res=res)
        for i in range(len(ref)):
            got, want, f32 = port[i], ref[i], port_f32[i]
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                if k in ("hm", "hm_hp", "pre_hm", "pre_hm_hp"):
                    assert got[k].dtype == np.uint8
                    shoulder = (f32[k] < 1.0) & (want[k] == 255)
                    assert (got[k][shoulder] == 254).all(), k
                    np.testing.assert_array_equal(got[k][~shoulder], want[k][~shoulder], err_msg=k)
                    np.testing.assert_array_equal(got[k], dataset.encode_heatmap(f32[k]), err_msg=k)
                    exceptions += int(shoulder.sum())
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split} {i}: {k}")
            assert got["pre_img"].dtype == np.uint8 and got["pre_img"].max() > 0
    if which == "big_frames":
        assert exceptions > 0
    else:
        assert exceptions == 0


class StubDetector:
    """Fixed PnP-surviving boxes whatever the frame (the `boxes` quintuple of
    `Detector.run`: normalised projected cuboid first, the detection's dict
    last), built from one object of the first frame; records the frames it
    was given."""

    def __init__(self, root):
        with open(os.path.join(root, "video_0", "000000.json")) as fh:
            ann = json.load(fh)
        size = np.array(FRAME, np.float64)
        self.boxes = []
        for shift, score, kps in ((0.0, 0.8, np.ones(8)), (30.0, 0.4, np.r_[np.zeros(2), np.ones(6)]),
                                  (-200.0, 0.6, np.ones(8))):         # the last one off the image
            pts = np.asarray(ann["objects"][0]["projected_cuboid"], np.float64)[:9] + shift
            det = {"bbox": np.r_[pts[1:].min(0), pts[1:].max(0)], "score": score,
                   "kps_heatmap_height": kps}
            self.boxes.append((pts / size, None, None, None, det))
        self.seen = []

    def run(self, image, meta=None):
        self.seen.append(np.array(image))
        assert meta is not None and meta["camera_matrix"].shape == (3, 3)
        return {"boxes": self.boxes}


def test_detector_branch_matches_with_a_stub_detector(frames):
    """`data_generation_mode_ratio` 0.5 with one stub detector given to both
    packages: the ratio draw is made only when a detector is set, and the
    detector's branch draws nothing, so both branches interleave in one
    stream. The train split's samples are the same bits, a flipped frame
    among those the detector saw (its boxes matched against the flipped,
    index-swapped cuboids)."""
    stub = StubDetector(frames)
    port, ref = _pair(frames, "train", seed=3, detector=stub, data_generation_mode_ratio=0.5)
    raw = {}
    for path, *_ in port.samples:
        raw[path] = np.asarray(Image.open(path).convert("RGB"))
    for i in range(len(ref)):
        n = len(stub.seen)
        want = ref[i]
        n_ref = len(stub.seen) - n
        got = port[i]
        assert len(stub.seen) - n == 2 * n_ref
        for a, b in zip(stub.seen[n:n + n_ref], stub.seen[n + n_ref:]):
            np.testing.assert_array_equal(a, b)
        _same(got, want, f"sample {i}")
    assert 0 < len(stub.seen) < 2 * len(ref)                   # both branches ran
    flipped = [any(np.array_equal(img, r[:, ::-1]) for r in raw.values()) for img in stub.seen]
    assert any(flipped)


def test_detector_branch_through_the_port_detector(frames):
    """The port's own `Detector` on the CPU (random weights, vis_thresh 0,
    the box head's bias set so that boxes have an object's size) in the
    loop: its PnP-surviving boxes put heat into `pre_hm`."""
    det = Detector(preset("centerpose", input_h=RES, input_w=RES, K=8, vis_thresh=0.0), device="cpu")
    with torch.no_grad():
        det.model.wh[-1].bias.fill_(12.0)
    ds = dataset.ObjectPoseDataset(frames, preset("centerpose_track", input_h=RES, input_w=RES),
                                   split="val", detector=det, data_generation_mode_ratio=1.0)
    item = ds[0]
    assert item["pre_hm"].shape == (RES, RES, 1) and item["pre_hm"].max() > 0
    assert item["pre_hm"].max() <= 1.0


def test_filtered_annotation_keeps_the_tracking_pairing(frames, tmp_path):
    """`tests/test_dataset.py::test_filtered_annotation_does_not_shift_tracking_pairing`
    against the JAX dataset: an annotation without a scale is filtered
    before the first kept one; the tracking targets still pair with the kept
    objects (small offsets), the same bits as the JAX package's."""
    root = str(tmp_path / "filtered")
    shutil.copytree(frames, root)
    for i in range(2):
        path = os.path.join(root, "video_0", f"{i:06d}.json")
        with open(path) as fh:
            ann = json.load(fh)
        bad = dict(ann["objects"][0])
        bad.pop("scale")
        bad["name"] = "shoe_bad"
        bad["projected_cuboid"] = (np.asarray(ann["objects"][0]["projected_cuboid"]) + 150.0).tolist()
        ann["objects"] = [bad, ann["objects"][0]]
        with open(path, "w") as fh:
            json.dump(ann, fh)
    quiet = dict(hm_disturb=0.0, lost_disturb=0.0, fp_disturb=0.0, hp_lost_disturb=0.0)
    port, ref = _pair(root, "val", **quiet)
    for i in range(len(ref)):
        _same(port[i], ref[i], f"sample {i}")
    item = port[0]
    tm = item["tracking_mask"][0]
    assert tm.sum() > 0 and np.abs(item["tracking"][0][tm > 0]).max() < 2.5


# ---------------------------------------------------------- train and eval steps
class TrackPair:
    """The two packages' dla_34 tracking models with the same weights; one
    batch of 2 from the port's tracking dataset (compact wire, decoded by each
    trainer's `decode_wire`); the JAX trainer's loss, gradients (batch and
    running statistics), Adam update and eval loss in one jitted program."""

    def __init__(self, frames):
        over = dict(input_h=RES, input_w=RES, batch_size=BATCH)
        self.jcfg = jax_preset("centerpose_track", dcn_impl="gather", dcn_bwd="autodiff",
                               remat_dcn=False, remat_stem=False, **over)
        self.tcfg = preset("centerpose_track", **over)
        _, self.variables = jax_track_model(RES, seed=5)
        self.jmodel = jax_create_model(self.jcfg)
        ds = dataset.ObjectPoseDataset(frames, self.tcfg, split="train", seed=2, compact_wire=True)
        items = [ds[i] for i in (1, 4)]
        for item in items:
            item.pop("meta")
        self.batch = dataset.collate_filtered(items)
        assert self.batch["pre_img"].dtype == np.uint8 and self.batch["tracking_mask"].sum() > 0
        assert self.batch["pre_hm"].max() > 0 and self.batch["tracking_hp_mask"].sum() > 0

        jmodel, loss_cfg = self.jmodel, jax_trainer.loss_config_from(self.jcfg)
        tx = jax_trainer.make_optimizer(self.jcfg, STEPS_PER_EPOCH)

        @jax.jit
        def programme(params, bstats, batch):
            batch = jax_trainer.decode_wire(batch)
            pre = dict(pre_img=batch["pre_img"], pre_hm=batch["pre_hm"], pre_hm_hp=batch["pre_hm_hp"])

            def train_loss(params):
                outputs, mutated = jmodel.apply({"params": params, "batch_stats": bstats}, batch["input"],
                                                train=True, mutable=["batch_stats"], **pre)
                loss, stats, _ = jax_centerpose_loss(outputs, batch, loss_cfg, "train")
                return loss, (stats, mutated["batch_stats"])

            def running_loss(params):
                outputs = jmodel.apply({"params": params, "batch_stats": bstats}, batch["input"],
                                       train=False, **pre)
                return jax_centerpose_loss(outputs, batch, loss_cfg, "train")[0]

            (_, (stats, new_bs)), grads = jax.value_and_grad(train_loss, has_aux=True)(params)
            run_loss, run_grads = jax.value_and_grad(running_loss)(params)
            outputs = jmodel.apply({"params": params, "batch_stats": bstats}, batch["input"],
                                   train=False, **pre)
            eval_stats = jax_centerpose_loss(outputs, batch, loss_cfg, "val")[1]
            updates, _ = tx.update(grads, tx.init(params), params)
            return (stats, new_bs, grads, optax.global_norm(grads), run_loss, run_grads, eval_stats,
                    optax.apply_updates(params, updates))

        params = jax.tree_util.tree_map(jnp.asarray, self.variables["params"])
        bstats = jax.tree_util.tree_map(jnp.asarray, self.variables["batch_stats"])
        out = programme(params, bstats, {k: jnp.asarray(v) for k, v in self.batch.items()})
        (self.jstats, self.jnew_bs, self.jgrads, jnorm, self.jrun_loss, self.jrun_grads,
         self.jeval_stats, self.jnew_params) = jax.device_get(out)
        self.jnorm = float(jnorm)

        # --- the port: eval step, running-statistics gradients, train step ---
        self.model = create_model(self.tcfg, device="cpu")
        load_jax_variables(self.model, self.variables)
        state, tx_t = trainer.create_train_state(self.tcfg, self.model, STEPS_PER_EPOCH)
        self.eval_stats = trainer.make_eval_step(self.tcfg, self.model)(state, self.batch)
        decoded = trainer.decode_wire({k: torch.from_numpy(v) for k, v in self.batch.items()})
        self.model.eval()
        outputs = self.model(decoded["input"], pre_img=decoded["pre_img"], pre_hm=decoded["pre_hm"],
                             pre_hm_hp=decoded["pre_hm_hp"])
        self.run_loss = centerpose_loss(outputs, decoded, trainer.loss_config_from(self.tcfg), "train")[0]
        self.run_loss.backward()
        self.run_grads = {k: p.grad for k, p in self.model.named_parameters()}
        self.before = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        self.state, self.stats = trainer.make_train_step(self.tcfg, self.model, tx_t)(state, self.batch)
        self.tx = tx_t


@pytest.fixture(scope="module")
def pair(frames):
    return TrackPair(frames)


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_track_train_step_loss_and_stats(pair):
    """The train step's loss and every stat, `tracking_loss` and
    `tracking_hp_loss` among them: rtol = atol = 1e-4."""
    assert pair.state.step == 1 and pair.tx.count == 1
    assert set(pair.stats) == set(pair.jstats)
    assert {"tracking_loss", "tracking_hp_loss"} <= set(pair.stats)
    for k, ref in pair.jstats.items():
        np.testing.assert_allclose(pair.stats[k].item(), float(ref), rtol=1e-4, atol=1e-4, err_msg=k)
    assert pair.stats["tracking_loss"].item() > 0 and pair.stats["tracking_hp_loss"].item() > 0


def test_track_gradients_with_running_statistics(pair):
    """Every parameter's gradient of the train-phase loss, BatchNorm on its
    running statistics, against the JAX gradient: rtol 1e-3, atol 2e-4 of
    the leaf's largest magnitude. The three previous-frame stems and the two
    tracking heads are among the leaves, and their gradients are not zero."""
    np.testing.assert_allclose(pair.run_loss.item(), float(pair.jrun_loss), rtol=1e-5)
    named = {k: (torch.zeros_like(pair.before[k]) if g is None else g) for k, g in pair.run_grads.items()}
    got = to_jax_tree(named, {"params": pair.variables["params"]})["params"]
    ref_leaves, got_leaves = leaves(pair.jrun_grads), leaves(got)
    assert len(ref_leaves) == len(got_leaves) == len(named)
    for (path, r), (_, g) in zip(ref_leaves, got_leaves):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=2e-4 * scale + 1e-9, err_msg=str(path))
    for prefix in STEMS + TRACK_HEADS:
        grads = [g for k, g in pair.run_grads.items() if k.startswith(prefix) and g is not None]
        assert grads and max(float(g.abs().max()) for g in grads) > 0, prefix


def test_track_train_step_updated_parameters(pair):
    """Every parameter after the step's clip + Adam: where the two packages'
    batch-statistics gradients have the same sign and stand clear of 1e-5,
    the parameters agree to 1e-6 (the first Adam step moves a weight by lr in
    its gradient's sign); most of them do, and everywhere both stay within
    one step of the old value. The stems and tracking heads moved."""
    lr = pair.tcfg.lr
    named = dict(pair.model.named_parameters())
    like = {"params": pair.variables["params"]}
    got = to_jax_tree(named, like)["params"]
    got_g = to_jax_tree({k: p.grad for k, p in named.items()}, like)["params"]
    scale = min(1.0, 100.0 / pair.jnorm)
    n_held = n_all = 0
    for (path, r), (_, g), (_, o), (_, jg), (_, tg) in zip(
            leaves(pair.jnew_params), leaves(got), leaves(pair.variables["params"]),
            leaves(pair.jgrads), leaves(got_g)):
        r, jg = np.asarray(r), np.asarray(jg) * scale
        same = (np.sign(jg) == np.sign(tg)) & (np.abs(jg) > 1e-5) & (np.abs(tg) > 1e-5)
        np.testing.assert_allclose(g[same], r[same], atol=1e-6, rtol=0, err_msg=str(path))
        assert np.abs(g - o).max() <= lr * 1.001 and np.abs(r - o).max() <= lr * 1.001, path
        n_held += int(same.sum())
        n_all += same.size
    assert n_held > 0.8 * n_all, (n_held, n_all)
    for prefix in STEMS + TRACK_HEADS:
        moved = max(float((p.detach() - pair.before[k]).abs().max())
                    for k, p in named.items() if k.startswith(prefix))
        assert 0.99 * lr < moved <= 1.001 * lr, prefix


def test_track_train_step_running_stats(pair):
    """The BatchNorm running means after the step, the stems' included,
    against the JAX package's (the variances differ by the libraries'
    n / (n - 1), held in `test_torch_port_training.py`)."""
    buffers = dict(pair.model.named_buffers())
    got = to_jax_tree(buffers, {"batch_stats": pair.variables["batch_stats"]})["batch_stats"]
    n = 0
    for (path, r), (_, g) in zip(leaves(pair.jnew_bs), leaves(got)):
        if path[-1].key == "mean":
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=str(path))
            n += 1
    means = [k for k in buffers if k.endswith("running_mean")]
    assert n == len(means) and any(k.startswith(STEMS) for k in means)


def test_track_eval_step_stats(pair):
    """`make_eval_step` (running statistics, val-phase loss) on the weights
    before the step, against the JAX eval loss: every stat at 1e-4."""
    assert set(pair.eval_stats) == set(pair.jeval_stats)
    for k, ref in pair.jeval_stats.items():
        np.testing.assert_allclose(pair.eval_stats[k].item(), float(ref), rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------- CLIs
def _argv(data, *extra):
    return ["--data_dir", data, "--device", "cpu", "--input_res", str(RES), "--num_workers", "0",
            "--num_epochs", "1", *extra]


def test_train_cli_tracking_task_and_loss_mode(frames, tmp_path, monkeypatch):
    """`train.py --tracking_task` (dla_34 whatever `--arch`) for one step of 4
    samples from a dla_34 image-model checkpoint (`--load_model`: the trunk,
    neck and shared heads load by name and shape; the 3 stems', the 2
    tracking heads' and the 2 uncertainty heads' tensors keep their init),
    validated and checkpointed;
    then `evaluate.py --mode loss --tracking` on its checkpoint equals the
    port's `eval_fn` over the same val split with the same weights."""
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    generate_dataset(data, n_videos=2, frames_per_video=2, seed=8, width=FRAME[0], height=FRAME[1])
    train.main(_argv(data, "--arch", "dla_34", "--batch_size", "4", "--val_intervals", "0",
                     "--save_intervals", "0", "--exp_id", "image"))
    image_ckpt = os.path.join("exp", "dla_34", "image", "ckpt")
    out = train.main(_argv(data, "--tracking_task", "--arch", "res_18", "--batch_size", "4",
                           "--val_intervals", "1", "--save_intervals", "1", "--exp_id", "track",
                           "--load_model", image_ckpt))
    assert out["exp_dir"] == os.path.join("exp", "dla_34", "track") and out["step"] == 1
    epoch = out["epochs"][0]
    for phase in ("train", "val"):
        assert np.isfinite(epoch[phase]["loss"]), phase
        assert epoch[phase]["tracking_loss"] > 0 and epoch[phase]["tracking_hp_loss"] > 0, phase
    exp = tmp_path / "exp" / "dla_34" / "track"
    for sub in ("ckpt", "best", "epoch_1"):
        assert checkpoint.latest_step(str(exp / sub)) == 1, sub

    cfg = preset("centerpose_track", input_h=RES, input_w=RES)
    model = create_model(cfg, device="cpu")
    image = create_model(preset("centerpose", arch="dla_34", input_h=RES, input_w=RES), device="cpu")
    new = [k for k in model.state_dict() if k not in image.state_dict()]
    assert new and all(k.startswith(STEMS + TRACK_HEADS + UNCERTAINTY_HEADS) for k in new)
    log = (exp / "log.txt").read_text()
    assert f"partial-init from {image_ckpt}: {len(model.state_dict()) - len(new)} tensors loaded, " \
           f"{len(new)} kept at init" in log
    saved = torch.load(exp / "ckpt" / "1" / "checkpoint.pt", weights_only=True)
    assert saved["metadata"]["config"]["tracking_task"] and saved["metadata"]["config"]["arch"] == "dla_34"

    ckpt = str(exp / "ckpt")
    got = evaluate.main(["--mode", "loss", "--tracking", "--device", "cpu", "--data_dir", data,
                         "--input_res", str(RES), "--load_model", ckpt])["runs"]
    assert len(got) == 1 and got[0]["step"] == 1 and got[0]["samples"] == 4
    state, _ = trainer.create_train_state(cfg, model)
    checkpoint.load_checkpoint(ckpt, state)
    ds = dataset.ObjectPoseDataset(data, cfg, split="val")
    items = [ds[i] for i in range(len(ds))]
    for item in items:
        item.pop("meta")
    batch = dataset.collate_filtered(items)
    want = trainer.make_eval_step(cfg, model)(state, batch)
    assert set(got[0]["losses"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[0]["losses"][k], v.item(), rtol=1e-6, atol=1e-7, err_msg=k)

    # --compute_dtype bfloat16: float32 parameters from the checkpoint, the
    # eval step under autocast (it raised before: a bf16 model has no train state).
    got = evaluate.main(["--mode", "loss", "--tracking", "--device", "cpu", "--data_dir", data,
                         "--input_res", str(RES), "--load_model", ckpt, "--compute_dtype", "bfloat16"])
    want = trainer.make_eval_step(cfg.replace(compute_dtype="bfloat16"), model)(state, batch)
    for k, v in want.items():
        np.testing.assert_allclose(got["runs"][0]["losses"][k], v.item(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_tracking_command_lines_default_to_cuda(frames, tmp_path, monkeypatch):
    """Both tracking command lines default to `--device cuda` and raise when
    asked for a GPU that is not there."""
    monkeypatch.chdir(tmp_path)
    assert train.parse_args(["--data_dir", frames, "--tracking_task"]).device == "cuda"
    assert evaluate.parse_args(["--data_dir", frames, "--mode", "loss", "--tracking"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--data_dir", frames, "--tracking_task"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--data_dir", frames, "--mode", "loss", "--tracking"])
