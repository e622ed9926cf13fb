"""The PyTorch package's evaluation drivers and its `evaluate.py` twin, on the
CPU, against the JAX package's.

* The drivers: `evaluate_dataset` and `evaluate_tfrecords` of both packages
  on one tiny generated set (2 videos x 3 frames of 160x120, the same files
  for both; tfrecords packed by `scripts/synth_to_tfrecords.py`), each driven
  by the same stub detector. The stub returns pnp_shell quintuples planted
  from each frame's ground truth and records every call: the image and the
  camera matrix `run` was given, the tracker seeds (`pre_dets`), where
  `reset_tracking` fell, the `run_pnp` calls of `--eval_gt_scale`. Reports
  equal to 1e-12 and the recorded calls equal: image and video mode, the
  ablations (GT seeds, noisy seeds, fake output, CenterPose initialisation),
  gt_scale, MobilePose lifting, and the cup/mug routing with relabel lists.
* The CLI end to end, `main([..., "--device", "cpu"])` with res_18 at 64x64:
  its `--report_json` against the JAX CLI's on the same weights (the port
  writes a `.pth` of reference names, which the JAX CLI reads through
  `load_pth`), at the preset's vis_thresh of 0.3. Random weights give no
  detection above it in either package, so this covers the data walk, the
  ground truth, the counts and the report, not the matching: the poses of
  random weights are ill-posed PnP problems whose mirror minima the two
  solvers pick differently (ROADMAP.md, queue C), so pose-dependent AP
  parity waits for trained weights; the drivers above hold the matching.
  `--eval_continue` skips finished videos and merges them; `--n_proc 2`
  passes `--eval_gt_scale` and the cup/mug settings to its workers (where
  the JAX CLI's workers drop them); `--data_dir` and the same frames as
  tfrecords give one report; the options the `--data_dir` driver does not
  run, and `--data_dir --n_proc 2` without `--eval_continue`, are refused;
  the package's tfrecord packer writes the script's bytes; `--mode loss` (and
  `--all_checkpoints`) equals the JAX package's `make_eval_step` on the same
  weights and batches, the tail partial batch included, to 1e-4 relative.
* The repaired fault: `demo.py` and `evaluate.py` load a checkpoint
  directory that the port's `train.py` wrote (the demo called `torch.load`
  on the directory), and give what the same weights give as a state dict.
"""

import ctypes
import gc
import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.evaluation import evaluator as jax_ev
from centerpose_tpu.training import trainer as jax_trainer
from centerpose_tpu_torch import demo, evaluate
from centerpose_tpu_torch import train as train_cli
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data.dataset import ObjectPoseDataset, collate_filtered
from centerpose_tpu_torch.data.synthetic import generate_dataset
from centerpose_tpu_torch.data.tfrecord import pack_dope_dataset
from centerpose_tpu_torch.evaluation import evaluator
from centerpose_tpu_torch.evaluation.relabel import RelabelLists
from centerpose_tpu_torch.geometry.cuboid import cuboid_vertices
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training.trainer import create_train_state
from centerpose_tpu_torch.utils.checkpoint import latest_step, save_checkpoint
from tests.test_torch_port_evaluation import assert_same
from tests.test_torch_port_resnet import jax_config, jax_model_and_variables, port_from_jax

REPO = Path(__file__).resolve().parents[1]
RES = 64
ARCH = ["--arch", "res_18", "--input_res", str(RES), "--device", "cpu"]


def release_memory():
    """Hand this file's memory back before the worker's next file: JAX's
    compiled programs, then the heap pages glibc keeps after frees."""
    gc.collect()
    jax.clear_caches()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):          # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the 64x64 networks gain nothing from a pool,
    and under the suite's parallel workers pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """2 videos x 3 frames of 160x120 (camera orbiting fixed objects), as a
    DOPE tree and as one tfrecord per video, for category 'cup' too."""
    root = tmp_path_factory.mktemp("eval_data")
    frames = root / "frames"
    generate_dataset(str(frames), n_videos=2, frames_per_video=3, seed=5, width=160,
                     height=120, video_motion=True)
    pack = _load_script("synth_to_tfrecords", REPO / "scripts" / "synth_to_tfrecords.py")
    for category in ("shoe", "cup"):
        (root / category).mkdir()
        for vid in ("video_0", "video_1"):
            pack.convert_video(str(frames / vid), str(root / category / f"{vid}.tfrecord"), category)
    return root


# ----------------------------------------------------------------- drivers
def _plain(obj):
    """A recorded value as nested lists / dicts of floats."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.astype(np.float64).tolist()
    return obj


def _image_key(image):
    return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()[:12]


def _ground_truth(frames):
    """{image key: [GT instances]} over every frame of the DOPE tree."""
    from PIL import Image

    out = {}
    for png in sorted(frames.rglob("*.png")):
        instances, _, _ = evaluator.parse_gt_json(str(png.with_suffix(".json")))
        out[_image_key(np.asarray(Image.open(png).convert("RGB")))] = instances
    return out


class StubDetector:
    """Stands in for either package's `Detector`: `run` returns quintuples
    planted from the frame's ground truth (found by the image's bytes), one
    exact, one off by a few pixels, one wrong in scale; `run_pnp` rebuilds a
    detection's box at the scale it is given. Every call is recorded."""

    def __init__(self, gt, offset=0.0):
        self.gt, self.offset, self.calls = gt, offset, []

    def run(self, image, meta=None):
        key = _image_key(image)
        self.calls.append(("run", key, _plain(meta)))
        h, w = image.shape[:2]
        boxes = []
        for j, g in enumerate(self.gt[key]):
            scale = g.scale * ([1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.3, 1.0, 0.8])[j % 3]
            pts = np.vstack([g.translation[None], cuboid_vertices(scale) @ g.rotation.T + g.translation])
            kps9 = g.kps_2d_norm + self.offset + 0.004 * (j % 3 == 1)
            det = {"score": 0.9 - 0.2 * j - self.offset, "obj_scale": scale / scale[1],
                   "kps": (kps9[1:] * [w, h]).reshape(-1),
                   "pose": (g.rotation, g.translation, g.scale[1])}
            boxes.append((kps9.copy(), pts * 0.5, scale / scale[1], kps9, det))
        return {"boxes": boxes}

    def run_pnp(self, dets, meta):
        self.calls.append(("run_pnp", [_plain(d["obj_scale"]) for d in dets], _plain(meta)))
        cam = meta["camera_matrix"]
        out = []
        for det in dets:
            r, t, height = det["pose"]
            pts = np.vstack([t[None], cuboid_vertices(det["obj_scale"] * height) @ r.T + t])
            z = -pts[:, 2]
            proj = np.stack([(cam[0, 0] * pts[:, 0] / z + cam[0, 2]) / meta["width"],
                             (-cam[1, 1] * pts[:, 1] / z + cam[1, 2]) / meta["height"]], -1)
            out.append((proj, pts * 0.5, det["obj_scale"], proj, det))
        return out

    def reset_tracking(self):
        self.calls.append(("reset_tracking",))


def _drive(module, gt, source, category, kwargs):
    """One driver of `module` with fresh stubs: (report_dict, calls)."""
    kwargs = dict(kwargs)
    stubs = {"detector": StubDetector(gt)}
    for name in ("init_detector", "detector_mug"):
        if kwargs.pop(name, False):
            stubs[name] = StubDetector(gt, offset=0.01 if name == "detector_mug" else 0.02)
    if "ablation" in kwargs:
        kwargs["ablation"] = module.EvalAblation(**kwargs["ablation"])
    cfg = (jax_preset if module is jax_ev else preset)("centerpose", category=category)
    main = stubs.pop("detector")
    if isinstance(source, list):
        ev = module.evaluate_tfrecords(main, source, cfg, **stubs, **kwargs)
    else:
        ev = module.evaluate_dataset(main, source, cfg, **kwargs)
    calls = {"detector": main.calls, **{k: s.calls for k, s in stubs.items()}}
    return ev.report_dict(), calls


DATASET_CASES = {
    "image": {},
    "video": {"is_video": True},
    "gt_scale": {"gt_scale": True},
    "mobilepose": {"mobilepose_postprocess": True, "is_video": True},
    "filter": {"video_filter": ["video_1"], "max_images": 2, "eval_num_symmetry": 4},
}

TFRECORD_CASES = {
    "image": {},
    "video_gt_seed": {"is_video": True, "ablation": {"gt_pre_hm_first": True}},
    "video_noisy_seed": {"is_video": True, "ablation": {"gt_pre_hm_first": True, "add_noise": True}},
    "video_fake_output": {"is_video": True, "ablation": {"fake_output": True}},
    "video_centerpose_init": {"is_video": True, "init_detector": True,
                              "ablation": {"gt_pre_hm_first": True, "centerpose_init": True}},
    "gt_scale_mobilepose": {"gt_scale": True, "mobilepose_postprocess": True, "max_images": 4},
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_evaluate_dataset_matches_jax(data, case):
    gt = _ground_truth(data / "frames")
    got = _drive(evaluator, gt, str(data / "frames"), "shoe", DATASET_CASES[case])
    want = _drive(jax_ev, gt, str(data / "frames"), "shoe", DATASET_CASES[case])
    assert got[0]["num_pred"] > 0 and got[0]["families"]["iou3d"]["ap"] > 0
    assert_same(got, want)
    runs = [c for c in got[1]["detector"] if c[0] == "run"]
    assert len(runs) == (2 if case == "filter" else 6)
    assert (sum(c[0] == "reset_tracking" for c in got[1]["detector"])
            == (2 if DATASET_CASES[case].get("is_video") else 0))
    assert any(c[0] == "run_pnp" for c in got[1]["detector"]) == (case == "gt_scale")


@pytest.mark.parametrize("case", sorted(TFRECORD_CASES))
def test_evaluate_tfrecords_matches_jax(data, case):
    gt = _ground_truth(data / "frames")
    records = sorted(str(p) for p in (data / "shoe").glob("*.tfrecord"))
    got = _drive(evaluator, gt, records, "shoe", TFRECORD_CASES[case])
    want = _drive(jax_ev, gt, records, "shoe", TFRECORD_CASES[case])
    assert got[0]["num_gt"] > 0 and got[0]["num_pred"] > 0
    assert_same(got, want)
    runs = [c for c in got[1]["detector"] if c[0] == "run"]
    seeds = [c for c in runs if "pre_dets" in c[2]]
    if "ablation" in TFRECORD_CASES[case] and "fake_output" not in TFRECORD_CASES[case]["ablation"]:
        assert len(seeds) == 2                    # the first frame of each video
    if case == "video_fake_output":
        assert len(runs) == 2                     # later frames reuse the first frame's boxes
    if case == "video_centerpose_init":
        assert len(got[1]["init_detector"]) == 2


@pytest.mark.parametrize("mug_only", (None, True, False))
def test_cup_mug_routing_matches_jax(data, tmp_path, mug_only):
    """Category 'cup': each sample's GT relabelled by the hand lists (video_0's
    objects are cups, video_1's mugs, one of them left-handled) and routed to
    the cup or the mug detector; `mug_only` filters; mugs skip the symmetry
    sweep with `eval_mug_symmetric=False`."""
    gt = _ground_truth(data / "frames")
    (tmp_path / "cup").mkdir()
    cups = [f"cup_video_0_{i}\t{o}" for i in range(3) for o in range(3)]
    (tmp_path / "cup" / "cup_list.txt").write_text("\n".join(cups) + "\n")
    (tmp_path / "cup" / "mug_left_list.txt").write_text("cup_video_1_1\t0\n")
    records = sorted(str(p) for p in (data / "cup").glob("*.tfrecord"))
    results = []
    for module in (evaluator, jax_ev):
        lists = (RelabelLists if module is evaluator else
                 sys.modules["centerpose_tpu.evaluation.relabel"].RelabelLists).from_dir(str(tmp_path))
        results.append(_drive(module, gt, records, "cup", {
            "detector_mug": True, "relabel": lists, "mug_only": mug_only,
            "eval_mug_symmetric": False}))
    assert_same(results[0], results[1])
    calls = results[0][1]
    n_cup = sum(c[0] == "run" for c in calls["detector"])
    n_mug = sum(c[0] == "run" for c in calls["detector_mug"])
    assert (n_cup, n_mug) == {None: (3, 3), True: (0, 3), False: (3, 0)}[mug_only]


# --------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A res_18 of reference names as a `.pth`, for both CLIs, and a second
    one for the mug sub-model."""
    root = tmp_path_factory.mktemp("weights")
    paths = {}
    for name, seed in (("main", 3), ("mug", 4)):
        model = create_model(preset("centerpose_dla", arch="res_18", input_h=RES, input_w=RES),
                             "cpu", generator=torch.Generator().manual_seed(seed))
        paths[name] = str(root / f"{name}.pth")
        torch.save(model.state_dict(), paths[name])
    return paths


def test_cli_report_matches_jax_cli(data, weights, tmp_path, monkeypatch):
    """The port's `--report_json` equals the JAX CLI's on the same `.pth` and
    frames at the preset's vis_thresh (see the module docstring for what
    that covers)."""
    import centerpose_tpu.utils.compile_cache as compile_cache

    common = ["--data_dir", str(data / "frames"), "--arch", "res_18", "--input_res", str(RES),
              "--load_model", weights["main"], "--c", "bottle"]
    monkeypatch.syspath_prepend(str(REPO))
    monkeypatch.setattr(compile_cache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *common, "--report_json", str(tmp_path / "jax.json")])
    _load_script("jax_evaluate_cli", REPO / "evaluate.py").main()
    out = evaluate.main([*common, "--device", "cpu", "--report_json", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == out["report"] and got["num_gt"] == 9 and got["category"] == "bottle"
    assert_same(got, want)


def _report(argv):
    return evaluate.main([*ARCH, "--vis_thresh", "0.05", *argv])["report"]


def test_cli_eval_continue_skips_and_merges(data, weights, tmp_path, capsys, monkeypatch):
    """--eval_continue --n_proc 2 (the JAX CLI's workers drop --eval_gt_scale
    and --eval_MobilePose_postprocessing here): two spawned workers write
    one stats file per --data_dir video; a restart skips the finished video,
    evaluates the other in process and merges both; the same report as one
    plain run. The workers run one intra-op thread, as this process does:
    the scores of random weights crowd the threshold, and another order of
    summation moves a few of them across it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    stats = tmp_path / "stats"
    src = ["--data_dir", str(data / "frames"), "--load_model", weights["main"], "--eval_gt_scale",
           "--eval_MobilePose_postprocessing"]
    workers = _report([*src, "--eval_continue", "--stats_save", str(stats), "--n_proc", "2"])
    assert sorted(os.listdir(stats)) == ["video_0.json", "video_1.json"]
    first = (stats / "video_0.json").read_text()
    (stats / "video_1.json").unlink()
    capsys.readouterr()
    resumed = _report([*src, "--eval_continue", "--stats_save", str(stats)])
    assert "eval_continue: skipping video_0 (stats exist)" in capsys.readouterr().out
    assert sorted(os.listdir(stats)) == ["video_0.json", "video_1.json"]
    assert (stats / "video_0.json").read_text() == first
    whole = _report(src)
    assert whole["num_pred"] > 0
    assert_same(workers, whole)
    assert_same(resumed, whole)
    none = _report([*src, "--eval_hard_case", "2", "--eval_hard_case_list", "video_9"])
    assert none["num_gt"] == none["num_pred"] == 0


def test_cli_n_proc_passes_settings_to_workers(data, weights, tmp_path, monkeypatch):
    """Two spawned workers (one tfrecord each) give the report of one process
    with --eval_gt_scale, the mug sub-model (video_1's mugs; it takes
    --vis_thresh, which the JAX CLI's does not), the relabel lists and
    --eval_mug_symmetric 0 (the JAX CLI's workers drop --eval_gt_scale); the
    same run without them gives another report. One intra-op thread in the
    workers, as above."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (tmp_path / "cup").mkdir()
    cups = [f"cup_video_0_{i}\t{o}" for i in range(3) for o in range(3)]
    (tmp_path / "cup" / "cup_list.txt").write_text("\n".join(cups) + "\n")
    cup = ["--c", "cup", "--tfrecords", str(data / "cup" / "*.tfrecord"),
           "--load_model", weights["main"]]
    settings = ["--eval_gt_scale", "--mug_model", weights["mug"], "--label_dir", str(tmp_path),
                "--eval_mug_symmetric", "0"]
    one = _report([*cup, *settings])
    two = _report([*cup, *settings, "--n_proc", "2"])
    assert one["num_pred"] > 0
    assert_same(two, one)
    assert _report(cup) != one


def test_cli_data_dir_report_equals_tfrecords_report(data, weights):
    """The same frames through `--data_dir` and through their tfrecords (the
    other driver, the image from the record's PNG bytes, the camera from
    the transposed intrinsics) give one report."""
    src = ["--load_model", weights["main"]]
    by_dir = _report([*src, "--data_dir", str(data / "frames")])
    assert by_dir["num_pred"] > 0
    assert_same(_report([*src, "--tfrecords", str(data / "shoe" / "*.tfrecord")]), by_dir)


@pytest.mark.parametrize("category", ("shoe", "cup"))
def test_pack_dope_video_writes_the_scripts_records(data, tmp_path, category):
    """The package's packer writes the bytes `scripts/synth_to_tfrecords.py`
    writes, and `pack_dope_dataset` one record per video directory."""
    paths = pack_dope_dataset(str(data / "frames"), str(tmp_path), category)
    assert [Path(p).name for p in paths] == ["video_0.tfrecord", "video_1.tfrecord"]
    for path in paths:
        assert Path(path).read_bytes() == (data / category / Path(path).name).read_bytes()


@pytest.mark.parametrize("flag", (["--eval_gt_pre_hm_first"], ["--eval_add_noise"],
                                  ["--eval_fake_output"], ["--eval_CenterPose_initialization"],
                                  ["--mug_model", "m.pth"], ["--mug_only", "mug"]))
def test_cli_refuses_what_the_data_dir_driver_does_not_run(flag, capsys):
    with pytest.raises(SystemExit):
        evaluate.parse_args(["--data_dir", "d", *flag])
    assert "run on --tfrecords only" in capsys.readouterr().err
    assert evaluate.parse_args(["--tfrecords", "t", *flag]).tfrecords == "t"


def test_cli_refusals_and_device(capsys):
    for argv, message in ((["--c", "shoe"], "one of --data_dir / --tfrecords"),
                          (["--data_dir", "d", "--eval_continue"], "requires --stats_save"),
                          (["--data_dir", "d", "--n_proc", "2"], "requires --eval_continue")):
        with pytest.raises(SystemExit):
            evaluate.parse_args(argv)
        assert message in capsys.readouterr().err
    assert evaluate.parse_args(["--data_dir", "d"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["--data_dir", "d"])


@pytest.fixture(scope="module")
def loss_data(tmp_path_factory):
    """10 frames: one batch of 8 and a tail of 2."""
    root = tmp_path_factory.mktemp("loss_data")
    generate_dataset(str(root), n_videos=2, frames_per_video=5, seed=6, width=160, height=120)
    return str(root)


def test_cli_loss_mode_matches_jax_eval_step(loss_data, tmp_path):
    """`--mode loss` on a checkpoint the port's `save_checkpoint` wrote: the
    sample-weighted means over a batch of 8 and a tail of 2 equal the JAX
    package's `make_eval_step` on the same weights and batches; with
    `--all_checkpoints`, every checkpoint root is replayed."""
    jcfg = jax_config("res_18", RES)
    jmodel, variables = jax_model_and_variables(jcfg, seed=8)
    cfg = preset("centerpose_dla", arch="res_18", input_h=RES, input_w=RES)
    state, _ = create_train_state(cfg, port_from_jax(cfg, variables))
    for root, step in (("ckpt", 7), ("best", 5)):
        state.step = step
        save_checkpoint(str(tmp_path / root), state, step)
    (tmp_path / "tb").mkdir()                                   # no checkpoint: passed over

    out = evaluate.main([*ARCH, "--mode", "loss", "--data_dir", loss_data,
                         "--load_model", str(tmp_path / "ckpt")])
    (run,) = out["runs"]
    assert run["step"] == 7 and run["samples"] == 10 and len(run["ms_per_batch"]) == 2

    eval_fn = jax_trainer.make_eval_step(jcfg, jmodel)
    jstate = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                    batch_stats=variables["batch_stats"], opt_state=None)
    ds = ObjectPoseDataset(loss_data, cfg, split="val")
    items = [ds[i] for i in range(len(ds))]
    for item in items:
        item.pop("meta", None)
    want, n = {}, 0
    for chunk in (items[:8], items[8:]):
        stats = eval_fn(jstate, {k: jnp.asarray(v) for k, v in collate_filtered(chunk).items()})
        n += len(chunk)
        for k, v in stats.items():
            want[k] = want.get(k, 0.0) + float(v) * len(chunk)
    want = {k: v / n for k, v in want.items()}
    assert set(run["losses"]) == set(want) and want["loss"] > 0
    for k, v in want.items():
        assert abs(run["losses"][k] - v) <= 1e-4 * abs(v) + 1e-7, (k, run["losses"][k], v)

    every = evaluate.main([*ARCH, "--mode", "loss", "--data_dir", loss_data, "--load_model",
                           str(tmp_path), "--all_checkpoints"])["runs"]
    assert [(r["name"], r["step"]) for r in every] == [("best", 5), ("ckpt", 7)]
    assert every[1]["losses"] == run["losses"] == every[0]["losses"]


# ------------------------------------------------- the repaired demo loader
def test_demo_and_evaluate_load_a_train_cli_checkpoint_dir(data, tmp_path, monkeypatch):
    """`--load_model` naming a directory the port's `train.py` wrote (a root,
    or one step under it) loads in `demo.py` and `evaluate.py` (the demo
    raised IsADirectoryError before) and gives the outputs of the same
    weights loaded as a state dict."""
    monkeypatch.chdir(tmp_path)
    summary = train_cli.main(["--data_dir", str(data / "frames"), "--arch", "res_18", "--device", "cpu",
                              "--input_res", str(RES), "--batch_size", "2", "--num_epochs", "1",
                              "--num_workers", "0", "--val_intervals", "1", "--exp_id", "ev"])
    root = tmp_path / summary["exp_dir"] / "ckpt"
    step = latest_step(str(root))
    assert step == summary["step"] == 3
    saved = torch.load(root / str(step) / "checkpoint.pt", weights_only=True)
    torch.save(saved["state_dict"], tmp_path / "weights.pth")

    image = next((data / "frames" / "video_0").glob("*.png"))
    cfg = preset("centerpose_dla", arch="res_18", input_h=RES, input_w=RES, vis_thresh=0.05)
    from PIL import Image

    want = Detector(cfg, state_dict=saved["state_dict"], device="cpu").run(
        np.asarray(Image.open(image).convert("RGB")))["results"]
    assert want
    for load in (root, root / str(step)):
        out_dir = tmp_path / f"demo_{load.name}"
        demo.main(["--demo", str(image), *ARCH, "--vis_thresh", "0.05", "--load_model", str(load),
                   "--out_dir", str(out_dir)])
        got = json.loads((out_dir / f"{image.stem}.json").read_text())["detections"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["score"] == pytest.approx(float(w["score"]), abs=1e-6)
            np.testing.assert_allclose(g["kps"], np.asarray(w["kps"], np.float64).tolist(), atol=1e-4)

    src = ["--data_dir", str(data / "frames")]
    by_dir = _report([*src, "--load_model", str(root)])
    assert by_dir["num_pred"] > 0
    assert_same(by_dir, _report([*src, "--load_model", str(tmp_path / "weights.pth")]))
