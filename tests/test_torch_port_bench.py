"""The PyTorch package's measuring entry points against the JAX package's, on
the CPU: `centerpose_tpu_torch/bench.py` (`bench.py`), `graft_entry.py`
(`__graft_entry__.py`: `entry`, `dryrun_multichip`),
`scripts/bench_e2e.py` and `scripts/bench_train.py` (the JAX
`scripts/` files of those names).

* `entry`'s `fn` on weights carried from a JAX dlav1_34 (64x64, variables
  from `jax.eval_shape`, offset convs drawn: the file's one JAX model) against
  the JAX network + `object_pose_decode(fit_gaussian=False)`;
* `bench_e2e._make_frames` bit for bit against the JAX script's (loaded by
  path), `bench_train.make_batch` against the JAX script's own lines;
* every twin driven at a small size on the CPU: one JSON line with the JAX
  keys and metric string and a finite value; `bench_e2e` in its three modes
  (calibrated detections, spawned tracks) and from a `save_checkpoint`
  directory; `dryrun_multichip(2)` over gloo against the one-process step;
* each entry point refuses a GPU that is not there.

One intra-op thread, and the file's memory handed back at its end.
"""

import argparse
import importlib.util
import json
import math
import pathlib
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.data import targets as jax_targets
from centerpose_tpu.ops import decode as jax_decode
from centerpose_tpu_torch import bench, graft_entry
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.models.convert import from_jax_variables
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.parallel.step import train_steps
from centerpose_tpu_torch.scripts import bench_e2e, bench_train
from centerpose_tpu_torch.training.trainer import create_train_state
from centerpose_tpu_torch.utils.checkpoint import save_checkpoint

from test_torch_port_resnet import jax_model_and_variables, release_memory

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64
KEYS = ["metric", "value", "unit", "vs_baseline"]
E2E_ARGS = ["--input_res", str(SIZE), "--img_size", "96", "--n_frames", "4", "--repeats", "1",
            "--batch_size", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


def load_jax_script(name):
    """A JAX package's root script, loaded by path (its module level
    imports numpy, or numpy and jax, and nothing of the package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name.replace('/', '_')}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed_record(capsys):
    """The one JSON line the entry point printed on stdout."""
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, lines
    record = json.loads(lines[0])
    assert list(record) == KEYS
    assert math.isfinite(record["value"]) and record["value"] > 0
    return record


# -------------------------------------------------------------------- entry
@pytest.fixture(scope="module")
def jax_flagship():
    """The file's one JAX model: dlav1_34 at 64x64, float32, its exact gather
    DCN; the JAX entry's forward + decode on one seeded image."""
    jcfg = jax_preset("centerpose", input_h=SIZE, input_w=SIZE, dcn_impl="gather")
    model, variables = jax_model_and_variables(jcfg, seed=3)
    image = np.random.RandomState(4).randn(1, SIZE, SIZE, 3).astype(np.float32)
    dets = jax_decode.object_pose_decode(
        model.apply(variables, jnp.asarray(image)), k=jcfg.K, rep_mode=jcfg.rep_mode,
        inference=True, fit_gaussian=False)
    return variables, image, {k: np.asarray(v) for k, v in dets.items()}


def test_entry_matches_jax(jax_flagship):
    """`fn(params, images)` on the JAX weights carried across: every peak's
    detection (score > 0; the zeros past the peaks tie, and the two libraries
    order ties differently) matched to the port's by its box: score within
    1e-4, box and keypoints within 0.05 of the output map's pixels (what
    `test_torch_port_serving.py` holds net + decode to)."""
    variables, image, ref = jax_flagship
    fn, (params, x) = graft_entry.entry(device="cpu")
    assert x.dtype == torch.float32 and tuple(x.shape) == (1, 512, 512, 3) and not x.any()
    carried = from_jax_variables(variables)
    assert set(carried) == set(params)
    got = {k: v.numpy() for k, v in fn(carried, torch.from_numpy(image)).items()}
    assert set(got) == set(ref)
    peaks = np.nonzero(ref["scores"][0, :, 0] > 0)[0]
    assert 5 <= len(peaks) < 100
    assert (got["scores"][0, :, 0] > 0).sum() == len(peaks)
    for i in peaks:
        j = int(np.argmin(np.abs(got["bboxes"][0] - ref["bboxes"][0, i]).sum(axis=1)))
        np.testing.assert_allclose(got["bboxes"][0, j], ref["bboxes"][0, i], atol=0.05, rtol=0)
        assert got["scores"][0, j, 0] == pytest.approx(ref["scores"][0, i, 0], abs=1e-4)
        np.testing.assert_allclose(got["kps"][0, j], ref["kps"][0, i], atol=0.05, rtol=0)
        np.testing.assert_allclose(got["kps_displacement_mean"][0, j],
                                   ref["kps_displacement_mean"][0, i], atol=0.05, rtol=0)


# ----------------------------------------------------- the twins' own inputs
@pytest.mark.parametrize("video", [False, True])
def test_make_frames_matches_jax(video):
    """The rendered frames, annotations and cameras of seed 3 equal the JAX
    script's bit for bit."""
    jax_e2e = load_jax_script("scripts/bench_e2e")
    frames, anns = bench_e2e._make_frames(3, 96, video=video)
    ref_frames, ref_anns = jax_e2e._make_frames(3, 96, video=video)
    assert len(frames) == len(ref_frames) == 3
    for f, r in zip(frames, ref_frames):
        assert f.dtype == r.dtype and f.shape == r.shape == (96, 96, 3)
        np.testing.assert_array_equal(f, r)
    for (ann, cam), (ref_ann, ref_cam) in zip(anns, ref_anns):
        assert ann == ref_ann
        assert vars(cam).keys() == vars(ref_cam).keys()
        for key, value in vars(ref_cam).items():
            np.testing.assert_array_equal(getattr(cam, key), value, err_msg=key)
        np.testing.assert_array_equal(bench_e2e._camera_meta(ann)["camera_matrix"],
                                      jax_e2e._camera_meta(ref_ann)["camera_matrix"])


def jax_bench_train_batch(jcfg, batch, res, track):
    """The batch the JAX script's own lines build (`scripts/bench_train.py`,
    from its `RandomState(0)` to the move to the device), run as they are
    written."""
    src = (REPO / "scripts" / "bench_train.py").read_text()
    start = src.index("    rng = np.random.RandomState(0)\n")
    code = textwrap.dedent(src[start:src.index("    batch = {k: jnp.asarray(v)", start)])
    ns = {"np": np, "cfg": jcfg, "BATCH": batch, "RES": res, "TRACK": track,
          "ObjectAnnotation": jax_targets.ObjectAnnotation,
          "render_targets": jax_targets.render_targets, "stack_batch": jax_targets.stack_batch}
    exec(code, ns)
    return ns["batch"]


@pytest.mark.parametrize("track", [False, True])
def test_bench_train_batch_matches_jax(track):
    env = {"BENCH_TRAIN_RES": str(SIZE), "BENCH_TRAIN_BATCH": "3",
           **({"BENCH_TRAIN_TRACK": "1"} if track else {})}
    s = bench_train.settings(env)
    cfg = bench_train.config(s)
    jcfg = jax_preset("centerpose_track" if track else "centerpose", input_h=SIZE, input_w=SIZE)
    assert cfg.arch == jcfg.arch == ("dla_34" if track else "dlav1_34")
    got = bench_train.make_batch(cfg, 3, SIZE, track)
    ref = jax_bench_train_batch(jcfg, 3, SIZE, track)
    assert set(got) == set(ref) and ("pre_hm_hp" in got) == track
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_bench_train_settings_take_the_jax_knobs():
    """The JAX script's names and defaults; its TPU DCN knobs accepted (and
    ignored) with their choices, anything else refused."""
    s = bench_train.settings({})
    assert s == {"batch": 16, "dtype": "bfloat16", "arch": "dlav1_34", "arch_set": False,
                 "res": 512, "track": False}
    assert bench_train.config(s).compute_dtype == "bfloat16"
    assert bench_train.config(bench_train.settings({"BENCH_TRAIN_TRACK": "1",
                                                    "BENCH_TRAIN_ARCH": "dlav1_34"})).arch == "dlav1_34"
    assert bench_train.settings({"BENCH_TRAIN_DCN": "gather", "BENCH_TRAIN_BWD": "pallas"}) == s
    for name in ("BENCH_TRAIN_DCN", "BENCH_TRAIN_BWD"):
        with pytest.raises(ValueError, match=name):
            bench_train.settings({name: "cuda"})


# ------------------------------------------------------ driving each twin
def test_bench_runs(monkeypatch, capsys):
    for name, value in (("BENCH_BATCH", "2"), ("BENCH_CHAIN", "2"), ("BENCH_DISPATCHES", "1")):
        monkeypatch.setenv(name, value)
    record = bench.main(input_res=SIZE, device="cpu")
    assert printed_record(capsys) == record
    assert record["metric"] == "images_per_sec_per_chip_64x64_dlav1_34"
    assert record["unit"] == "images/sec"
    assert record["vs_baseline"] == pytest.approx(record["value"] / 15.0, abs=1e-3)
    # At the defaults, the JAX file's metric, letter for letter.
    assert f'"{bench.metric_name(512, "dlav1_34")}"' in (REPO / "bench.py").read_text()


@pytest.mark.parametrize("track", [False, True])
def test_bench_train_runs(track, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_TRAIN_RES", str(SIZE))
    monkeypatch.setenv("BENCH_TRAIN_BATCH", "2")
    if track:
        monkeypatch.setenv("BENCH_TRAIN_TRACK", "1")
    record = bench_train.main(device="cpu")
    assert printed_record(capsys) == record
    arch = "track_dla_34" if track else "dlav1_34"
    assert record["metric"] == f"train_images_per_sec_per_chip_64x64_{arch}_b2"
    assert record["unit"] == "images/sec" and record["vs_baseline"] is None
    # The JAX script's metric format, letter for letter.
    assert ("f\"train_images_per_sec_per_chip_{RES}x{RES}_\"\n"
            "            f\"{'track_' if TRACK else ''}{cfg.arch}_b{BATCH}\"") in \
        (REPO / "scripts" / "bench_train.py").read_text()


E2E_METRICS = {"batch": "e2e_batch_fps_64x64_dlav1_34_b2", "single": "e2e_single_fps_64x64_dlav1_34",
               "track": "e2e_track_fps_64x64_dla_34_track"}


@pytest.mark.parametrize("mode", ["batch", "single", "track"])
def test_bench_e2e_runs(mode, tmp_path, capsys):
    """Each mode at 64x64 on 4 frames of 96x96: the calibrated threshold lets
    detections through to PnP, and in track mode the timed loop spawns
    tracks; `--out` merges the record into the file."""
    out = tmp_path / "BENCH_E2E.json"
    out.write_text(json.dumps({"records": [{"metric": "other"}, {"metric": E2E_METRICS[mode]}]}))
    record = bench_e2e.main(["--mode", mode, *E2E_ARGS, "--out", str(out)], device="cpu")
    assert printed_record(capsys) == {k: record[k] for k in KEYS}
    assert record["metric"] == E2E_METRICS[mode]
    assert record["unit"] == "images/sec end-to-end"
    ref_fps = 10.0 if mode == "track" else 15.0
    assert record["vs_baseline"] == pytest.approx(record["value"] / ref_fps, abs=1e-3)
    detail = record["detail"]
    assert detail["weights"] == "random+calibrated_thresh" and detail["vis_thresh"] > 0
    assert detail["boxes_per_img"] > 0 and detail["images"] >= 1
    assert "note" not in detail
    if mode == "track":
        assert detail["tracks_spawned"] > 0
    assert json.loads(out.read_text())["records"] == [{"metric": "other"}, json.loads(json.dumps(record))]


def test_bench_e2e_loads_a_checkpoint(tmp_path, capsys):
    cfg = preset("centerpose", input_h=SIZE, input_w=SIZE)
    model = create_model(cfg, device="cpu", param_dtype="float32",
                         generator=torch.Generator().manual_seed(5))
    state, _ = create_train_state(cfg, model)
    save_checkpoint(str(tmp_path / "ckpt"), state, 3)
    record = bench_e2e.main(["--mode", "single", *E2E_ARGS, "--load_model", str(tmp_path / "ckpt")],
                            device="cpu")
    assert printed_record(capsys) == {k: record[k] for k in KEYS}
    assert record["detail"]["weights"] == str(tmp_path / "ckpt")
    assert record["detail"]["vis_thresh"] == cfg.vis_thresh       # no calibration


class _Parsed(Exception):
    pass


def _parser_of(run):
    """The `argparse` parser that `run()` builds, caught at its parse (which
    then stops the run)."""
    caught = []

    def parse_args(self, args=None, namespace=None):
        caught.append(self)
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_args):
        with pytest.raises(_Parsed):
            run()
    return {opt: a for a in caught[0]._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def test_bench_e2e_keeps_the_jax_options():
    jax_e2e = load_jax_script("scripts/bench_e2e")
    with mock.patch.object(sys, "argv", ["bench_e2e.py"]):
        ref = _parser_of(jax_e2e.main)
    got = _parser_of(lambda: bench_e2e.parse_args([]))
    assert set(got) == set(ref)
    for opt, a in ref.items():
        b = got[opt]
        assert (b.dest, b.default, b.choices, b.type, b.required) == \
            (a.dest, a.default, a.choices, a.type, a.required), opt
    assert bench_e2e.REF_FPS == jax_e2e.REF_FPS
    args = bench_e2e.parse_args(["--mode", "batch"])
    assert bench_e2e.metric_name(args, "dlav1_34") == "e2e_batch_fps_512x512_dlav1_34_b32"


# ---------------------------------------------------------------- dryrun
def test_dryrun_multichip_matches_one_process_step(monkeypatch, capsys):
    """Two gloo ranks, one sample each, at 64x64: the step's loss (the global
    batch's) against the one-process step on the same 2 samples within 1e-3
    relative (two float32 summation orders of BatchNorm statistics differ by
    ~2e-4 here), then the gathered sharded detections."""
    monkeypatch.setenv("CENTERPOSE_DRYRUN_RES", str(SIZE))
    out = graft_entry.dryrun_multichip(2, device="cpu")
    printed = capsys.readouterr().out
    assert "dryrun_multichip(2) train OK — 64x64 b2" in printed
    assert "dryrun_multichip(2) inference OK — sharded run_batch 64x64 b2, K=100" in printed
    assert (out["res"], out["infer_res"]) == (SIZE, SIZE)
    assert tuple(out["scores"].shape) == (2, 100, 1) and out["kps"].shape[0] == 2
    assert torch.isfinite(out["scores"]).all() and torch.isfinite(out["kps"]).all()
    assert [r["loss"] for r in out["ranks"]] == [out["loss"]] * 2

    cfg = preset("centerpose", input_h=SIZE, input_w=SIZE, batch_size=2)
    batch, images = graft_entry.dryrun_batch(cfg, 2)
    assert images.shape == (2, SIZE, SIZE, 3)
    state_dict = create_model(cfg, device="cpu", param_dtype="float32").state_dict()
    single = train_steps(None, cfg, state_dict, batch, "cpu")
    assert out["loss"] == pytest.approx(single["loss"], rel=1e-3)


def test_dryrun_resolution_follows_the_jax_host_rule(monkeypatch):
    monkeypatch.delenv("CENTERPOSE_DRYRUN_RES", raising=False)
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    monkeypatch.setattr(graft_entry.os, "cpu_count", lambda: 4)
    assert (graft_entry.dryrun_res(cpu), graft_entry.dryrun_res(gpu)) == (128, 512)
    monkeypatch.setattr(graft_entry.os, "cpu_count", lambda: 8)
    assert graft_entry.dryrun_res(cpu) == 512
    monkeypatch.setenv("CENTERPOSE_DRYRUN_RES", "96")
    assert (graft_entry.dryrun_res(cpu), graft_entry.dryrun_res(gpu)) == (96, 96)


# -------------------------------------------------------------- refusals
def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    """Every entry point defaults to the GPU and refuses a host without one,
    before it builds anything; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.main(), lambda: bench_train.main(), lambda: graft_entry.entry(),
                 lambda: graft_entry.dryrun_multichip(1),
                 lambda: bench_e2e.main(["--mode", "single"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
