"""The PyTorch package's data-preparation scripts against the JAX package's,
on the CPU.

Each twin (`python -m centerpose_tpu_torch.scripts.<name>`) and its JAX script
(loaded from `scripts/` and run through `main()` with a patched `sys.argv`)
run on the same generated input, each into its own temporary directory:
2 videos x 3 frames of 160x120 from the generator, their per-video records,
a shuffled shard of those frames under Objectron-style names
(`shoe/batch-0/<video>/<index>`), and a 3-frame 64x48 Motion-JPEG AVI with a
3-frame `Sequence` annotation. The outputs must be the same: tfrecords and
PNGs byte for byte, JSON equal once loaded. The parsers must agree option by
option; `write_mjpeg_avi`, `normalized_cuboid` and `CuboidVertexType` must
equal the JAX ones; the re-sorter must group an Objectron-named shard by
video and split a shard of the packer's three-part names frame by frame, as
the JAX script does; the prepared frames must carry the generator's
annotations; and one `train.py` step must run on them. No JAX model is built.
"""

import argparse
import importlib.util
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from centerpose_tpu.data import video as jax_video
from centerpose_tpu.geometry import cuboid as jax_cuboid
from centerpose_tpu_torch import train as train_cli
from centerpose_tpu_torch.data.tfrecord import (
    parse_objectron_example,
    read_tfrecord,
    rename_example,
    write_tfrecord,
)
from centerpose_tpu_torch.data.video import write_mjpeg_avi
from centerpose_tpu_torch.geometry import CuboidVertexType
from centerpose_tpu_torch.geometry.cuboid import normalized_cuboid
from centerpose_tpu_torch.scripts import (
    make_synthetic_dataset,
    prepare_test_videos,
    preprocess_tfrecords,
    preprocess_videos,
    synth_to_tfrecords,
)
from tests.test_objectron_pb import _f32, _point
from tests.test_tfrecord import _field, _len_field, _varint

REPO = Path(__file__).resolve().parents[1]
TWINS = {
    "make_synthetic_dataset": make_synthetic_dataset,
    "synth_to_tfrecords": synth_to_tfrecords,
    "preprocess_tfrecords": preprocess_tfrecords,
    "prepare_test_videos": prepare_test_videos,
    "preprocess_videos": preprocess_videos,
}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_both(name, argv_of, tmp):
    """The JAX script's `main()` (patched `sys.argv`) and the twin's
    `main(argv)`, each with `argv_of(out)` for its own output directory;
    returns the two directories."""
    outs = {}
    for side in ("jax", "port"):
        outs[side] = tmp / f"{name}_{side}"
        argv = argv_of(str(outs[side]))
        if side == "jax":
            saved = sys.argv
            sys.argv = [f"{name}.py", *argv]
            try:
                _load_script(name).main()
            finally:
                sys.argv = saved
        else:
            TWINS[name].main(argv)
    return outs["jax"], outs["port"]


def assert_same_tree(a: Path, b: Path):
    """The same files: JSON equal once loaded, everything else byte for byte."""
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files, f"nothing written under {a}"
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".json":
            assert json.loads((a / rel).read_text()) == json.loads((b / rel).read_text()), rel
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def objectron_shard(record_paths, out_path, category="shoe", seed=0, rename=True):
    """One shuffled shard of every frame of `record_paths` (one per video),
    in a seeded permutation; with `rename` each frame is named
    `<category>/batch-0/<video>/<index>` as in Objectron's records_shuffled.
    Returns {video: its (renamed) payloads in frame order}."""
    by_video, frames = {}, []
    for path in record_paths:
        video = Path(path).stem
        payloads = list(read_tfrecord(str(path)))
        if rename:
            payloads = [rename_example(p, f"{category}/batch-0/{video}/{i}") for i, p in enumerate(payloads)]
        by_video[video] = payloads
        frames += payloads
    order = np.random.RandomState(seed).permutation(len(frames))
    write_tfrecord(str(out_path), [frames[i] for i in order])
    return by_video


@pytest.fixture(scope="module")
def prep(tmp_path_factory):
    """The chain on both sides: generated frames, per-video records, an
    Objectron-named shuffled shard, its re-sorted records, training pairs."""
    tmp = tmp_path_factory.mktemp("prep")
    out = {"tmp": tmp}
    out["frames"] = run_both("make_synthetic_dataset", lambda o: [
        "--out", o, "--n_videos", "2", "--frames", "3", "--width", "160", "--height", "120",
        "--seed", "3"], tmp)
    out["records"] = run_both("synth_to_tfrecords", lambda o: [
        "--data_dir", str(out["frames"][1]), "--out_dir", o, "--c", "shoe"], tmp)
    records = sorted(out["records"][1].glob("*.tfrecord"))
    out["shard"] = tmp / "shard.tfrecord"
    out["videos"] = objectron_shard(records, out["shard"])
    out["resorted"] = run_both("prepare_test_videos", lambda o: [
        "--records", str(out["shard"]), "--out_dir", o], tmp)
    out["pairs"] = run_both("preprocess_tfrecords", lambda o: [
        "--records", str(out["resorted"][1] / "*.tfrecord"), "--out_dir", o, "--category", "shoe"], tmp)
    return out


@pytest.mark.parametrize("stage", ("frames", "records", "resorted", "pairs"))
def test_twin_writes_the_jax_scripts_files(prep, stage):
    assert_same_tree(*prep[stage])


def test_resort_groups_an_objectron_shard_by_video_in_frame_order(prep):
    """The shard's frames come back one file per video, each holding its
    video's payloads in frame order, byte for byte."""
    resorted = prep["resorted"][1]
    want = {f"shoe_batch-0_{video}.tfrecord": payloads for video, payloads in prep["videos"].items()}
    assert sorted(p.name for p in resorted.iterdir()) == sorted(want) and len(want) == 2
    for name, payloads in want.items():
        assert list(read_tfrecord(str(resorted / name), verify_crc=True)) == payloads


def test_resort_splits_the_packers_names_frame_by_frame(prep, tmp_path):
    """The packer names a frame `<category>/<video>/<index>`: the re-sorter's
    first three parts are the whole name, so every frame is a video of its
    own, in both packages."""
    records = sorted(prep["records"][1].glob("*.tfrecord"))
    shard = tmp_path / "shard.tfrecord"
    objectron_shard(records, shard, rename=False)
    jax_out, port_out = run_both("prepare_test_videos", lambda o: ["--records", str(shard), "--out_dir", o],
                                 tmp_path)
    assert_same_tree(jax_out, port_out)
    names = sorted(p.name for p in port_out.iterdir())
    assert names == sorted(f"shoe_video_{v}_{i}.tfrecord" for v in range(2) for i in range(3))
    assert all(len(list(read_tfrecord(str(port_out / n)))) == 1 for n in names)


@pytest.mark.parametrize("script,extra", (("prepare_test_videos", ["--max_videos", "1"]),
                                          ("preprocess_tfrecords", ["--max_frames", "4"])))
def test_limits_cut_as_the_jax_scripts_do(prep, tmp_path, script, extra):
    src = str(prep["shard"]) if script == "prepare_test_videos" else str(prep["resorted"][1] / "*.tfrecord")
    jax_out, port_out = run_both(script, lambda o: ["--records", src, "--out_dir", o, *extra], tmp_path)
    assert_same_tree(jax_out, port_out)
    n = len(list(port_out.rglob("*.tfrecord" if script == "prepare_test_videos" else "*.png")))
    assert n == (1 if script == "prepare_test_videos" else 4)


def test_prepared_pairs_carry_the_generators_annotations(prep):
    """Every generated frame comes back from the records, its cuboid within
    1 px (the int truncation), location, quaternion (up to sign), scale and
    intrinsics to float32 precision."""
    frames, pairs = prep["frames"][1], prep["pairs"][1] / "shoe"
    gen = sorted(frames.rglob("*.json"))
    assert len(gen) == 6
    for path in gen:
        video, index = path.parent.name, int(path.stem)
        src = json.loads(path.read_text())
        got = json.loads((pairs / f"shoe_batch-0_{video}" / f"{index:05d}.json").read_text())
        assert (pairs / f"shoe_batch-0_{video}" / f"{index:05d}.png").is_file()
        assert len(got["objects"]) == len(src["objects"]) > 0
        assert {k: got["camera_data"][k] for k in ("width", "height")} == {"width": 160, "height": 120}
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(got["camera_data"]["intrinsics"][k],
                                       src["camera_data"]["intrinsics"][k], rtol=1e-6)
        for o, s in zip(got["objects"], src["objects"]):
            assert np.abs(np.asarray(o["projected_cuboid"]) - np.asarray(s["projected_cuboid"])[:9]).max() < 1
            for k in ("location", "scale", "keypoints_3d"):
                np.testing.assert_allclose(o[k], np.asarray(s[k])[:9] if k == "keypoints_3d" else s[k],
                                           rtol=1e-5, atol=1e-6)
            q, qs = np.asarray(o["quaternion_xyzw"]), np.asarray(s["quaternion_xyzw"])
            np.testing.assert_allclose(q * np.sign(q @ qs), qs, atol=1e-6)


def test_train_step_on_prepared_pairs(prep, tmp_path, monkeypatch):
    """One `train.py --device cpu` step (res_18 at 64x64) on the pairs."""
    monkeypatch.chdir(tmp_path)
    summary = train_cli.main(["--data_dir", str(prep["pairs"][1]), "--device", "cpu", "--arch", "res_18",
                              "--input_res", "64", "--batch_size", "4", "--num_epochs", "1",
                              "--val_intervals", "0", "--num_workers", "0"])
    assert summary["step"] == 1 and np.isfinite(summary["loss_per_step"]).all()
    assert (tmp_path / summary["exp_dir"] / "ckpt").is_dir()


def _sequence(n_frames=3):
    """A `Sequence` of one object over `n_frames` frames, encoded as
    `tests/test_objectron_pb.py::_make_sequence` encodes its one frame; the
    camera's 144x192 (transposed) resolution gives 80x60 pairs at the
    default ratio 2.4."""
    rng = np.random.RandomState(0)
    obj = (_field(1, 0, _varint(0)) + _len_field(2, b"shoe") + _f32(4, np.eye(3).ravel())
           + _f32(5, [0.1, -0.2, 1.0]) + _f32(6, [0.1, 0.1, 0.25]))
    frames = b""
    for f in range(n_frames):
        kps = b""
        for i in range(9):
            kps += _len_field(2, _field(1, 0, _varint(i)) + _point(2, rng.rand(3))
                              + _point(3, list(rng.rand(2)) + [1.0]))
        ann = _field(1, 0, _varint(0)) + kps + _field(3, 5, struct.pack("<f", 0.9))
        cam = (_f32(3, np.eye(4).ravel()) + _field(5, 0, _varint(144)) + _field(6, 0, _varint(192))
               + _f32(7, [150.0, 0, 72, 0, 150.0, 96, 0, 0, 1]) + _f32(8, np.eye(4).ravel())
               + _f32(9, np.eye(4).ravel()))
        frame = (_field(1, 0, _varint(f)) + _len_field(2, ann) + _len_field(3, cam)
                 + _f32(5, [0, -0.1, 1.0]) + _f32(6, [0, 1.0, 0]))
        frames += _len_field(2, frame)
    return _len_field(1, obj) + frames


def _frames(n=3, w=64, h=48):
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("fps,quality", ((15.0, 90), (29.97, 75)))
def test_write_mjpeg_avi_writes_the_jax_bytes(tmp_path, fps, quality):
    write_mjpeg_avi(str(tmp_path / "port.avi"), _frames(), fps=fps, quality=quality)
    jax_video.write_mjpeg_avi(str(tmp_path / "jax.avi"), _frames(), fps=fps, quality=quality)
    assert (tmp_path / "port.avi").read_bytes() == (tmp_path / "jax.avi").read_bytes()


def test_preprocess_videos_writes_the_jax_scripts_pairs(tmp_path):
    """A 3-frame MJPEG AVI and its 3-frame `Sequence`: the same PNG bytes and
    JSON as the JAX script's, one pair a frame at the ratio's size."""
    avi, pb = tmp_path / "video.avi", tmp_path / "geometry.pbdata"
    write_mjpeg_avi(str(avi), _frames())
    pb.write_bytes(_sequence())
    jax_out, port_out = run_both("preprocess_videos", lambda o: [
        "--video", str(avi), "--annotation", str(pb), "--out_dir", o], tmp_path)
    assert_same_tree(jax_out, port_out)
    assert sorted(p.name for p in port_out.iterdir()) == [f"{i:05d}.{e}" for i in range(3) for e in ("json", "png")]
    record = json.loads((port_out / "00002.json").read_text())
    assert (record["camera_data"]["width"], record["camera_data"]["height"]) == (80, 60)
    assert len(record["objects"]) == 1 and len(record["objects"][0]["projected_cuboid"]) == 9


def _parser(main):
    """The `ArgumentParser` that `main` builds, caught at its `parse_args`."""
    caught = {}

    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        caught["parser"] = self
        raise Caught

    saved = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(Caught):
            main()
    finally:
        argparse.ArgumentParser.parse_args = saved
    return caught["parser"]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_parsers_agree_option_by_option(name):
    """Every option of the JAX script's parser is in the twin's with the same
    dest, default, choices, type, action and whether it is required; the
    twin adds none."""
    def options(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type, type(a).__name__,
                                          a.required, a.nargs, a.const)
                for a in parser._actions if not isinstance(a, argparse._HelpAction)}

    jax_options = options(_parser(_load_script(name).main))
    assert jax_options
    assert options(_parser(TWINS[name].main)) == jax_options


def test_cuboid_helpers_equal_the_jax_ones():
    for scale in ([0.1, 0.2, 0.3], [2.0, 0.5, 1.0], [1.0, 1.0, 1.0]):
        np.testing.assert_array_equal(normalized_cuboid(scale), jax_cuboid.normalized_cuboid(scale))
    assert ({m.name: m.value for m in CuboidVertexType}
            == {m.name: m.value for m in jax_cuboid.CuboidVertexType})
    assert list(CuboidVertexType.__members__) == list(jax_cuboid.CuboidVertexType.__members__)


def test_rename_example_changes_the_name_alone(prep):
    """`parse_example` -> `make_example` gives back the same bytes when the
    name is kept, and changes the name alone when it is not."""
    payload = next(read_tfrecord(str(sorted(prep["records"][1].glob("*.tfrecord"))[0])))
    name = parse_objectron_example(payload)["filename"]
    assert rename_example(payload, name) == payload
    renamed = parse_objectron_example(rename_example(payload, "shoe/batch-7/video_0/0"))
    original = parse_objectron_example(payload)
    assert renamed.pop("filename") == "shoe/batch-7/video_0/0"
    original.pop("filename")
    assert renamed.keys() == original.keys()
    for key, value in original.items():
        if isinstance(value, (list, tuple)):
            assert len(value) == len(renamed[key])
            assert all(np.array_equal(x, y) for x, y in zip(value, renamed[key])), key
        else:
            assert np.array_equal(value, renamed[key]), key
