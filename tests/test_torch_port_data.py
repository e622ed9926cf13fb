"""The PyTorch package's training data stack against the JAX package's, on the CPU.

`data/synthetic.py` (the generator writes the same files, byte for byte, from
one seed), `data/dataset.py` (the same samples, key for key: train split with
its augmentation from one RNG seed, and val; the float32 wire and the compact
wire, where the port deliberately encodes a heatmap value below 1 as at most
254 and the JAX package rounds it to 255 from 254.5/255 up), `data/loader.py`
(order, shuffle, worker RNG streams, error paths, as `tests/test_loader.py`
holds the JAX loader) and the two affine helpers the dataset uses. Small
frames (160x120) at 64x64 inputs keep every sample cheap.
"""

import json
import os
import time

import numpy as np
import pytest

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu.data import dataset as jax_dataset
from centerpose_tpu.data import synthetic as jax_synthetic
from centerpose_tpu.data.loader import DataLoader as JaxDataLoader
from centerpose_tpu.geometry import affine as jax_affine
from centerpose_tpu.geometry.gaussian import draw_gaussian as jax_draw_gaussian
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import dataset, synthetic
from centerpose_tpu_torch.data.loader import DataLoader
from centerpose_tpu_torch.geometry import affine
from centerpose_tpu_torch.geometry.gaussian import draw_gaussian

RES = 64
FRAME = (160, 120)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The port's generator's frames (2 videos x 3 frames), written once."""
    root = str(tmp_path_factory.mktemp("synthetic"))
    synthetic.generate_dataset(root, n_videos=2, frames_per_video=3, seed=4,
                               width=FRAME[0], height=FRAME[1])
    return root


@pytest.mark.parametrize("video_motion", [False, True])
def test_generator_writes_the_jax_files_byte_for_byte(tmp_path, video_motion):
    kw = dict(n_videos=2, frames_per_video=2, seed=11, width=FRAME[0], height=FRAME[1],
              video_motion=video_motion)
    paths = synthetic.generate_dataset(str(tmp_path / "port"), **kw)
    jax_paths = jax_synthetic.generate_dataset(str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in paths] == \
        [os.path.relpath(p, tmp_path / "jax") for p in jax_paths]
    got, ref = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(ref) and len(got) == 8
    for name in ref:
        assert got[name] == ref[name], name
    ann = json.loads(got["video_0/000000.json"])
    assert ann["objects"] and "camera_projection_matrix" in ann["camera_data"]


def test_affine_helpers_match():
    rng = np.random.RandomState(0)
    t = jax_affine.get_affine_transform(np.array([70.0, 50.0]), 140.0, 12.0, (RES, RES))
    for pt in rng.uniform(-20, 180, (5, 2)):
        np.testing.assert_array_equal(affine.affine_transform(pt, t), jax_affine.affine_transform(pt, t))
    img = rng.randint(0, 256, (FRAME[1], FRAME[0], 3)).astype(np.uint8)
    np.testing.assert_array_equal(affine.warp_affine_u8(img, t, (RES, RES)),
                                  jax_affine.warp_affine_u8(img, t, (RES, RES)))
    as_float = img.astype(np.float32)
    np.testing.assert_array_equal(affine.warp_affine_u8(as_float, t, (RES, RES)),
                                  jax_affine.warp_affine_u8(as_float, t, (RES, RES)))


def _pair(root, split, category="shoe", seed=5, **kw):
    over = dict(input_h=RES, input_w=RES, category=category)
    port = dataset.ObjectPoseDataset(root, preset("centerpose", **over), split=split, seed=seed, **kw)
    ref = jax_dataset.ObjectPoseDataset(root, jax_preset("centerpose", **over), split=split, seed=seed, **kw)
    return port, ref


def _same(got, ref, where):
    assert list(got) == list(ref), where
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (where, k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{where}: {k}")


@pytest.mark.parametrize("category", ["shoe", "bottle"])       # bottle: 12 symmetry copies
@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_samples_match_on_the_f32_wire(frames, split, category):
    """Every sample of both datasets, in order, from one RNG seed (the train
    split draws its crop, scale, flip, colour jitter and lighting from it):
    every key the same dtype, shape and values."""
    port, ref = _pair(frames, split, category)
    assert port.samples == ref.samples and len(port) == 6
    n_objects = 0
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert (got is None) == (want is None)
        _same(got, want, f"{split} sample {i}")
        n_objects += int(want["reg_mask"].sum())
    assert n_objects > 0
    if category == "bottle":
        assert want["hm"].shape[0] == 12


def test_dataset_new_data_augmentation_matches(frames):
    port, ref = _pair(frames, "train", new_data_aug=True, seed=9)
    for i in range(len(ref)):
        _same(port[i], ref[i], f"sample {i}")


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_samples_match_on_the_compact_wire(frames, split):
    """The compact wire: uint8 images and heatmaps. Every key equal to the
    JAX package's, but for heatmap values the JAX encoding rounds to 255
    below a peak: there the port has 254 (the wire fix); none elsewhere."""
    port, ref = _pair(frames, split, compact_wire=True)
    exact, _ = _pair(frames, split)                # the float32 heatmaps behind the wire
    for i in range(len(ref)):
        got, want, f32 = port[i], ref[i], exact[i]
        assert list(got) == list(want)
        assert got["input"].dtype == np.uint8 and got["hm"].dtype == np.uint8
        for k in want:
            if k in ("hm", "hm_hp"):
                fixed = (f32[k] < 1.0) & (want[k] == 255)
                np.testing.assert_array_equal(got[k][~fixed], want[k][~fixed], err_msg=k)
                assert (got[k][fixed] == 254).all()
                assert ((got[k] == 255) == (f32[k] == 1.0)).all(), k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_compact_wire_fix_keeps_shoulders_off_the_focal_positive():
    """A wide gaussian (radius 60 cells, as a large object near the camera
    gives at 512x512) has shoulders above 254.5/255. The JAX encoding sends
    them as 255, which decodes to 1.0, a positive of the focal loss
    (`gt == 1`); the port's sends them as 254 and only the peak as 255."""
    hm = np.zeros((160, 160), np.float32)
    jax_hm = np.zeros_like(hm)
    draw_gaussian(hm, (80, 80), 60)
    jax_draw_gaussian(jax_hm, (80, 80), 60)
    np.testing.assert_array_equal(hm, jax_hm)
    jax_wire = np.clip(np.round(hm * 255.0), 0, 255).astype(np.uint8)   # dataset.py:364-369
    port_wire = dataset.encode_heatmap(hm)
    shoulders = (hm < 1.0) & (jax_wire == 255)
    assert shoulders.sum() >= 4                         # the peak's 4 neighbours at least
    assert (port_wire[shoulders] == 254).all()
    assert (port_wire == 255).sum() == 1 == (hm == 1.0).sum()
    np.testing.assert_array_equal(port_wire[~shoulders], jax_wire[~shoulders])
    decoded = port_wire.astype(np.float32) / 255.0
    assert (decoded == 1.0).sum() == 1 and ((jax_wire.astype(np.float32) / 255.0) == 1.0).sum() > 1


def test_collate_and_discovery_match(frames):
    assert dataset.find_samples(frames) == jax_dataset.find_samples(frames)
    port, _ = _pair(frames, "val")
    samples = [port[0], None, port[1]]
    got = dataset.collate_filtered(samples)
    _same(got, jax_dataset.collate_filtered(samples), "collate")
    assert dataset.collate_filtered([None]) is None


# ------------------------------------------------------------------ loader
class FakeDataset:
    """Returns {'idx': i, 'noise': rng draw}; every 7th sample is corrupt
    (the fixture of tests/test_loader.py)."""

    def __init__(self, n=64, delay=0.0):
        self.n = n
        self.delay = delay
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.delay:
            time.sleep(self.delay)
        if i % 7 == 3:
            return None
        return {"idx": np.array([i], np.int64), "noise": np.array([self.rng.randn()], np.float32),
                "meta": {"path": f"sample_{i}"}}


class Exploding(FakeDataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("corrupt sample")
        return super().__getitem__(i)


def _collate(samples):
    return {"idx": np.concatenate([s["idx"] for s in samples]),
            "noise": np.concatenate([s["noise"] for s in samples])}


def _batches(loader_cls, n, batch, epoch=None, **kw):
    dl = loader_cls(FakeDataset(n), batch, collate_fn=_collate, **kw)
    if epoch is not None:
        dl.set_epoch(epoch)
    return len(dl), [(b["idx"].tolist(), b["noise"].tolist()) for b in dl]


@pytest.mark.parametrize("kw", [
    dict(n=64, batch=8, shuffle=False, num_workers=3),
    dict(n=28, batch=7, shuffle=False, num_workers=2),
    dict(n=32, batch=8, shuffle=True, num_workers=2, seed=5, epoch=1),
    dict(n=32, batch=8, shuffle=True, num_workers=2, seed=5, epoch=2),
    dict(n=40, batch=8, shuffle=False, num_workers=0),
    dict(n=30, batch=8, shuffle=False, num_workers=1, drop_last=True),
    dict(n=30, batch=8, shuffle=True, num_workers=1, drop_last=False, seed=3, epoch=4),
])
def test_loader_batches_match_the_jax_loader(kw):
    """Order, None filtering, per-epoch shuffle, drop_last and the worker
    RNG streams (the noise each sample draws): the same batches, the same
    values."""
    kw = dict(kw)
    n, batch = kw.pop("n"), kw.pop("batch")
    assert _batches(DataLoader, n, batch, **kw) == _batches(JaxDataLoader, n, batch, **kw)


def test_loader_order_shuffle_and_workers():
    n_batches, got = _batches(DataLoader, 64, 8, shuffle=False, num_workers=3)
    assert n_batches == 8
    assert [i for idx, _ in got for i in idx] == [i for i in range(64) if i % 7 != 3]
    _, one = _batches(DataLoader, 32, 8, epoch=1, shuffle=True, num_workers=2, seed=5)
    _, again = _batches(DataLoader, 32, 8, epoch=1, shuffle=True, num_workers=2, seed=5)
    _, other = _batches(DataLoader, 32, 8, epoch=2, shuffle=True, num_workers=2, seed=5)
    assert one == again and one != other
    _, sync = _batches(DataLoader, 40, 8, shuffle=False, num_workers=0)
    _, par = _batches(DataLoader, 40, 8, shuffle=False, num_workers=2)
    assert [i for i, _ in sync] == [i for i, _ in par]


def test_loader_overlaps_workers():
    ds = FakeDataset(32, delay=0.01)
    t0 = time.time()
    list(DataLoader(ds, 8, shuffle=False, num_workers=0, collate_fn=_collate))
    t_sync = time.time() - t0
    t0 = time.time()
    list(DataLoader(ds, 8, shuffle=False, num_workers=4, collate_fn=_collate))
    assert time.time() - t0 < t_sync * 0.6


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_carries_worker_exceptions(mode):
    dl = DataLoader(Exploding(16), 4, shuffle=False, num_workers=2, collate_fn=_collate, mode=mode)
    with pytest.raises(RuntimeError, match="worker"):
        list(dl)


def test_loader_over_the_dataset(frames):
    """The port's loader over the port's dataset: batches of the train split
    in the compact wire, the shapes the train step takes."""
    cfg = preset("centerpose", input_h=RES, input_w=RES)
    ds = dataset.ObjectPoseDataset(frames, cfg, split="train", compact_wire=True)
    batches = list(DataLoader(ds, 2, shuffle=True, num_workers=2, seed=0))
    assert len(batches) == 3
    for b in batches:
        assert b["input"].shape == (2, RES, RES, 3) and b["input"].dtype == np.uint8
        assert b["hm"].shape == (2, 1, RES // 4, RES // 4, 1) and "meta" not in b
