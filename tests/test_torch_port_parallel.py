"""The PyTorch package's data-parallel training, on the CPU.

Two ranks over gloo (`centerpose_tpu_torch/parallel/mesh.py::launch`, each
rank a spawned process with one intra-op thread) against the port's own
one-process step on the same global batch: the JAX package's mesh step is
the one-device step on the global batch, and `test_torch_port_training.py`
holds the port's one-process step against the JAX step, so this file jits
no JAX program.

The step comparison runs the network in float64: a train-mode step of a
random dlav1_34 at 64x64 amplifies float32 rounding (BatchNorm over 16-256
values a channel at the deep levels) to ~2e-4 of the loss between any two
summation orders, the one-process step's and the ranks' (BatchNorm's
statistics, the gradients' sum), which is the size of the differences the
test must rule out.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from centerpose_tpu_torch import train
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data.loader import DataLoader
from centerpose_tpu_torch.data.synthetic import generate_dataset
from centerpose_tpu_torch.data.targets import ObjectAnnotation, render_targets, stack_batch
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.parallel import World, launch, shard_batch
from centerpose_tpu_torch.parallel.step import train_steps

RES = 64
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def synthetic_batch(cfg, batch_size, seed):
    """Objects at seeded places with random keypoints, rendered by
    `render_targets`, and a random image: numpy arrays."""
    rng = np.random.RandomState(seed)
    out_res = cfg.output_h
    samples = []
    for _ in range(batch_size):
        obj = ObjectAnnotation(
            center=rng.uniform(out_res / 4, 3 * out_res / 4, 2),
            size=np.array([out_res / 3.0, out_res / 3.0]),
            keypoints=rng.uniform(out_res / 4, 3 * out_res / 4, size=(1, 8, 2)).astype(np.float32),
            keypoints_visible=np.ones((1, 8), bool),
            scale_3d=np.array([1.0, 1.0, 1.0], np.float32),
        )
        samples.append(render_targets([obj], cfg))
    batch = stack_batch(samples)
    batch["input"] = rng.randn(batch_size, cfg.input_h, cfg.input_w, 3).astype(np.float32)
    return batch


def test_two_rank_step_matches_the_one_process_step():
    """dlav1_34 at 64x64 with its DCN offset convs perturbed, global batch 4
    as 2 x 2: the all-reduced gradients within 1e-4 of each leaf's largest
    |g|, the loss within 1e-6 relative, the BatchNorm running statistics
    within 1e-5. A leaf whose largest |g| in the one-process step is below
    1e-8 of the model's largest (a bias in front of a train-mode BatchNorm:
    zero in exact arithmetic, the float32 loss's rounding in both runs, ~1e-10
    of the largest; or a parameter the forward never reads) must be below
    that in the ranks' step too."""
    cfg = preset("centerpose", input_h=RES, input_w=RES, batch_size=BATCH)
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                p.normal_(0.0, 0.05, generator=g)
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    batch = synthetic_batch(cfg, BATCH, seed=0)

    single = train_steps(None, cfg, state_dict, batch, "cpu", dtype=torch.float64)
    ranks = launch(train_steps, 2, (cfg, state_dict, batch, "cpu", 1, torch.float64),
                   backend="gloo", threads=1)
    got = ranks[0]
    assert ranks[1] == {"ms": [], "launches": {"dcn_v2_fwd": 0, "dcn_v2_bwd_fused": 0},
                        "launches_by_shape": {}}
    assert abs(got["loss"] - single["loss"]) <= 1e-6 * abs(single["loss"])
    for k, v in single["stats"].items():
        assert got["stats"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert got["norm"] == pytest.approx(single["norm"], rel=1e-9)

    zero = 1e-8 * max(float(v.abs().max()) for v in single["grads"].values())
    assert set(got["grads"]) == set(single["grads"]) and len(single["grads"]) > 200
    n_zero = 0
    for name, ref in single["grads"].items():
        scale = float(ref.abs().max())
        if scale < zero:
            # The 16 DCN blocks' biases, and the unused `project` conv + BN of
            # the two-level trees.
            assert name.endswith(".conv.bias") or ".project." in name, name
            assert float(got["grads"][name].abs().max()) < zero, name
            n_zero += 1
            continue
        err = float((got["grads"][name] - ref).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    assert n_zero < len(single["grads"]) // 10
    assert set(got["running"]) == set(single["running"]) and single["running"]
    for name, ref in single["running"].items():
        np.testing.assert_allclose(got["running"][name].numpy(), ref.numpy(), atol=1e-5, err_msg=name)
    # The step moved the statistics (momentum 0.1 of the global batch's).
    assert any(float((ref - state_dict[name].double()).abs().max()) > 1e-3
               for name, ref in single["running"].items())


def test_batch_norm_reduces_only_when_the_step_sets_its_group(tmp_path):
    """`make_train_step` sets the process group on the model's BatchNorms
    only for a world of more than one rank; a BatchNorm without it takes
    local statistics (no collective) whatever process group is live, and
    with it (here a live world of one rank) the same statistics through the
    all-reduced sums."""
    from centerpose_tpu_torch.models.layers import BatchNorm2d, bn2d
    from centerpose_tpu_torch.parallel.mesh import destroy_world, init_world
    from centerpose_tpu_torch.training.trainer import create_train_state, make_train_step

    cfg = preset("centerpose", arch="res_18", input_h=RES, input_w=RES, batch_size=BATCH)
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tx = create_train_state(cfg, model)[1]
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert norms
    init_world(0, 1, str(tmp_path / "rendezvous"), "gloo", timeout=30)
    try:
        make_train_step(cfg, model, tx, World(0, 1))
        assert all(m.process_group is None for m in norms)
        make_train_step(cfg, model, tx, World(0, 2))
        assert all(m.process_group is torch.distributed.group.WORLD for m in norms)

        x = torch.from_numpy(np.random.RandomState(0).randn(3, 8, 5, 5).astype(np.float32)).requires_grad_()
        local, synced = bn2d(8).train(), bn2d(8).train()
        synced.process_group = torch.distributed.group.WORLD
        y0, y1 = local(x), synced(x)
        torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
        g0, = torch.autograd.grad((y0 * x).sum(), x)
        g1, = torch.autograd.grad((y1 * x).sum(), x)
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-6)
        for name in ("running_mean", "running_var", "num_batches_tracked"):
            torch.testing.assert_close(getattr(synced, name), getattr(local, name), rtol=1e-6, atol=0)
    finally:
        destroy_world()


def test_shard_batch_and_a_failing_rank():
    """`shard_batch` gives rank r rows [r*B/n, (r+1)*B/n) and refuses a batch
    that does not split evenly; a rank that raises makes `launch` raise with
    its traceback instead of hanging."""
    batch = {"x": np.arange(12).reshape(6, 2), "scalar": np.float32(3.0)}
    parts = [shard_batch(World(r, 3), batch) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    assert all(p["scalar"] == 3.0 and len(p["x"]) == 2 for p in parts)
    with pytest.raises(ValueError, match="not a multiple"):
        shard_batch(World(0, 4), batch)
    with pytest.raises(RuntimeError, match="not a multiple"):
        launch(shard_batch, 2, ({"x": np.zeros(3)},), backend="gloo", timeout=30)


class _Frames:
    """A dataset of index records with an rng stream; items in `drop` are lost."""

    def __init__(self, n, drop=()):
        self.n, self.drop = n, set(drop)
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.drop:
            return None
        return {"idx": np.array([i]), "noise": np.array([self.rng.randn()])}


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_rank_slices_partition_the_global_batches(num_workers):
    """Each rank loads its slice of every global index batch (the one-process
    loader's permutation); rank 0's augmentation stream is the one-process
    loader's and rank 1's another; every rank yields one item per global
    batch, `None` where its slice lost every sample."""
    ds = _Frames(13)
    one = DataLoader(ds, 4, shuffle=True, num_workers=num_workers, seed=5)
    ranks = [DataLoader(ds, 4, shuffle=True, num_workers=num_workers, seed=5, rank=r, world=2)
             for r in range(2)]
    for loader in [one] + ranks:
        loader.set_epoch(3)
    whole = one.index_batches()
    assert len(whole) == 3 and all(len(b) == 4 for b in whole)
    for step, b in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([r.index_batches()[step] for r in ranks]), b)
    got = [list(r) for r in ranks]
    ref = list(one)
    for step in range(3):
        np.testing.assert_array_equal(
            np.concatenate([got[0][step]["idx"], got[1][step]["idx"]])[:, 0], ref[step]["idx"][:, 0])
    first = [b["noise"] for b in got[0]]
    assert not np.array_equal(np.concatenate(first), np.concatenate([b["noise"] for b in got[1]]))
    if num_workers == 0:    # one stream: rank 0 draws the one-process values for its rows
        np.testing.assert_array_equal(got[0][0]["noise"], ref[0]["noise"][:2])
    # drop_last=False: the short last batch (13 = 3 x 4 + 1) leaves rank 1 nothing.
    short = [list(DataLoader(ds, 4, shuffle=False, num_workers=num_workers, drop_last=False,
                             rank=r, world=2)) for r in range(2)]
    assert len(short[0]) == len(short[1]) == 4
    assert short[1][3] is None and short[0][3]["idx"].tolist() == [[12]]
    lost = DataLoader(_Frames(8, drop=(2, 3)), 4, shuffle=False, num_workers=num_workers,
                      rank=1, world=2)
    assert [b is None for b in lost] == [True, False]
    with pytest.raises(ValueError, match="multiple of the world size"):
        DataLoader(ds, 3, world=2)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    generate_dataset(root, n_videos=2, frames_per_video=4, seed=1, width=160, height=120)
    return root


def test_train_cli_on_two_gloo_ranks(frames, tmp_path, monkeypatch):
    """`train.py --device cpu --num_devices 2`: one epoch of 2 steps at
    global batch 4 and a validation pass, finite losses; rank 0 alone writes
    the experiment directory; the ranks' index slices partition the
    one-process loader's batches."""
    monkeypatch.chdir(tmp_path)
    out = train.main(["--data_dir", frames, "--device", "cpu", "--num_devices", "2",
                      "--input_res", str(RES), "--batch_size", str(BATCH), "--num_workers", "0",
                      "--num_epochs", "1", "--val_intervals", "1", "--save_intervals", "0",
                      "--exp_id", "ddp"])
    assert out["step"] == 2 and [e["steps"] for e in out["epochs"]] == [2]
    epoch = out["epochs"][0]
    assert all(np.isfinite(v) for v in epoch["train"].values())
    assert all(np.isfinite(v) for v in epoch["val"].values())
    exp = Path("exp") / "dlav1_34" / "ddp"
    assert sorted(os.listdir(exp / "ckpt")) == ["2"] and sorted(os.listdir(exp / "best")) == ["2"]
    log = (exp / "log.txt").read_text()
    assert log.count("training done") == 1 and log.count("epoch 1:") == 1
    assert json.loads((exp / "summary.json").read_text())["step"] == 2

    one = DataLoader(list(range(8)), BATCH, shuffle=True, num_workers=0, seed=317)
    one.set_epoch(1)
    slices = [r["indices"][0] for r in out["ranks"]]
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    for step, b in enumerate(one.index_batches()):
        assert slices[0][step] + slices[1][step] == b.tolist()
        assert len(slices[0][step]) == len(slices[1][step]) == BATCH // 2


def test_cli_batch_must_split_over_the_ranks():
    """`--batch_size` must be a multiple of `--num_devices` (each rank takes
    an equal slice), checked before any rank starts."""
    with pytest.raises(ValueError, match="multiple of --num_devices"):
        train.main(["--data_dir", "d", "--device", "cpu", "--num_devices", "3", "--batch_size", "4"])


def test_ddp_scaling_script_on_one_rank(tmp_path, monkeypatch):
    """`scripts/ddp_scaling.py` at a tiny size, one rank: a CLI run and a
    bare-step run, each with its step times, and the JSON file."""
    from centerpose_tpu_torch.scripts import ddp_scaling

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "scaling.json"
    records = ddp_scaling.main(["--device", "cpu", "--ranks", "1", "--input_res", str(RES),
                                "--batch_size", "2", "--frames", "4", "--epochs", "1", "--steps", "2",
                                "--num_workers", "0", "--out", str(out)])
    cli, step = records[1:]
    assert cli["mode"] == "cli" and cli["steps"] == 2 and len(cli["step_ms_less_wait"]) == 2
    assert all(np.isfinite(cli["train_loss"])) and cli["step_ms_less_wait_median_warm"] > 0
    assert step["mode"] == "step" and len(step["ms_per_step_each"]) == 1 and np.isfinite(step["loss"])
    assert json.loads(out.read_text())["runs"] == records
    assert not (tmp_path / "exp").exists()
