"""The PyTorch package's training CLI and checkpoints, on the CPU.

`python -m centerpose_tpu_torch.train` in process (`main(argv)`) with
`--device cpu` at 64x64: two steps of dlav1_34 on the package's own
synthetic frames, validation, the checkpoint layout of the JAX CLI
(`ckpt/`, `best/`, `epoch_N/`, one directory per step), then `--resume`
from the last checkpoint; every option of the JAX package's `train.py`,
`demo.py` and `evaluate.py` parses in its twin with the same default
(`--num_devices` is trained in `test_torch_port_parallel.py`); `utils/checkpoint.py`
round-trips a train state and partially initialises a model by name and
shape.
"""

import argparse
import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from centerpose_tpu_torch import train
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data.synthetic import generate_dataset
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training import trainer
from centerpose_tpu_torch.utils import checkpoint

RES = 64
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's 64x64 steps: they gain nothing from
    a thread pool, and under the suite's parallel workers a pool in every
    process oversubscribes the cores (a 64x64 batch norm then takes ~70 ms
    instead of well under one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    generate_dataset(root, n_videos=2, frames_per_video=2, seed=1, width=160, height=120)
    return root


def _argv(data, *extra):
    return ["--data_dir", data, "--device", "cpu", "--input_res", str(RES), "--batch_size", "2",
            "--num_workers", "0", "--val_intervals", "1", "--save_intervals", "1", *extra]


def test_cli_trains_validates_checkpoints_and_resumes(data, tmp_path, monkeypatch):
    """One epoch of 2 steps, validation and checkpoints; then `--resume` for a
    second epoch from step 2 to 4, the Adam state and the BatchNorm buffers
    read back. The log and the TensorBoard events are written."""
    monkeypatch.chdir(tmp_path)
    first = train.main(_argv(data, "--num_epochs", "1", "--exp_id", "cli"))
    exp = tmp_path / "exp" / "dlav1_34" / "cli"
    assert first["exp_dir"] == os.path.join("exp", "dlav1_34", "cli")
    assert first["step"] == 2 and [e["steps"] for e in first["epochs"]] == [2]
    epoch = first["epochs"][0]
    assert np.isfinite(epoch["train"]["loss"]) and np.isfinite(epoch["val"]["loss"])
    assert set(epoch["train"]) == set(epoch["val"]) and "hm_loss" in epoch["train"]
    for sub in ("ckpt", "best", "epoch_1"):
        assert checkpoint.latest_step(str(exp / sub)) == 2, sub
    assert (exp / "opt.txt").is_file() and (exp / "log.txt").is_file()
    assert os.listdir(exp / "tb") and (exp / "scalars.jsonl").read_text().count("\n") == 2
    assert len(first["ms_per_step"]) == 2 and 0.0 <= first["loader_wait_share"] < 1.0

    saved = torch.load(exp / "ckpt" / "2" / "checkpoint.pt", weights_only=True)
    assert saved["step"] == 2 and saved["optimizer"]["count"] == 2
    assert saved["metadata"]["config"]["input_h"] == RES

    second = train.main(_argv(data, "--num_epochs", "2", "--exp_id", "cli", "--resume"))
    assert second["step"] == 4 and [e["epoch"] for e in second["epochs"]] == [2]
    assert checkpoint.latest_step(str(exp / "ckpt")) == 4
    assert checkpoint.latest_step(str(exp / "epoch_2")) == 4
    assert "resumed from step 2 (epoch 1)" in (exp / "log.txt").read_text()


def test_cli_load_model_initialises_by_name(data, tmp_path, monkeypatch):
    """`--load_model DIR` (not `--resume`): the weights of DIR's latest
    checkpoint, a fresh optimizer and step."""
    monkeypatch.chdir(tmp_path)
    quick = ("--arch", "dla_34", "--num_epochs", "1", "--val_intervals", "0", "--save_intervals", "0")
    train.main(_argv(data, *quick, "--exp_id", "a"))
    src = os.path.join("exp", "dla_34", "a", "ckpt")
    out = train.main(_argv(data, *quick, "--exp_id", "b", "--load_model", src))
    assert out["step"] == 2
    log = (tmp_path / "exp" / "dla_34" / "b" / "log.txt").read_text()
    assert f"partial-init from {src}: " in log and " 0 kept at init" in log


def test_cli_trains_res_18(data, tmp_path, monkeypatch):
    """`--arch res_18`: one epoch of 2 steps of the msra ResNet (under the
    JAX CLI's preset, as every arch but dlav1 shares it), validated."""
    monkeypatch.chdir(tmp_path)
    out = train.main(_argv(data, "--arch", "res_18", "--num_epochs", "1", "--exp_id", "res",
                           "--save_intervals", "0"))
    assert out["exp_dir"] == os.path.join("exp", "res_18", "res") and out["step"] == 2
    epoch = out["epochs"][0]
    assert np.isfinite(epoch["train"]["loss"]) and np.isfinite(epoch["val"]["loss"])
    saved = torch.load(tmp_path / "exp" / "res_18" / "res" / "ckpt" / "2" / "checkpoint.pt", weights_only=True)
    assert "deconv_layers.0.weight" in saved["state_dict"]


@pytest.mark.parametrize("flags, dest, value", [
    # the ids from when --debug and --num_devices were refused; both are ported now
    pytest.param(["--debug", "1"], "debug", 1, id="flags0-queue A, debug canvases and webcam"),
    pytest.param(["--num_devices", "2"], "num_devices", 2, id="flags1-queue A, side ops and scale-out"),
])
def test_cli_refuses_what_is_not_ported(flags, dest, value):
    """Nothing the JAX CLI takes is refused any more: `--debug` (the debug
    canvases) and `--num_devices` (data-parallel ranks) parse. Asking for
    more GPUs than there are still fails, before anything is built."""
    assert getattr(train.parse_args(["--data_dir", "d", *flags]), dest) == value
    if dest == "num_devices":
        more = str(torch.cuda.device_count() + 1) if torch.cuda.is_available() else "2"
        with pytest.raises((RuntimeError, ValueError), match="CUDA device|GPU"):
            train.main(["--data_dir", "d", "--num_devices", more])


def _parser_of(parse):
    """The `argparse` parser a CLI's `parse_args` builds, caught as `parse()`
    runs it."""
    caught = []
    real = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        caught.append(self)
        return real(self, args, namespace)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_args):
        parse()
    return caught[0]


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def _keeps_the_jax_options(script, port_cli, argv):
    """Every option of the JAX package's root CLI `script` parses in the
    port's twin, to the same destination with the same default, choices,
    type and count; the port adds `--device` (default cuda) and nothing
    else."""
    spec = importlib.util.spec_from_file_location(f"jax_{script}_cli", REPO / f"{script}.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    with mock.patch.object(sys, "argv", [f"{script}.py", *argv]):   # the JAX CLIs read sys.argv
        ref = _options(_parser_of(jax_cli.parse_args))
    got = _options(_parser_of(lambda: port_cli.parse_args(argv)))
    assert set(ref) <= set(got), sorted(set(ref) - set(got))
    assert set(got) - set(ref) == {"--device"} and got["--device"].default == "cuda"
    for opt, a in ref.items():
        b = got[opt]
        assert (b.dest, b.default, b.choices, b.type, b.nargs, b.const) == \
            (a.dest, a.default, a.choices, a.type, a.nargs, a.const), opt


def test_cli_keeps_the_jax_flags_and_defaults():
    """Every flag of the JAX CLI, with the same default (`--dcn_bwd` and
    `--dcn_impl` accepted and ignored); `--device` added (default cuda)."""
    _keeps_the_jax_options("train", train, ["--data_dir", "d"])
    args = train.parse_args(["--data_dir", "d", "--dcn_bwd", "pallas", "--dcn_impl", "onehot"])
    assert (args.dcn_bwd, args.dcn_impl) == ("pallas", "onehot")


def test_demo_cli_keeps_the_jax_flags_and_defaults():
    """The demo twin takes every option of the JAX `demo.py`, `--save_json`
    (store_true, default True) among them."""
    from centerpose_tpu_torch import demo

    _keeps_the_jax_options("demo", demo, ["--demo", "x"])
    assert demo.parse_args(["--demo", "x", "--save_json"]).save_json is True


def test_evaluate_cli_keeps_the_jax_flags_and_defaults():
    from centerpose_tpu_torch import evaluate

    _keeps_the_jax_options("evaluate", evaluate, ["--data_dir", "d"])


def test_cli_refuses_cuda_without_a_gpu(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--data_dir", data])


# -------------------------------------------------------------- checkpoints
def _state(seed=0):
    cfg = preset("centerpose", arch="dla_34", input_h=RES, input_w=RES)
    model = create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    state, tx = trainer.create_train_state(cfg, model, steps_per_epoch=3)
    return cfg, model, state, tx


def test_checkpoint_round_trip(tmp_path):
    """save / latest_step / load: parameters, BatchNorm buffers, Adam's
    moments and count, the step and the metadata come back as saved."""
    cfg, model, state, tx = _state()
    gen = torch.Generator().manual_seed(3)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    tx.step()
    state.step = 7
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-1, 1, generator=gen)
    root = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(root) is None
    checkpoint.save_checkpoint(root, state, 5, {"config": {"arch": cfg.arch}})
    checkpoint.save_checkpoint(root, state, 7, {"config": {"arch": cfg.arch}})
    assert checkpoint.latest_step(root) == 7 and sorted(os.listdir(root)) == ["5", "7"]
    saved = torch.load(os.path.join(root, "7", "checkpoint.pt"), weights_only=True)
    assert saved["metadata"] == {"config": {"arch": "dla_34"}} and saved["step"] == 7

    _, model2, state2, tx2 = _state(seed=1)
    sd1 = model.state_dict()
    assert any(not torch.equal(v, model2.state_dict()[k]) for k, v in sd1.items())
    state2, step = checkpoint.load_checkpoint(root, state2)
    assert step == 7 == state2.step and tx2.count == 1
    for k, v in model2.state_dict().items():
        assert torch.equal(v, sd1[k]), k
    a, b = tx.adam.state_dict()["state"], tx2.adam.state_dict()["state"]
    assert a.keys() == b.keys() and len(a) == len(tx.params)
    for i in a:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[i][k], b[i][k]), (i, k)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"), state2)


def test_load_partial_matches_name_and_shape(tmp_path, capsys):
    """Tensors with the same name and shape load in place; a missing name or
    another shape keeps its init; the counts are (loaded, skipped) over the
    model's tensors."""
    _, model, state, _ = _state()
    sd = model.state_dict()
    root = str(tmp_path / "src")
    checkpoint.save_checkpoint(root, state, 1)
    ckpt_path = os.path.join(root, "1", "checkpoint.pt")
    payload = torch.load(ckpt_path, weights_only=True)
    payload["state_dict"]["hm.2.weight"] = torch.zeros(3, 256, 1, 1)     # another shape
    del payload["state_dict"]["wh.2.bias"]                                # a missing name
    torch.save(payload, ckpt_path)

    _, model2, _, _ = _state(seed=1)
    before = {k: v.clone() for k, v in model2.state_dict().items()}
    loaded, skipped = checkpoint.load_partial(root, model2)
    assert (loaded, skipped) == (len(sd) - 2, 2)
    after = model2.state_dict()
    for k in sd:
        if k in ("hm.2.weight", "wh.2.bias"):
            assert torch.equal(after[k], before[k]), k
        else:
            assert torch.equal(after[k], sd[k]), k
    assert "shape mismatch at hm.2.weight" in capsys.readouterr().out
