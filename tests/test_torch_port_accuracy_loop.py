"""The PyTorch package's closed accuracy loop on the CPU: the DCN offset
probe (`scripts/probe_dcn_offsets.py`) against the JAX model's captured
`conv_offset_mask` outputs, its `--init` report, and one tiny run of the loop
(`scripts/accuracy_loop.py`) through the real train and evaluate CLIs.

The loop's real protocol (dlav1_34 at 512x512, ~100 steps and more) runs on
the card, in `chip_smoke.py`'s accuracy phase. One module-scoped JAX model
(dlav1_34 at 64x64, variables from `jax.eval_shape`, offset convs drawn),
one intra-op thread, and the file's memory handed back at its end.
"""

import json
import os
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.config import preset as jax_preset
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data.synthetic import generate_dataset
from centerpose_tpu_torch.models.convert import load_jax_variables
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.scripts import accuracy_loop, probe_dcn_offsets

from test_torch_port_resnet import jax_model_and_variables, release_memory

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    release_memory()


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe_frames")
    generate_dataset(str(root), n_videos=1, frames_per_video=2, seed=777, width=96, height=80)
    return str(root)


def jax_offset_stats(om):
    """The JAX package's `scripts/probe_dcn_offsets.py` statistics of one
    captured `conv_offset_mask` output."""
    off = om[..., :18]
    mask = 1.0 / (1.0 + np.exp(-om[..., 18:]))
    mag = np.abs(off)
    return {"offset_abs_mean": float(mag.mean()), "offset_abs_p90": float(np.percentile(mag, 90)),
            "offset_abs_max": float(mag.max()), "mask_mean": float(mask.mean()),
            "mask_dev_from_half_mean": float(np.abs(mask - 0.5).mean())}


def test_probe_init_is_exactly_zero_and_half(frames_dir, tmp_path):
    """A freshly built model: 16 layers, every offset exactly 0 and every gate
    exactly 0.5, under the JAX record's layer names."""
    out = tmp_path / "probe.json"
    report = probe_dcn_offsets.main(["--init", "--data_dir", frames_dir, "--input_res", str(SIZE),
                                     "--n_frames", "2", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == report
    assert report["overall"]["n_dcn_layers"] == 16 and report["overall"]["weights"] == "random-init"
    assert report["overall"]["offset_abs_mean"] == report["overall"]["offset_abs_max"] == 0.0
    assert report["overall"]["mask_dev_from_half_mean"] == 0.0
    for name, st in report["layers"].items():
        assert st == {"offset_abs_mean": 0.0, "offset_abs_p90": 0.0, "offset_abs_max": 0.0,
                      "mask_mean": 0.5, "mask_dev_from_half_mean": 0.0}, name
    record = json.loads((REPO / "PROBE_OFFSETS_r05.json").read_text())
    assert list(report["layers"]) == list(record["layers"])
    assert set(report["overall"]) == set(record["overall"])
    with pytest.raises(SystemExit):
        probe_dcn_offsets.parse_args(["--data_dir", frames_dir])      # a checkpoint, or --init


def test_probe_matches_jax_capture(frames_dir):
    """Carried weights with the offset convs drawn: each layer's statistics
    from the port's forward hooks against the same statistics of the JAX
    model's `capture_intermediates`, key for key, within 1e-5 (relative, and
    absolute near 0)."""
    jcfg = jax_preset("centerpose", input_h=SIZE, input_w=SIZE, dcn_impl="gather")
    model, variables = jax_model_and_variables(jcfg, seed=5)
    frames = probe_dcn_offsets.load_frames(frames_dir, 2, SIZE)

    @jax.jit
    def capture(v, x):
        return model.apply(v, x, train=False, mutable=["intermediates"],
                           capture_intermediates=lambda mdl, _m: mdl.name == "conv_offset_mask")[1]

    ref = {}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif "conv_offset_mask" in path:
            name = "/".join(p for p in path if p not in ("intermediates", "conv_offset_mask", "__call__"))
            ref[name] = jax_offset_stats(np.asarray(tree[0] if isinstance(tree, tuple) else tree))

    walk(jax.device_get(capture(variables, jnp.asarray(frames)))["intermediates"])
    port = create_model(preset("centerpose", input_h=SIZE, input_w=SIZE), device="cpu")
    load_jax_variables(port, variables)
    report = probe_dcn_offsets.probe(port, frames)
    assert len(ref) == 16 and list(report["layers"]) == sorted(ref, key=list(report["layers"]).index)
    assert set(report["layers"]) == set(ref)
    for name, stats in report["layers"].items():
        assert stats["offset_abs_mean"] > 0.1, name                 # the offsets are live
        for key, value in stats.items():
            np.testing.assert_allclose(value, ref[name][key], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {key}")
    assert report["overall"]["offset_abs_max"] == max(v["offset_abs_max"] for v in ref.values())


def test_jax_names():
    assert probe_dcn_offsets.jax_name("dla_up.ida_2.node_3.conv.conv_offset_mask") == "dla_up/ida_2/stage_3/node"
    assert probe_dcn_offsets.jax_name("ida_up.proj_1.conv.conv_offset_mask") == "ida_up/stage_1/proj"
    with pytest.raises(ValueError):
        probe_dcn_offsets.jax_name("ida_up.proj_1.conv")


def test_loop_writes_the_jax_artifact(tmp_path, monkeypatch):
    """One tiny run on the CPU (res_18 at 64x64, 2 x 2 training frames, 1 x 2
    held out, one epoch of batch 2, the CLIs in process): the artifact has
    every key of the JAX loop's (`ACCURACY_r04.json`) and its protocol's,
    plus the probe at init and after, the device, losses and times."""
    monkeypatch.chdir(tmp_path)
    artifact = accuracy_loop.main([
        "--device", "cpu", "--in_process", "--arch", "res_18", "--input_res", str(SIZE),
        "--train_videos", "2", "--train_frames", "2", "--val_videos", "1", "--val_frames", "2",
        "--num_epochs", "1", "--batch_size", "2", "--val_intervals", "1", "--num_workers", "0",
        "--img_size", "96", "--debug", "1"])
    record = json.loads((REPO / "ACCURACY_r04.json").read_text())
    assert set(record) <= set(artifact) and set(record["protocol"]) <= set(artifact["protocol"])
    assert set(artifact["ap"]) == set(record["ap"]) and all(np.isfinite(v) for v in artifact["ap"].values())
    on_disk = json.loads((tmp_path / "exp" / "accuracy" / "ACCURACY.json").read_text())
    assert on_disk["ap"] == artifact["ap"] and on_disk["num_gt"] == artifact["num_gt"] > 0
    assert artifact["protocol"]["train_frames"] == 4 and artifact["protocol"]["heldout_frames"] == 2
    assert artifact["steps"] == 2 and len(artifact["loss_by_epoch"]) == 1
    assert artifact["device"] == {"kind": "cpu", "nvidia_smi": None}
    assert artifact["dcn_offset_probe"]["init"]["overall"]["n_dcn_layers"] == 0   # res_18 has no DCN
    assert artifact["ms_per_step"] > 0 and 0.0 <= artifact["loader_wait_share"] <= 1.0
    debug_dir = tmp_path / "exp" / "res_18" / accuracy_loop.EXP_ID / "debug"
    assert (debug_dir / "e1_out_img_pred.png").is_file() and (debug_dir / "e1_out_hm_gt.png").is_file()


def test_run_starts_a_subprocess_from_any_directory(tmp_path, monkeypatch):
    """Without `--in_process` each CLI is `python -m ...` in a child process,
    which finds the package from another working directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PYTHONPATH", raising=False)
    accuracy_loop.run("centerpose_tpu_torch.scripts.probe_dcn_offsets", ["--help"], in_process=False)
    assert os.getcwd() == str(tmp_path)
