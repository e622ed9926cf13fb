"""The PyTorch package's side ops and scripts against the JAX package's, on
the CPU.

* `ops/psroi.py::dcn_v2_psroi_pooling` (NCHW) against the JAX op (NHWC),
  with and without `trans`, ROI corners on exact .5 coordinates among
  them: forward and the input's gradient within 1e-5.
* `geometry/collision.py` against the JAX functions on 200 seeded segments
  and boxes: the same answers.
* `utils/profiler.py`: `trace` and the spans inside it on the CPU.
* `scripts/group_report.py` on shard stats the port's `Evaluator` wrote:
  the JAX script's report of the same files; `scripts/batch_eval.py` and
  `scripts/track_ablation.py` (with `subprocess.run` patched): the JAX
  scripts' command lines apart from the module path.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from centerpose_tpu.geometry import collision as jax_collision
from centerpose_tpu.ops.psroi import dcn_v2_psroi_pooling as jax_psroi
from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.evaluation import evaluator
from centerpose_tpu_torch.geometry import collision
from centerpose_tpu_torch.ops.psroi import dcn_v2_psroi_pooling
from centerpose_tpu_torch.scripts import batch_eval, group_report, track_ablation
from centerpose_tpu_torch.utils import profiler
from centerpose_tpu_torch.utils.profiler import trace

from test_torch_port_evaluation import _run, _scenes

REPO = Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------- psroi
@pytest.mark.parametrize("with_trans", [False, True], ids=["no_trans", "trans"])
def test_psroi_matches_jax(with_trans):
    """16 ROIs (one per side of the image, some outside it, one on .5
    corners) on B=2, 12x14, output_dim 4, group 3, P=3, S=2."""
    rng = np.random.RandomState(0)
    b, h, w, out_dim, group, pooled = 2, 12, 14, 4, 3, 3
    x = rng.randn(b, h, w, out_dim * group * group).astype(np.float32)
    n = 16
    rois = np.stack([rng.randint(0, b, n), rng.uniform(-10, 60, n), rng.uniform(-10, 50, n),
                     rng.uniform(0, 70, n), rng.uniform(0, 60, n)], 1).astype(np.float32)
    rois[0, 1:] = [2.5, 3.5, 20.5, -1.5]
    trans = rng.randn(n, 4, 2, 2).astype(np.float32) if with_trans else None
    kw = dict(spatial_scale=0.25, pooled_size=pooled, output_dim=out_dim, group_size=group,
              part_size=2 if with_trans else None, sample_per_part=2,
              trans_std=0.1 if with_trans else 0.0)
    ref, vjp = jax.vjp(lambda xx: jax_psroi(xx, jnp.asarray(rois), None if trans is None
                                            else jnp.asarray(trans), **kw), jnp.asarray(x))
    cot = rng.randn(*ref.shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(cot))

    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    out = dcn_v2_psroi_pooling(xt, torch.from_numpy(rois),
                               None if trans is None else torch.from_numpy(trans), **kw)
    assert out.shape == (n, out_dim, pooled, pooled) and out.dtype == torch.float32
    out.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2)))
    got = out.detach().numpy().transpose(0, 2, 3, 1)
    assert np.abs(np.asarray(ref)).max() > 0.5 and (np.asarray(ref) == 0).any()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(ref_dx),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="C_in"):
        dcn_v2_psroi_pooling(xt[:, :5], torch.from_numpy(rois), **kw)


# --------------------------------------------------------------- collision
def test_collision_matches_jax():
    """200 segments against axis-aligned and oriented boxes, some segments
    parallel to a face: the same answers, both answers present."""
    rng = np.random.RandomState(1)
    answers = []
    for i in range(200):
        p0, p1 = rng.uniform(-2, 2, 3), rng.uniform(-2, 2, 3)
        if i % 10 == 0:
            p1[i % 3] = p0[i % 3]                 # parallel to a slab
        lo = rng.uniform(-1, 0, 3)
        hi = lo + rng.uniform(0.1, 1.5, 3)
        got = collision.segment_intersects_box(p0, p1, lo, hi)
        assert got == jax_collision.segment_intersects_box(p0, p1, lo, hi), i
        q, _ = np.linalg.qr(rng.randn(3, 3))
        t, s = rng.uniform(-1, 1, 3), rng.uniform(0.2, 2.0, 3)
        got_o = collision.segment_intersects_oriented_box(p0, p1, q, t, s)
        assert got_o == jax_collision.segment_intersects_oriented_box(p0, p1, q, t, s), i
        answers += [got, got_o]
    assert 50 < sum(answers) < 350


# ---------------------------------------------------------------- profiler
def test_stage_timer_and_trace(tmp_path):
    """`trace` writes the Chrome trace of its block, with the operators and
    the spans opened inside it (`centerpose.<name>`); the same spans
    outside it are recorded unflagged and reach no trace."""
    profiler.reset()
    with profiler.span("net", chunk=4):
        torch.relu(torch.ones(4, 4))
    with trace(str(tmp_path / "tr")) as prof:
        with profiler.span("net", chunk=5):
            torch.relu(torch.randn(32, 32) @ torch.randn(32, 32))
    names = {e.key for e in prof.key_averages()}
    assert "aten::relu" in names and "aten::mm" in names and "centerpose.net" in names
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::relu" for e in events)
    ranges = [e for e in events if e.get("name") == "centerpose.net"]
    assert len(ranges) == 1 and ranges[0]["dur"] > 0
    records = profiler.snapshot()["spans"]["net"]["records"]
    assert [(r["ids"]["chunk"], r["profiled"]) for r in records] == [(4, False), (5, True)]
    profiler.reset()


# ----------------------------------------------------------------- scripts
def test_group_report_matches_the_jax_script(tmp_path, capsys):
    """Three shards written by the port's `Evaluator`: the port's script and
    the JAX script report the same text."""
    cfg = preset("centerpose", category="camera")
    scenes = _scenes(5, 12)
    for i in range(3):
        ev = _run(evaluator, evaluator.Evaluator(cfg), scenes[4 * i:4 * i + 4])
        ev.save_stats(str(tmp_path / f"shard{i}_stats.json"))
    stats = str(tmp_path / "shard*_stats.json")
    got = group_report.main(["--stats", stats, "--c", "camera", "--report_file", str(tmp_path / "port.txt")])
    jax_main = _jax_script("group_report").main
    with mock.patch.object(sys, "argv", ["group_report.py", "--stats", stats, "--c", "camera",
                                         "--report_file", str(tmp_path / "jax.txt")]):
        jax_main()
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text() == got + "\n"
    whole = _run(evaluator, evaluator.Evaluator(cfg), scenes)
    assert got == whole.report()
    with pytest.raises(SystemExit):
        group_report.main(["--stats", str(tmp_path / "none*.json")])


def _commands(main, argv, script_argv=None, report=None):
    """The command lines `main` runs, `subprocess.run` patched; each run
    writes `report` to its `--report_json`, if given."""
    calls = []

    def run(cmd, **kw):
        calls.append((list(cmd), kw))
        if report is not None:
            path = cmd[cmd.index("--report_json") + 1]
            with open(path, "w") as f:
                json.dump(report, f)

    with mock.patch("subprocess.run", run):
        if script_argv is None:
            main(argv)
        else:
            with mock.patch.object(sys, "argv", script_argv):
                main()
    return calls


def _same_commands(port, ref):
    """Equal apart from the module path: `-m centerpose_tpu_torch.evaluate`
    for `evaluate.py`; the port's runs start in the repo root."""
    assert len(port) == len(ref) > 0
    for (p, kw), (r, _) in zip(port, ref):
        assert p[1:3] == ["-m", "centerpose_tpu_torch.evaluate"] and r[1] == "evaluate.py"
        assert p[:1] + p[3:] == r[:1] + r[2:]
        assert kw["cwd"] == str(REPO)


def test_batch_eval_command_lines(tmp_path):
    """Every mode (7 and 8 with the same flags, as in the JAX script), a
    symmetric category, a model root and the image cap."""
    data, models, reports = (str(tmp_path / d) for d in ("data", "models", "reports"))
    argv = ["--data_root", data, "--model_root", models, "--categories", "shoe", "cup",
            "--modes", *map(str, range(9)), "--tracking", "--report_dir", reports, "--max_images", "3"]
    port = _commands(batch_eval.main, argv)
    ref = _commands(_jax_script("batch_eval").main, None, ["batch_eval.py", *argv])
    _same_commands(port, ref)
    assert len(port) == 18 and "100" in port[9][0]         # cup: --eval_num_symmetry 100
    assert port[7][0][-2:] == port[8][0][-2:] == ["--eval_gt_pre_hm_first", "--eval_empty_pre_hm"]
    # --eval_continue skips a combination whose report exists.
    open(os.path.join(reports, "shoe_mode0.txt"), "w").close()
    again = _commands(batch_eval.main, argv[:7] + ["--modes", "0", "--report_dir", reports, "--eval_continue"])
    assert len(again) == 1 and again[0][0][again[0][0].index("--report_file") + 1].endswith("cup_mode0.txt")


@pytest.mark.parametrize("baseline", [False, True], ids=["track", "baseline"])
def test_track_ablation_command_lines(tmp_path, baseline, monkeypatch):
    """The three (baseline: two) runs and the artifact of the JAX script; the
    default artifact goes under `exp/` of the caller's directory."""
    report = {"consistency": 0.5, "num_pred": 3, "num_gt": 2,
              "families": {"iou3d": {"ap": 0.25}, "2d": {"ap": 0.5}}}
    argv = ["--tfrecords", str(tmp_path / "*.tfrecord"), "--work_dir", str(tmp_path / "w"),
            "--max_images", "4", "--load_model", str(tmp_path / "ckpt")]
    argv += ["--baseline", "--arch", "res_18"] if baseline else []
    port = _commands(track_ablation.main, argv + ["--out", str(tmp_path / "port.json")], report=report)
    ref = _commands(_jax_script("track_ablation").main, None,
                    ["track_ablation.py", *argv, "--out", str(tmp_path / "jax.json")], report=report)
    _same_commands(port, ref)
    assert len(port) == (2 if baseline else 3)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    monkeypatch.chdir(tmp_path)
    _commands(track_ablation.main, argv, report=report)
    assert (tmp_path / "exp" / "track_ablation" / "TRACK_ABLATION.json").is_file()
