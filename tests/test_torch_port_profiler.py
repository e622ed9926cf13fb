"""The port's telemetry (`utils/profiler.py`) on the CPU: the registry's
spans, waits, counters and bounded buffers; its spans on a `torch.profiler`
timeline; `idle_by_span`; and the spans the Detector's batched stream and
the train step record.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from centerpose_tpu_torch.config import preset
from centerpose_tpu_torch.data import targets
from centerpose_tpu_torch.inference.detector import Detector
from centerpose_tpu_torch.models.factory import create_model
from centerpose_tpu_torch.training import trainer
from centerpose_tpu_torch.utils import profiler

from test_torch_port_training import annotations


@pytest.fixture
def reg():
    return profiler.Registry()


def _burn(ns):
    end = profiler.time.perf_counter_ns() + ns
    while profiler.time.perf_counter_ns() < end:
        pass


def test_spans_nest_with_parent_ids_and_self_time(reg):
    with reg.span("finish", chunk=7) as outer:
        _burn(200_000)
        with reg.span("pnp", solve=1) as inner:
            _burn(300_000)
            reg.wait("pnp.results", "cpu")
            reg.count("boxes", 5)
        reg.count("boxes")
    snap = reg.snapshot()
    rec = {name: s["records"][-1] for name, s in snap["spans"].items()}
    assert rec["finish"]["parent"] is None and rec["finish"]["ids"] == {"chunk": 7}
    assert rec["pnp"]["parent"] == "finish" and rec["pnp"]["ids"] == {"chunk": 7, "solve": 1}
    assert rec["wait.pnp.results"]["kind"] == "wait" and rec["wait.pnp.results"]["parent"] == "pnp"
    assert rec["wait.pnp.results"]["ids"] == {"chunk": 7, "solve": 1}
    # self time: the outer span less the inner one; wait time reaches the root
    assert rec["finish"]["self_ms"] == pytest.approx(rec["finish"]["ms"] - rec["pnp"]["ms"])
    assert rec["finish"]["self_ms"] >= 0.2 and rec["pnp"]["self_ms"] >= 0.3
    assert rec["finish"]["wait_ms"] == pytest.approx(rec["wait.pnp.results"]["ms"])
    assert outer.seconds == pytest.approx(rec["finish"]["ms"] / 1e3) and inner.seconds > 0
    # counters, and their tally on the root span (a wait counts itself)
    assert snap["counters"]["boxes"] == 6 and snap["counters"]["wait"] == 1
    assert rec["finish"]["counts"] == {"boxes": 6, "wait": 1} and rec["pnp"]["counts"] is None
    assert not any(r["profiled"] for r in rec.values())


def test_no_profiler_no_record_function_nor_tensor(reg, monkeypatch):
    """With no profiler active a span enters no `record_function` and makes
    no tensor: its cost is two clock reads and an append."""
    def refuse(*args, **kw):
        raise AssertionError("called with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch, "empty", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    with reg.span("submit", chunk=1):
        with reg.span("pre"):
            reg.count("wait")
    assert [r["profiled"] for r in reg.snapshot()["spans"]["submit"]["records"]] == [False]


def test_buffers_are_bounded_and_reset_forgets(reg, monkeypatch):
    monkeypatch.setattr(profiler, "CAPACITY", 3)
    for k in range(5):
        with reg.span("chunk", chunk=k):
            pass
    s = reg.snapshot()["spans"]["chunk"]
    assert s["count"] == 5 and [r["ids"]["chunk"] for r in s["records"]] == [2, 3, 4]
    assert s["total_ms"] >= sum(r["ms"] for r in s["records"])
    reg.count("wait")
    reg.reset()
    snap = reg.snapshot()
    assert snap["spans"] == {} and snap["phases"] == {} and "wait" not in snap["counters"]


def test_cpu_wait_and_phases_add_nothing_to_the_device(reg):
    """Off the card a wait is a zero-length span and `device_phases` marks
    nothing."""
    phases = reg.device_phases("step", ("forward", "loss"), "cpu")
    for _ in range(3):
        phases.mark()
    reg.wait("dets", torch.device("cpu"))
    snap = reg.snapshot()
    assert snap["phases"] == {} and snap["spans"]["wait.dets"]["records"][0]["ms"] < 1.0


def test_synced_is_one_wait_around_the_call(reg, monkeypatch):
    """`synced` drains nothing before the call: the whole call is one wait
    span, counted once, whose time reaches the enclosing spans as waiting."""
    def refuse(*args, **kw):
        raise AssertionError("synced must not synchronise the stream itself")

    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    with reg.span("finish", chunk=2):
        with reg.span("solve"):
            with reg.synced("pnp.svd"):
                _burn(300_000)
    snap = reg.snapshot()
    rec = {name: s["records"][-1] for name, s in snap["spans"].items()}
    assert set(rec) == {"finish", "solve", "wait.pnp.svd"}
    svd = rec["wait.pnp.svd"]
    assert svd["kind"] == "wait" and svd["parent"] == "solve" and svd["ids"] == {"chunk": 2}
    assert svd["ms"] >= 0.3 and rec["finish"]["wait_ms"] == pytest.approx(svd["ms"])
    assert snap["counters"]["wait"] == 1 and rec["finish"]["counts"] == {"wait": 1}


def test_spans_on_the_profiler_timeline(tmp_path):
    """Under `trace` the spans are `centerpose.*` ranges among the aten
    operators of the same trace, flagged as profiled, with their ids."""
    profiler.reset()
    with profiler.trace(str(tmp_path / "tr")) as prof:
        with profiler.span("finish", chunk=3):
            x = profiler.upload(np.ones((8, 8), np.float32), "cpu", "frames")
            torch.relu(x @ x)
    events = list(prof.events())
    ranges = {e.name: e for e in events if e.name.startswith("centerpose.")}
    assert {"centerpose.finish", "centerpose.wait.frames", "centerpose.upload"} <= set(ranges)
    outer = ranges["centerpose.finish"].time_range
    inside = [e.name for e in events if e.name.startswith("aten::")
              and outer.start <= e.time_range.start <= e.time_range.end <= outer.end]
    assert "aten::relu" in inside and "aten::mm" in inside
    recs = profiler.snapshot()["spans"]
    assert recs["finish"]["records"][0]["profiled"] and recs["upload"]["records"][0]["profiled"]
    assert {e.key for e in prof.key_averages()} >= {"aten::relu", "aten::mm"}
    assert (tmp_path / "tr" / "trace.json").is_file()
    profiler.reset()


def _event(name, start, end, cuda=False):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), device_type=kind)


def test_idle_by_span_on_a_hand_built_trace():
    """Kernels at 0-10, 30-40 and 45-100 us (idle 10-30 and 40-45); host
    spans `finish` 5-50 with `wait.dets` 12-20 and `fetch` 20-25 inside: the
    idle time goes to the innermost span at each moment."""
    events = [
        _event("kernel_a", 0, 10, cuda=True), _event("kernel_b", 30, 40, cuda=True),
        _event("kernel_c", 45, 100, cuda=True), _event("centerpose.finish", 5, 50),
        _event("centerpose.wait.dets", 12, 20), _event("centerpose.fetch", 20, 25),
        _event("aten::mm", 26, 29), _event("centerpose.net", 60, 70, cuda=True),
    ]
    idle = profiler.idle_by_span(events)
    assert idle == pytest.approx({"finish": 2e-6 + 5e-6 + 5e-6, "wait.dets": 8e-6, "fetch": 5e-6})
    assert sum(idle.values()) == pytest.approx(25e-6)
    late = events + [_event("kernel_d", 120, 130, cuda=True)]
    assert profiler.idle_by_span(late)[profiler.OUTSIDE] == pytest.approx(20e-6)
    assert profiler.idle_by_span([_event("centerpose.run", 0, 5)]) == {}


@pytest.fixture(scope="module")
def detector():
    cfg = preset("centerpose", input_h=64, input_w=64, vis_thresh=0.05, K=2)
    return Detector(cfg, device="cpu", seed=3)


def test_batch_stream_gives_one_span_tree_a_chunk(detector):
    """Three chunks through `run_batch_stream`: each chunk's `submit` and
    `finish` under one id, its stages and waits inside them, and the chunk's
    `times["pnp"]` the length of its `pnp` span."""
    rng = np.random.default_rng(0)
    chunks = [([rng.integers(0, 255, (48, 64, 3), dtype=np.uint8) for _ in range(2)], None)
              for _ in range(3)]
    profiler.reset()
    outs = list(detector.run_batch_stream(iter(chunks), timing=True))
    snap = profiler.snapshot()
    spans = snap["spans"]
    ids = [r["ids"]["chunk"] for r in spans["submit"]["records"]]
    assert len(ids) == 3 == len(set(ids)) and [r["ids"]["chunk"] for r in spans["finish"]["records"]] == ids
    for name, parent in (("pre", "submit"), ("wait.frames", "submit"), ("wait.transforms", "submit"),
                         ("net", "submit"), ("wait.dets", "finish"), ("post", "finish"), ("merge", "finish"),
                         ("pnp", "finish"), ("assemble", "pnp"), ("wait.pnp.points", "pnp"),
                         ("solve", "pnp"), ("wait.pnp.svd", "solve"), ("consume", "pnp")):
        recs = spans[name]["records"]
        assert {r["parent"] for r in recs} == {parent}, name
        assert sorted({r["ids"]["chunk"] for r in recs}) == sorted(ids), name
    assert len(spans["post"]["records"]) == 3 and len(spans["merge"]["records"]) == 3
    assert [o[0]["times"]["pnp"] for o in outs] == pytest.approx([r["ms"] / 1e3 for r in spans["pnp"]["records"]],
                                                                  rel=1e-12)
    assert set(outs[0][0]["times"]) == {"pre", "net", "post", "merge", "pnp", "tot"}
    # every chunk waits at the same sites, tallied on its two root spans
    per_chunk = {k: 0 for k in ids}
    for name in ("submit", "finish"):
        for r in spans[name]["records"]:
            per_chunk[r["ids"]["chunk"]] += r["counts"]["wait"]
    waits = sum(s["count"] for n, s in spans.items() if n.startswith("wait."))
    assert len(set(per_chunk.values())) == 1 and sum(per_chunk.values()) == waits == snap["counters"]["wait"]
    assert snap["phases"] == {}                       # no device events off the card
    profiler.reset()


def test_run_gives_its_stages_spans(detector):
    frame = np.random.default_rng(1).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    profiler.reset()
    out = detector.run(frame)
    spans = profiler.snapshot()["spans"]
    assert {r["parent"] for n in ("pre", "net", "post", "merge", "pnp", "track")
            for r in spans[n]["records"]} == {"run"}
    assert spans["upload"]["records"][0]["parent"] == "pre" and spans["wait.dets"]["records"][0]["parent"] == "net"
    assert out["times"]["pnp"] == pytest.approx(spans["pnp"]["records"][0]["ms"] / 1e3, rel=1e-12)
    assert out["times"]["tot"] == pytest.approx(spans["run"]["records"][0]["ms"] / 1e3, rel=1e-12)
    profiler.reset()


def test_train_step_records_its_four_phases():
    res, bsz = 64, 2
    cfg = preset("centerpose", input_h=res, input_w=res, batch_size=bsz)
    model = create_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    state, tx = trainer.create_train_state(cfg, model)
    step = trainer.make_train_step(cfg, model, tx)
    rng = np.random.RandomState(0)
    batch = targets.stack_batch([targets.render_targets(annotations(targets, cfg, rng), cfg) for _ in range(bsz)])
    batch["input"] = rng.randn(bsz, res, res, 3).astype(np.float32)
    profiler.reset()
    for _ in range(2):
        state, _ = step(state, batch)
    spans = profiler.snapshot()["spans"]
    assert [r["ids"] for r in spans["step"]["records"]] == [{"step": 0}, {"step": 1}]
    for name in trainer.PHASES:
        recs = spans[name]["records"]
        assert [r["parent"] for r in recs] == ["step", "step"] and [r["ids"]["step"] for r in recs] == [0, 1]
    first = [spans[n]["records"][0] for n in trainer.PHASES]
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(first, first[1:]))
    assert "wait" not in profiler.snapshot()["counters"]       # the step never waits
    profiler.reset()
