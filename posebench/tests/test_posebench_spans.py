"""The readers of the program's telemetry (`posebench/spans.py` and the
metrics that read it) on a snapshot filled by hand, on a real one from the
program's registry, and without the telemetry."""

import pytest

from posebench import harness, spans

BENCH = harness.benchmark()
READERS = ("host_busy_ms.serve", "host_wait_ms.serve", "syncs_per_chunk.serve", "model_ms.serve",
           "fwd_ms.train", "loss_ms.train", "bwd_ms.train", "opt_ms.train")


def _root(name, chunk, ms, wait_ms, waits, profiled=False):
    return {"name": name, "kind": "work", "ms": ms, "self_ms": ms, "wait_ms": wait_ms, "parent": None,
            "ids": {"chunk": chunk}, "profiled": profiled, "counts": {"wait": waits}}


def _step(fwd, loss, bwd, opt, profiled=False):
    return {"ids": {"step": 0}, "profiled": profiled,
            "ms": {"forward": fwd, "loss": loss, "backward": bwd, "optimizer": opt}}


HAND = {
    "spans": {
        # chunk 0: submit 30 ms (10 waiting), finish 200 (90 waiting), 16 waits
        # chunk 1: submit 40 (20), finish 220 (100), 16 waits
        # chunk 2: finish profiled, so left out; chunk 3: no finish yet, left out
        "submit": {"count": 4, "total_ms": 150.0, "records": [
            _root("submit", 0, 30.0, 10.0, 2), _root("submit", 1, 40.0, 20.0, 2),
            _root("submit", 2, 50.0, 5.0, 2), _root("submit", 3, 30.0, 5.0, 2)]},
        "finish": {"count": 3, "total_ms": 620.0, "records": [
            _root("finish", 0, 200.0, 90.0, 14), _root("finish", 1, 220.0, 100.0, 14),
            _root("finish", 2, 200.0, 100.0, 14, profiled=True)]},
    },
    "phases": {
        "model": {"count": 4, "total_ms": 0.0, "records": [
            {"ids": {"chunk": k}, "profiled": k == 2, "ms": {"model": ms}}
            for k, ms in enumerate((120.0, 130.0, 500.0, 125.0))]},
        "step": {"count": 4, "total_ms": 0.0, "records": [
            _step(150.0, 10.0, 300.0, 8.0), _step(140.0, 12.0, 310.0, 9.0), _step(145.0, 11.0, 305.0, 7.0),
            _step(900.0, 90.0, 900.0, 90.0, profiled=True)]},
    },
    "counters": {"wait": 64},
}
EXPECTED = {"host_busy_ms.serve": (130.0 + 140.0) / 2, "host_wait_ms.serve": (100.0 + 120.0) / 2,
            "syncs_per_chunk.serve": 16.0, "model_ms.serve": 125.0, "fwd_ms.train": 145.0,
            "loss_ms.train": 11.0, "bwd_ms.train": 305.0, "opt_ms.train": 8.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_filled_snapshot(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: HAND)
    assert harness.metric_reader(name)({}, None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_programs_telemetry(name, monkeypatch):
    """A program with no such registry (or one that recorded nothing, as the
    CPU records no device phases) reads nothing and raises nothing."""
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert harness.metric_reader(name)({}, None) is None
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": {}, "phases": {}, "counters": {}})
    assert harness.metric_reader(name)({}, None) is None


def test_snapshot_is_none_only_without_the_registry(monkeypatch):
    """A program whose profiler has no `snapshot` gives None; an error
    raised inside the program's `snapshot` is not hidden."""
    from centerpose_tpu_torch.utils import profiler

    def broken():
        raise AttributeError("a fault inside the registry")

    monkeypatch.setattr(profiler, "snapshot", broken)
    with pytest.raises(AttributeError, match="inside the registry"):
        spans.snapshot()
    monkeypatch.delattr(profiler, "snapshot")
    assert spans.snapshot() is None


def test_readers_are_declared_for_their_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in READERS:
        cell = "serve_b64.dlav1_34" if name.endswith(".serve") else "train_b32.dlav1_34"
        assert entries[name]["workloads"] == [cell] and entries[name]["better"] == "lower"


def test_chunks_from_the_programs_registry():
    """The program's own registry, filled through its span API, reads as
    the hand-filled one does."""
    from centerpose_tpu_torch.utils import profiler

    reg = profiler.Registry()
    for chunk in range(2):
        with reg.span("submit", chunk=chunk):
            reg.wait("frames", "cpu")
        with reg.span("finish", chunk=chunk):
            reg.wait("dets", "cpu")
            with reg.span("pnp"):
                reg.wait("pnp.results", "cpu")
    got = spans.chunks(reg.snapshot())
    assert len(got) == 2 and all(c["waits"] == 3 and c["busy_ms"] >= 0 and c["wait_ms"] >= 0 for c in got)
