"""BENCHMARK.json keeps to the benchmark's contract, and every cell, metric
and driver resolves to its files by name."""

import json
import re

import pytest

from posebench import flops, harness
from posebench.reference import net as refnet

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["why"]) and one_line(entry["source"])
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    assert harness.load_json(harness.ROOT / entry["file"])["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads_resolve(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and one_line(entry["why"])
    assert entry["chips"] in (1, 4)
    cell = harness.cell(entry["name"], 1, 1.0, False, device="cpu")
    assert cell.config["name"] == entry["config"]
    assert callable(harness.driver(cell.traffic["driver"]).run)
    assert cell.config["name"] in cell.traffic["limits"]
    e2e = [m for m in BENCH["end_to_end"] if harness.applies(m, entry["name"])]
    assert {m["name"] for m in e2e} >= {"setup_s"} and len(e2e) >= 2
    assert any(harness.applies(m, entry["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metrics(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", names)) <= names
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(metric["layer"])
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert all(harness.applies(moves, w) for w in metric.get("workloads", names))
        assert callable(harness.metric_reader(metric["name"]))


def test_metric_names_unique():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_work_counted_by_hand():
    """One DCN call and one small network, counted by hand."""
    b, h, w, c, co = 8, 16, 16, 512, 256
    flop = 2.0 * b * h * w * 9 * c * co
    nbytes = 2 * (b * h * w * (c + 18 + 9 + co) + 9 * c * co + co)
    assert flops.dcn_fwd_bound_s(b, h, w, c, co, "bfloat16") == pytest.approx(max(flop / 989e12, nbytes / 3.35e12))
    m = b * h * w
    bwd_flop = 2 * flop
    bwd_bytes = 4 * (m * (18 + 9 + co) + m * c + 9 * c * co + m * c + m * 27 + 9 * c * co)
    assert flops.dcn_bwd_bound_s(b, h, w, c, co) == pytest.approx(max(bwd_flop / (495e12 / 3), bwd_bytes / 3.35e12))

    spec = refnet.NetSpec("dlav1_34")
    total, calls = flops.network_work(spec, (64, 64))
    assert len(calls) == 16 and calls[0] == (2, 2, 512, 256)
    # the first conv: 7x7, 3 -> 16, at 64x64
    assert total > 2.0 * 64 * 64 * 16 * 3 * 49
    # each DCN product counted once: 2 * H * W * 9 * C * Co
    dcn = sum(2.0 * hh * ww * 9 * cc * oo for hh, ww, cc, oo in calls)
    assert 0 < dcn < total
