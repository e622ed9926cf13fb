"""What decides `correct` fails when it should, at a size the CPU holds:

- the control, the reference one precision step below the configuration's
  (fp8 for the bf16-served network, bf16 autocast for the float32 training
  step), against the reference, fails a limit of the cell;
- a run driven with the timed path broken underneath (the chip look
  skipped, the rest of the run as it is) comes out not correct, once for
  each fault the cell can have: an answer altered where it is produced, half
  of each batch left out, a step that leaves the state unchanged."""

import time

import pytest

from posebench import checks, harness, readings
from posebench.tests.conftest import tiny_cell


def failed_limits(numbers, cell):
    return [v for v in checks.judge(numbers, cell.traffic["limits"][cell.config["name"]]) if not v["ok"]]


def test_serve_control_fails():
    cell = tiny_cell("serve_b64.dlav1_34")
    cell.traffic.update(check_images=8)
    assert failed_limits(readings.control_serve(cell), cell)


def test_train_control_fails():
    cell = tiny_cell("train_b32.dlav1_34")
    assert failed_limits(readings.control_train(cell), cell)


@pytest.mark.parametrize("workload,fault", [("serve_b64.dlav1_34", "answer"),
                                            ("serve_b64.dlav1_34", "half_batch"),
                                            ("train_b32.dlav1_34", "unchanged"),
                                            ("train_b32.dlav1_34", "half_batch")])
def test_planted_fault_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    cell.fault = fault
    result = harness.driver(cell.traffic["driver"]).run(cell, time.perf_counter())
    assert not result.correct
