"""Shared pieces of the benchmark's own tests (run from the repository root:
`python -m pytest posebench/tests -q -p no:cacheprovider`).

Tests that need the card carry the `card` marker and skip inside the
`card` fixture when no CUDA device is there."""

import pytest
import torch

from posebench import harness

TINY_SEED = 2 ** 31 + 77


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda")


def tiny_cell(workload: str, seed: int = TINY_SEED, seconds: float = 1.0, trace: bool = False):
    """The cell at a size the CPU runs in seconds: 64x64 inputs, a few
    frames or rows. Only sizes change; the paths, thresholds and limits are
    the cell's."""
    cell = harness.cell(workload, seed, seconds, trace, device="cpu")
    cell.config.update(input_h=64, input_w=64)
    driver = cell.traffic["driver"]
    if driver == "serve":
        cell.traffic.update(chunk=4, frame_hw=[60, 80], low_hw=[8, 10], pool_chunks=2, warmup_chunks=1,
                            check_images=4, profile_chunks=1)
    elif driver == "train":
        cell.config.update(train_batch_size=4)
        cell.traffic.update(low_hw=[8, 8], profile_steps=1)
    return cell
