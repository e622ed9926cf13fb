"""The device a measuring entry point runs on (`bench.py`, `graft_entry.py`,
`scripts/bench_e2e.py`, `scripts/bench_train.py`).

`require_device("cuda")` refuses a host without a GPU: a measurement never
moves to the CPU by itself; only a caller that asks for the CPU gets it.
`announce(device)` prints, to stderr, the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them
(a card set below its 700 W runs slower under load, so every number is
kept beside that line), or `cpu`.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Union

import torch


def require_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device here (pass device='cpu' to run on the CPU)")
    return dev


def card_line(device: Union[str, torch.device]) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def announce(device: Union[str, torch.device]) -> None:
    print(card_line(device), file=sys.stderr, flush=True)
