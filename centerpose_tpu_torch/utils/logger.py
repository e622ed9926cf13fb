"""Experiment logger: opt dump, timestamped text log, TensorBoard summaries.

Parity target: `Logger` (src/lib/logger.py:24-92). Scalars go to a jsonl file
plus native TensorBoard event files (utils/tbevents.py — the image has no
tensorboard/tensorboardX package, so the Event protos are encoded directly);
debug images (trains/object_pose.py:218-401 canvases) go to the same event
stream via `image()`. The file layout (opt.txt, log.txt, scalars, tb/) matches
the reference's experiment-directory convention.

The PyTorch package's own copy of `centerpose_tpu/utils/logger.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Mapping


class Logger:
    def __init__(self, exp_dir: str, config=None, tensorboard: bool = True):
        os.makedirs(exp_dir, exist_ok=True)
        self.exp_dir = exp_dir
        self.log_path = os.path.join(exp_dir, "log.txt")
        self.scalar_path = os.path.join(exp_dir, "scalars.jsonl")
        if config is not None:
            with open(os.path.join(exp_dir, "opt.txt"), "w") as f:
                if dataclasses.is_dataclass(config):
                    for k, v in sorted(dataclasses.asdict(config).items()):
                        f.write(f"{k}: {v}\n")
                else:
                    f.write(str(config))
        self._start = time.time()
        self._tb = None
        if tensorboard:
            from centerpose_tpu_torch.utils.tbevents import TBEventWriter

            self._tb = TBEventWriter(os.path.join(exp_dir, "tb"))

    def write(self, msg: str):
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        with open(self.log_path, "a") as f:
            f.write(f"[{stamp}] {msg}\n")

    def scalars(self, step: int, values: Mapping[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time() - self._start}
        rec.update({f"{prefix}{k}": float(v) for k, v in values.items()})
        with open(self.scalar_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.scalar(f"{prefix}{k}", float(v), int(step))

    def image(self, step: int, tag: str, rgb) -> None:
        """[H, W, 3] uint8 image summary (reference: debugger canvases saved
        to opt.debug_dir; here they additionally reach TensorBoard)."""
        if self._tb is not None:
            self._tb.image(tag, rgb, int(step))

    def close(self):
        if self._tb is not None:
            self._tb.close()
