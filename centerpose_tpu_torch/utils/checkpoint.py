"""Checkpoints of the PyTorch package: save, load, latest step, partial init.

Counterpart of `centerpose_tpu/utils/checkpoint.py` (parity target:
src/lib/models/model.py:34-105 — checkpoints hold {epoch, state_dict,
optimizer}; `--resume` restores the optimizer and the LR schedule, which is a
function of the update count, so restoring the count restores the LR), on
`torch.save` / `torch.load(weights_only=True)` instead of orbax.

Layout: one directory per step under a root, as the JAX package's orbax
manager lays it out (`train.py` writes roots `ckpt/`, `best/` and
`epoch_N/`): `<root>/<step>/checkpoint.pt`, holding

  step        the number of updates made;
  state_dict  the model's `state_dict()`: parameters and BatchNorm buffers,
              under the reference's names (`models/layers.py`);
  optimizer   `ClippedAdam`'s update count and Adam's `state_dict()` (the
              moments and their step per parameter);
  metadata    what the caller passes (`train.py`: the config as a dict).

A file is written beside its final name and renamed, so a crash leaves no
half-written checkpoint. The JAX package's orbax checkpoints are not readable
here (that needs jax and orbax, which this package does not import);
`load_partial` reads this package's checkpoints. `load_for_inference` loads
the weights that serving and evaluation need from either kind of file the
package reads: a reference `.pth` or one of these directories.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from centerpose_tpu_torch.models.convert import load_reference_state_dict

_FILE = "checkpoint.pt"


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, str(int(step)), _FILE)


def latest_step(directory: str) -> Optional[int]:
    """The largest step with a checkpoint under `directory`, None if none."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory)
             if d.isdigit() and os.path.isfile(os.path.join(directory, d, _FILE))]
    return max(steps) if steps else None


def save_checkpoint(directory: str, state, step: int, metadata: Optional[dict] = None) -> str:
    """Write `state` (a `training/trainer.py::TrainState`: model, optimizer)
    at `step` under `directory`; returns the file's path."""
    path = _path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "step": int(step),
        "state_dict": state.model.state_dict(),
        "optimizer": {"count": int(state.tx.count), "adam": state.tx.adam.state_dict()},
        "metadata": metadata or {},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(directory: str, step: Optional[int], device) -> dict:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return torch.load(_path(directory, step), map_location=device, weights_only=True)


def load_checkpoint(directory: str, state, step: Optional[int] = None):
    """Restore `state` in place from the checkpoint at `step` (None: the
    latest, the reference's `--resume` → model_last) — parameters, BatchNorm
    buffers, Adam's moments, the update count and `state.step`. Returns
    (state, step)."""
    device = next(state.model.parameters()).device
    ckpt = _read(directory, step, device)
    state.model.load_state_dict(ckpt["state_dict"])
    state.tx.adam.load_state_dict(ckpt["optimizer"]["adam"])
    state.tx.count = int(ckpt["optimizer"]["count"])
    state.step = int(ckpt["step"])
    return state, state.step


def load_partial(directory: str, model: torch.nn.Module,
                 step: Optional[int] = None) -> Tuple[int, int]:
    """The reference's `load_model` partial init (model.py:34-87): copy, in
    place, every tensor of `model.state_dict()` whose name is in the
    checkpoint with the same shape (cast to the model's type); keep the rest
    at their init, with a line for each shape mismatch. This is how a Track
    model starts from CenterPose weights (the shared trunk and neck load,
    the twin stems and tracking heads stay). The optimizer and the step are
    not read. Returns (n_loaded, n_skipped), counted over the model's
    tensors."""
    src = _read(directory, step, "cpu")["state_dict"]
    loaded = skipped = 0
    with torch.no_grad():
        for name, dst in model.state_dict().items():
            val = src.get(name)
            if val is not None and tuple(val.shape) == tuple(dst.shape):
                dst.copy_(val.to(dst.dtype))
                loaded += 1
            else:
                if val is not None:
                    print(f"load_partial: shape mismatch at {name}: "
                          f"{tuple(val.shape)} vs {tuple(dst.shape)}, keeping init")
                skipped += 1
    return loaded, skipped


def load_for_inference(path: str, model: torch.nn.Module) -> None:
    """Load weights into `model`, in place, for serving or evaluation (the
    JAX package's `demo.py::_load_variables`). `path` is either
    - a reference checkpoint file (`{epoch, state_dict, ...}` or a bare
      state dict, `.pth`), read by `models/convert.py::
      load_reference_state_dict`; or
    - a directory this package's `train.py` wrote: a root (`ckpt/`,
      `best/`, `epoch_N/`), whose latest step is read, or one step's
      directory `<root>/<step>`. Its parameters and BatchNorm buffers are
      loaded; the optimizer is not read."""
    step_file = os.path.join(path, _FILE)
    if os.path.isfile(step_file):                       # <root>/<step>
        ckpt = torch.load(step_file, map_location="cpu", weights_only=True)
    elif os.path.isdir(path):                           # a root: its latest step
        ckpt = _read(path, None, "cpu")
    else:
        ckpt = torch.load(path, map_location="cpu")
    load_reference_state_dict(model, ckpt)
