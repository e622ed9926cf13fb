"""Host C++ of the evaluation: the exact oriented 3D box IoU and its symmetry
sweep (`iou3d.cpp`), loaded with `ctypes`.

The PyTorch package's own copy of the JAX package's native IoU library
(`centerpose_tpu/native/__init__.py`, `native/iou3d.cpp`), without its DCN
parity oracle. `iou3d.cpp` is compiled with `g++ -O3 -march=native -shared
-fPIC` at first use into `build/libiou3d-<hash>.so`; the hash covers the
source and the flags (as `_build.py` does for the CUDA sources), so an edited
source is rebuilt and a stale library is never loaded. A missing compiler or
a failed build raises: there is no quiet fallback. The numpy path of
`evaluation/iou3d.py` (`use_native=False`) is the plain version the library
is held against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "iou3d.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD / f"libiou3d-{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the 3D IoU library is compiled at first use")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a library


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            d = ctypes.POINTER(ctypes.c_double)
            lib.iou3d.restype = ctypes.c_double
            lib.iou3d.argtypes = [d] * 6
            lib.iou3d_symmetry_sweep.restype = ctypes.c_double
            lib.iou3d_symmetry_sweep.argtypes = [d] * 6 + [ctypes.c_int]
            _lib = lib
        return _lib


def _pointers(*arrays):
    """float64 C-contiguous copies and their pointers (the copies must outlive the call)."""
    held = [np.ascontiguousarray(np.asarray(a, np.float64)) for a in arrays]
    return held, [a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in held]


def iou3d_native(r1, t1, s1, r2, t2, s2) -> float:
    _held, ptrs = _pointers(r1, t1, s1, r2, t2, s2)
    return float(get_lib().iou3d(*ptrs))


def iou3d_sweep_native(r1, t1, s1, r2, t2, s2, n: int) -> float:
    _held, ptrs = _pointers(r1, t1, s1, r2, t2, s2)
    return float(get_lib().iou3d_symmetry_sweep(*ptrs, int(n)))
