"""Builds the package's CUDA sources into shared libraries and loads them.

Each `csrc/<name>.cu` has a plain C interface and becomes
`build/lib<name>-<hash>.so`, compiled by `nvcc` for `sm_90a` at first use and
loaded with `ctypes` (no PyTorch headers, so a build takes seconds). The hash
covers every file under `csrc/` and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded. `build/` is not committed.

Nothing here runs when the package is imported: `load()` is called by a
kernel's wrapper when it is first given a CUDA tensor. A missing compiler or a
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    candidates = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or /usr/local/cuda): "
        "the CUDA kernels of centerpose_tpu_torch are compiled on the GPU host"
    )


def sources() -> List[str]:
    """Names of the kernels' sources (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}-{_source_hash()}.so"


class _Job:
    """One running nvcc: `csrc/<name>.cu` → a temporary file beside its library."""

    def __init__(self, name: str):
        self.name = name
        self.out = library_path(name)
        src = CSRC / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(src)
        BUILD.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        self.cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(self.tmp), str(src)]
        self.proc = subprocess.Popen(
            self.cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )

    def finish(self) -> None:
        log, _ = self.proc.communicate()
        self.out.with_suffix(".log").write_text(log or "")
        if self.proc.returncode != 0:
            if self.tmp.exists():
                self.tmp.unlink()
            raise RuntimeError(
                f"nvcc failed for {self.name} ({' '.join(self.cmd)}):\n{log}"
            )
        os.replace(self.tmp, self.out)  # atomic: no half-written library


def _compile(names: List[str]) -> None:
    """One nvcc for each source without a current library, all started
    together, then all waited for."""
    jobs = [_Job(n) for n in names if not library_path(n).exists()]
    for job in jobs:
        job.finish()


def build_all() -> Dict[str, str]:
    """Build every source that has no current library, one nvcc each, all
    started together. Returns {name: compiler output (registers, shared
    memory, spills per kernel)}."""
    with _lock:
        names = sources()
        _compile(names)
        return {n: build_log(n) for n in names}


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if need be."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            _compile([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
