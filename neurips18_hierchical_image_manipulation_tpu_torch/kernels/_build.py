"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library under
``_build/`` (listed in ``.gitignore``), then loaded with ``ctypes``.
Nothing is compiled at import time, so the CPU tier never needs ``nvcc``.

The library's file name carries a digest of its source, so an edited
source is never served by a stale build. ``build_all`` starts one ``nvcc``
per source at once, so a cold build costs the slowest source, not the sum.
``ptxas_info`` keeps each build's ``-Xptxas -v`` report (registers, shared
memory, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_info: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise KernelBuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp_path, lib_path) or
    None when the library is already built."""
    lib = _lib_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    ptxas_info[name] = out
    os.replace(tmp, lib)


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, all at once."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def stream_for(device) -> int:
    """The current stream of ``device`` as an int for the C entry points.
    A launch goes to the current device's context, so a tensor on another
    card is refused rather than launched there."""
    import torch

    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {device} but the current device is cuda:"
            f"{torch.cuda.current_device()}; use torch.cuda.device({device.index})"
        )
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise KernelLaunchError(f"{what}: CUDA error {err}")
