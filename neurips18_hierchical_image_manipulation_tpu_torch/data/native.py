"""The C++ tier of the host data path: ``csrc/dataio.cpp`` through ctypes.

Counterpart of ``data/native.py`` in the JAX package, built from the
port's own copy of the source: at first use ``g++`` compiles it into the
package's ``_build/`` directory (git-ignored), under a file name that
carries a digest of the source, so an edited source is never served by a
stale build. Nothing is compiled at import time.

Each entry point returns what its numpy form in ``hostops`` returns, bit
for bit, and falls back to it when the library cannot be built or loaded.
``available()`` says which tier runs; ``tier()`` names it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from . import hostops

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "dataio.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()
build_error = ""   # the compiler's message when the build failed


def lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libhimandataio_{digest}.so")


def build() -> bool:
    """Compile the source unless it is built; True when the library exists."""
    global build_error
    lib = lib_path()
    if os.path.exists(lib):
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        build_error = "no C++ compiler (g++) on PATH"
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                              text=True, timeout=300)
    except (subprocess.SubprocessError, OSError) as e:
        build_error = str(e)
        return False
    if proc.returncode != 0:
        build_error = proc.stderr
        return False
    os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        lib = ctypes.CDLL(lib_path())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = ctypes.c_int32
        lib.himan_extract_bboxes.argtypes = [i32p, i32, i32, i32, i32p, i32]
        lib.himan_extract_bboxes.restype = i32
        lib.himan_u8_to_pm1.argtypes = [u8p, f32p, ctypes.c_int64]
        lib.himan_u8_to_pm1.restype = None
        lib.himan_nearest_resize_i32.argtypes = [i32p, i32, i32, i32p, i32, i32]
        lib.himan_nearest_resize_i32.restype = None
        lib.himan_box_mask_f32.argtypes = [f32p, i32, i32, i32, i32, i32, i32]
        lib.himan_box_mask_f32.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the C++ tier is built and loaded (building it if need be)."""
    return _load() is not None


def tier() -> str:
    return "native" if available() else "numpy"


def extract_bboxes(inst: np.ndarray, min_id: int = 1000, max_records: int = 256):
    """(H,W) instance map -> [{inst_id, cls, bbox=(y0,x0,h,w)}] for every id
    >= min_id, in ascending id order (``hostops.extract_bboxes``)."""
    lib = _load()
    if lib is None:
        return hostops.extract_bboxes(inst, min_id)
    inst = np.ascontiguousarray(inst, np.int32)
    while True:
        # the library stops writing at the buffer's end; a full buffer may
        # have dropped records, so grow it and scan again
        out = np.zeros((max_records, 6), np.int32)
        n = lib.himan_extract_bboxes(inst, inst.shape[0], inst.shape[1], min_id, out,
                                     max_records)
        if n < max_records:
            break
        max_records *= 4
    recs = out[:n]
    recs = recs[np.argsort(recs[:, 0], kind="stable")]
    return [{"inst_id": int(r[0]), "cls": int(r[1]),
             "bbox": [int(r[2]), int(r[3]), int(r[4]), int(r[5])]} for r in recs]


def u8_to_pm1(img: np.ndarray) -> np.ndarray:
    """uint8 array -> float32 in [-1, 1]."""
    lib = _load()
    if lib is None:
        return hostops.u8_to_pm1(img)
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    lib.himan_u8_to_pm1(img, out, img.size)
    return out


def nearest_resize_i32(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest-neighbour resize of an int map to (oh, ow), pixel centers."""
    lib = _load()
    if lib is None:
        return hostops.nearest_resize_i32(arr, oh, ow)
    arr = np.ascontiguousarray(arr, np.int32)
    out = np.empty((oh, ow), np.int32)
    lib.himan_nearest_resize_i32(arr, arr.shape[0], arr.shape[1], out, oh, ow)
    return out


def box_mask_f32(h: int, w: int, y0: int, x0: int, bh: int, bw: int) -> np.ndarray:
    """(h, w, 1) float32 mask, 1 inside the (y0, x0, bh, bw) box."""
    lib = _load()
    if lib is None:
        return hostops.box_mask_f32(h, w, y0, x0, bh, bw)
    out = np.empty((h, w), np.float32)
    lib.himan_box_mask_f32(out, h, w, y0, x0, bh, bw)
    return out[..., None]
