"""ctypes binding for the native C++ crop-extraction backend: the port of
``fast_srgan_tpu/data/native.py``.

Builds ``fast_srgan_torch/csrc/fastsr_loader.cpp`` with g++ on first use
into ``fast_srgan_torch/_build/`` (no pybind11: the ABI is 5 plain C
functions). The backend is optional: a host without g++ takes the numpy
mmap path of :class:`~fast_srgan_torch.data.pipeline.CropSampler`, which
gives the same batches. It is a host loader, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "fastsr_loader.cpp"
_BUILD_DIR = _PKG / "_build"
_GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_build_lock = threading.Lock()


def _lib_path() -> Path:
    """The library's path, named by a hash of the source and flags, so an
    edited source builds anew."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libfastsr_loader_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    lib = _lib_path()
    with _build_lock:
        if lib.exists():
            return lib
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile to a per-process temp name and os.replace (atomic on
        # POSIX): the lock only covers threads, and concurrent *processes*
        # racing on the same -o target could dlopen a half-written .so.
        tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
        try:
            subprocess.run(
                ["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, lib)
        except (subprocess.SubprocessError, OSError):
            tmp.unlink(missing_ok=True)
            return None
    return lib


_lib_handle = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _lib_failed
    if _lib_handle is not None or _lib_failed:
        return _lib_handle
    path = _build() if _SRC.exists() else None
    if path is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.fsr_open.restype = ctypes.c_void_p
    lib.fsr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32]
    lib.fsr_close.restype = None
    lib.fsr_close.argtypes = [ctypes.c_void_p]
    lib.fsr_num_files.restype = ctypes.c_int32
    lib.fsr_num_files.argtypes = [ctypes.c_void_p]
    lib.fsr_shapes.restype = None
    lib.fsr_shapes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.fsr_crop_batch.restype = ctypes.c_int32
    lib.fsr_crop_batch.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    _lib_handle = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeCropDataset:
    """Native mmap'd view over uint8 HWC .npy files with batch crop gather."""

    def __init__(self, paths: Sequence[str], threads: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++ / build failed)")
        self._lib = lib
        self.threads = threads
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths]
        )
        self._handle = lib.fsr_open(arr, len(paths))
        if not self._handle:
            raise RuntimeError(
                "fsr_open failed (unreadable file or unsupported .npy layout)"
            )
        n = lib.fsr_num_files(self._handle)
        hw = (ctypes.c_int64 * (2 * n))()
        lib.fsr_shapes(self._handle, hw)
        self.shapes = np.array(hw, dtype=np.int64).reshape(n, 2)

    def crop_batch(
        self, file_idx: np.ndarray, tops: np.ndarray, lefts: np.ndarray,
        crop: int,
    ) -> np.ndarray:
        batch = len(file_idx)
        out = np.empty((batch, crop, crop, 3), np.uint8)
        # Thread spawn costs ~50us each; only fan out when there is enough
        # memcpy work to amortize it (cold page-fault-heavy gathers benefit,
        # small warm-cache batches don't).
        threads = self.threads if out.nbytes >= (1 << 22) else 1
        rc = self._lib.fsr_crop_batch(
            self._handle,
            np.ascontiguousarray(file_idx, np.int32),
            np.ascontiguousarray(tops, np.int32),
            np.ascontiguousarray(lefts, np.int32),
            batch, crop, out, threads,
        )
        if rc != 0:
            raise ValueError("fsr_crop_batch: index or offset out of range")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.fsr_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
