"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every ``fast_srgan_torch/csrc/*.cu`` file is compiled by one nvcc call into
one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), for ``sm_90a`` (Hopper). The library lands in
``fast_srgan_torch/_build/`` under a name that carries a hash of the sources
and flags, so an edited source builds anew and an unchanged one loads the
existing file. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

# Entry points and their one signature: (x, alpha, out, partial, B, HW, C,
# tile_px, eps, stream) -> cudaError_t as int.
_ENTRY_POINTS = ("fsr_instance_norm_prelu_bf16", "fsr_instance_norm_prelu_f32")
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
#: nvcc's report of the last build in this process (ptxas registers, shared
#: memory, spills), or None if the library was already on disk.
build_log: Optional[str] = None


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def source_hash(paths: List[Path]) -> str:
    """Hash of the sources' names and bytes and of the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
        " the CUDA kernels of fast_srgan_torch are built at first use"
    )


def build() -> Path:
    """Compile the sources unless a library for their hash exists; return
    the library's path. Raises RuntimeError with nvcc's stderr on failure."""
    global build_log
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    lib_path = BUILD_DIR / f"libfast_srgan_kernels_{source_hash(srcs)}.so"
    if lib_path.exists():
        build_log = None
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    build_log = proc.stdout + proc.stderr
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
            _library = lib
        return _library
