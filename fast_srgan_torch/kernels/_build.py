"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every ``fast_srgan_torch/csrc/*.cu`` file is compiled by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), for ``sm_90a`` (Hopper). The library lands in
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

#: nvcc's flags for each source's object (the link adds only -shared).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (x, alpha or skip, out, partial, B, HW, C, grid, per_wave, tile, eps,
#  stream)
_IN = [_P] * 4 + [_I] * 6 + [_F, _P]
# (x, alpha or skip, valid_h, valid_w, out, partial, B, HW, W, C, grid,
#  per_wave, tile, eps, stream)
_IN_MASKED = [_P] * 6 + [_I] * 7 + [_F, _P]
# (x, totals, scratch, B, HW, C, tiles, stream)
_IN_STATS = [_P] * 3 + [_I] * 4 + [_P]
# (x, alpha or skip, totals, out, B, HW, C, n_parts, count, tiles, eps,
#  stream)
_IN_FROM_STATS = [_P] * 4 + [_I] * 6 + [_F, _P]
# (x, weight, bias, alpha, out, B, H, W, C, prelu, stream)
_FUSED_UPSAMPLE = [_P] * 5 + [_I] * 5 + [_P]
# (x, weight, mult, bias, alpha, rscale, out, B, H, W_in, Cin, Cout, n_tile,
#  KH, pad_top, pad_left, pad_right, stream)
_INT8_CONV = [_P] * 7 + [_I] * 10 + [_P]
# (x, weight, mult, bias, alpha, out, B, H, W_in, Cin, Cout, n_tile, pad_left,
#  pad_right, stream)
_INT8_PHASES = [_P] * 6 + [_I] * 8 + [_P]
# (x, scale, out, n (64-bit), stream)
_QUANTIZE = [_P] * 3 + [ctypes.c_longlong, _P]
# (x, bias, slope or NULL, out, B, Hin, Win, C, H, W, p, q, border, stream)
_TAIL_EPILOGUE = [_P] * 4 + [_I] * 9 + [_P]
# (qkv, masks, out, B, H, W, C, heads, shift, scale, stream)
_WINDOW_ATTN = [_P] * 3 + [_I] * 6 + [_F, _P]
# (x, weight, bias, out, rows (64-bit), C, eps, stream)
_LAYER_NORM = [_P] * 4 + [ctypes.c_longlong, _I, _F, _P]
# (u, xdbl, dt_w, dt_b, A, ds, part, out, B, H, W, D, R, flags, stream)
_SELECTIVE_SCAN = [_P] * 8 + [_I] * 6 + [_P]

#: Every ``extern "C"`` entry point of csrc/*.cu and its argument types, in
#: order: a pointer (and the stream) is c_void_p, or ctypes would pass it as
#: a 32-bit int; a ``long long`` is c_longlong, which a c_int would cut.
#: Each returns its launches' cudaError_t as an int.
ENTRY_POINTS = {
    "fsr_instance_norm_prelu_bf16": _IN,
    "fsr_instance_norm_prelu_f32": _IN,
    "fsr_instance_norm_add_bf16": _IN,
    "fsr_instance_norm_add_f32": _IN,
    "fsr_instance_norm_prelu_masked_bf16": _IN_MASKED,
    "fsr_instance_norm_prelu_masked_f32": _IN_MASKED,
    "fsr_instance_norm_add_masked_bf16": _IN_MASKED,
    "fsr_instance_norm_add_masked_f32": _IN_MASKED,
    "fsr_instance_norm_stats_bf16": _IN_STATS,
    "fsr_instance_norm_stats_f32": _IN_STATS,
    "fsr_instance_norm_prelu_from_stats_bf16": _IN_FROM_STATS,
    "fsr_instance_norm_prelu_from_stats_f32": _IN_FROM_STATS,
    "fsr_instance_norm_add_from_stats_bf16": _IN_FROM_STATS,
    "fsr_instance_norm_add_from_stats_f32": _IN_FROM_STATS,
    "fsr_fused_upsample_bf16": _FUSED_UPSAMPLE,
    "fsr_fused_upsample_f32": _FUSED_UPSAMPLE,
    # (x, out, B, H, W, C in bytes, stream)
    "fsr_pixel_shuffle_phase_major": [_P, _P] + [_I] * 4 + [_P],
    "fsr_int8_conv_bf16": _INT8_CONV,
    "fsr_int8_conv_f32": _INT8_CONV,
    "fsr_int8_conv_phases_bf16": _INT8_PHASES,
    "fsr_int8_conv_phases_f32": _INT8_PHASES,
    "fsr_quantize_bf16": _QUANTIZE,
    "fsr_quantize_f32": _QUANTIZE,
    "fsr_tail_epilogue_bf16": _TAIL_EPILOGUE,
    "fsr_tail_epilogue_f32": _TAIL_EPILOGUE,
    "fsr_window_attn_bf16": _WINDOW_ATTN,
    "fsr_window_attn_f32": _WINDOW_ATTN,
    "fsr_window_attn16_bf16": _WINDOW_ATTN,
    "fsr_layer_norm_bf16": _LAYER_NORM,
    "fsr_layer_norm_f32": _LAYER_NORM,
    "fsr_selective_scan_bf16": _SELECTIVE_SCAN,
    "fsr_selective_scan_f32": _SELECTIVE_SCAN,
}

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
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    jobs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs = [job.communicate()[0] for job in jobs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        for src, job, log in zip(srcs, jobs, logs):
            if job.returncode != 0:
                raise RuntimeError(f"nvcc failed ({job.returncode}) on {src.name}:\n{log}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed: {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    return lib_path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
        return _library
