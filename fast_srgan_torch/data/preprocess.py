"""One-time dataset preprocessing: images -> raw uint8 .npy cache. A copy of
``fast_srgan_tpu/data/preprocess.py``: the port's cache is byte for byte
the JAX package's, so one cache serves both.

Capability parity with the reference's ``write_images_to_numpy_arrays``
(the reference's train.py:22-37): every ``.png`` under ``image_dir`` is
decoded to RGB uint8 and saved as ``.npy`` under ``numpy_dir`` using a
16-thread pool, triggered lazily when the cache directory does not exist
(reference train.py:48-56).

Differences (deliberate): arrays are stored HWC (the reference stores CHW),
and jpg/jpeg are accepted alongside png. The cache exists so training-time
random crops are a cheap mmap slice with no image decode on the hot path
(reference dataloader.py:25 uses ``mmap_mode="c"`` for the same reason).

Completeness: the reference only checks that the dir exists, so an
interrupted first run permanently skips the remaining images. Here a
``.complete`` sentinel (written after the pool finishes) marks a finished
cache; a dir without it is rebuilt. Caches from before the sentinel existed
are accepted when their .npy count matches the source image count.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fast_srgan_torch.utils.images import list_image_files, load_image_u8

_SENTINEL = ".complete"


def _npy_names(names) -> list:
    """Map image filenames to unique .npy names. Stems that collide across
    extensions (0001.png + 0001.jpg) keep their extension in the cache name
    — both written with a stem would silently overwrite each other in a
    thread-pool race."""
    stems: dict = {}
    for name in names:
        stems.setdefault(os.path.splitext(name)[0], []).append(name)
    out = []
    for name in names:
        stem, _ = os.path.splitext(name)
        if len(stems[stem]) > 1:
            out.append(name.replace(".", "_") + ".npy")
        else:
            out.append(stem + ".npy")
    return out


def write_images_to_numpy(
    image_dir: str, numpy_dir: str, workers: int = 16, verbose: bool = True
) -> int:
    """Decode every image in image_dir into an HWC uint8 .npy in numpy_dir."""
    # List images BEFORE creating the cache dir: a typo'd image_dir must not
    # leave behind an empty cache that masks the error on later runs.
    names = list_image_files(image_dir)
    os.makedirs(numpy_dir, exist_ok=True)
    targets = _npy_names(names)

    def _write(pair) -> None:
        name, target = pair
        arr = load_image_u8(os.path.join(image_dir, name))
        np.save(os.path.join(numpy_dir, target), arr)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(_write, zip(names, targets)))
    with open(os.path.join(numpy_dir, _SENTINEL), "w") as f:
        f.write(f"{len(names)}\n")
    if verbose:
        print(f"Preprocessed {len(names)} images -> {numpy_dir}")
    return len(names)


def ensure_numpy_cache(image_dir: str, numpy_dir: str, workers: int = 16) -> None:
    """Lazily build the cache when missing, empty, or incomplete (see the
    module docstring — the reference's existence-only check leaves partial
    caches in place forever after an interrupted run)."""
    if os.path.isdir(numpy_dir):
        if os.path.exists(os.path.join(numpy_dir, _SENTINEL)):
            return
        # Pre-sentinel caches: accept if every source image is cached.
        n_npy = sum(f.endswith(".npy") for f in os.listdir(numpy_dir))
        if n_npy and n_npy >= len(list_image_files(image_dir)):
            return
        # Incomplete: clear stale .npy files (possibly truncated mid-save)
        # so the rebuilt cache contains exactly the source images.
        for f in os.listdir(numpy_dir):
            if f.endswith(".npy"):
                os.unlink(os.path.join(numpy_dir, f))
    write_images_to_numpy(image_dir, numpy_dir, workers)
