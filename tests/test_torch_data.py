"""The port's data pipeline (fast_srgan_torch/data) against the JAX
package's, on the CPU: the .npy cache byte for byte, CropSampler and
PrefetchLoader batches bitwise for the same seed and files (iter_from(k)
included), and the native crop gather against numpy slicing (where g++
builds it)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch.config import default_config
from fast_srgan_torch.data import native
from fast_srgan_torch.data.pipeline import (
    CropSampler,
    PrefetchLoader,
    list_numpy_files,
    make_loaders,
    resolve_val_numpy_dir,
)
from fast_srgan_torch.data.preprocess import ensure_numpy_cache, write_images_to_numpy
from fast_srgan_tpu.config import default_config as jax_default_config
from fast_srgan_tpu.data import pipeline as jax_pipeline
from fast_srgan_tpu.data.preprocess import write_images_to_numpy as jax_write_images_to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    img_dir = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(5):
        h, w = int(rng.integers(100, 160)), int(rng.integers(100, 160))
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"im{i}.png")
    # a stem shared by two extensions keeps both (the names carry them)
    Image.fromarray(rng.integers(0, 256, (100, 100, 3), dtype=np.uint8)).save(
        img_dir / "im0.jpg"
    )
    return str(img_dir)


@pytest.fixture(scope="module")
def caches(images, tmp_path_factory):
    root = tmp_path_factory.mktemp("caches")
    port, ref = str(root / "port"), str(root / "jax")
    write_images_to_numpy(images, port, verbose=False)
    jax_write_images_to_numpy(images, ref, verbose=False)
    return port, ref


def test_cache_is_byte_for_byte_the_jax_cache(caches):
    port, ref = caches
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref))
    assert ".complete" in names and "im0_png.npy" in names and "im0_jpg.npy" in names
    for name in names:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def test_ensure_cache_builds_then_keeps(images, tmp_path):
    target = str(tmp_path / "lazy")
    ensure_numpy_cache(images, target)
    files = list_numpy_files(target)
    assert len(files) == 6
    mtimes = [os.path.getmtime(f) for f in files]
    ensure_numpy_cache(images, target)  # complete: a no-op
    assert [os.path.getmtime(f) for f in files] == mtimes


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_batches_match_jax(caches, seed):
    paths = list_numpy_files(caches[0])
    port = CropSampler(paths, 24, 4, seed=seed, backend="numpy")
    ref = jax_pipeline.CropSampler(paths, 24, 4, seed=seed, backend="numpy")
    for _ in range(3):
        np.testing.assert_array_equal(port.random_batch(5), ref.random_batch(5))
    a = list(port.sequential_batches(4, seed=seed, drop_last=False))
    b = list(ref.sequential_batches(4, seed=seed, drop_last=False))
    assert [x.shape for x in a] == [(4, 96, 96, 3), (2, 96, 96, 3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("start", [0, 3])
def test_prefetch_loader_matches_jax_from_any_batch(caches, start):
    paths = list_numpy_files(caches[0])
    port = PrefetchLoader(CropSampler(paths, 8, 4, seed=3, backend="numpy"), 4, 6, workers=3)
    ref = jax_pipeline.PrefetchLoader(
        jax_pipeline.CropSampler(paths, 8, 4, seed=3, backend="numpy"), 4, 6, workers=3
    )
    a, b = list(port.iter_from(start)), list(ref.iter_from(start))
    assert len(a) == len(b) == 6 - start
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # a resumed iteration yields exactly the tail of an uninterrupted one
    full = list(port.iter_from(0))
    for x, y in zip(full[start:], a):
        np.testing.assert_array_equal(x, y)


def _native_or_skip():
    if not native.available():
        pytest.skip("the native loader did not build (no g++)")


def test_native_backend_matches_numpy(caches):
    _native_or_skip()
    paths = list_numpy_files(caches[0])
    nat = CropSampler(paths, 24, 4, seed=3, backend="native")
    assert nat.backend == "native"
    a = nat.random_batch(8)
    b = CropSampler(paths, 24, 4, seed=3, backend="numpy").random_batch(8)
    np.testing.assert_array_equal(a, b)
    ds = native.NativeCropDataset(paths)
    with pytest.raises(ValueError):
        ds.crop_batch(np.asarray([0], np.int32), np.asarray([10_000], np.int32),
                      np.asarray([0], np.int32), 8)
    ds.close()


def test_native_library_lands_in_the_package_build_dir():
    _native_or_skip()
    lib = native._lib_path()
    assert lib.exists() and lib.parent.name == "_build"
    assert lib.parent.parent.name == "fast_srgan_torch"


def test_make_loaders_match_jax(caches, tmp_path):
    sections = dict(
        data={"numpy_dir": caches[0], "lr_image_size": 8, "scale_factor": 4},
        training={"batch_size": 3, "pretrain_iterations": 2, "iterations": 3,
                  "num_workers": 2},
        experiment={"seed": 11},
    )
    val, pre, gan = make_loaders(default_config(**sections))
    j_val, j_pre, j_gan = jax_pipeline.make_loaders(jax_default_config(**sections))
    assert (len(pre), len(gan)) == (2, 3) and val is pre.sampler
    for a, b in ((pre, j_pre), (gan, j_gan)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(val.sequential_batches(3, seed=11, drop_last=False),
                    j_val.sequential_batches(3, seed=11, drop_last=False)):
        np.testing.assert_array_equal(x, y)
    held_out = default_config(data={"numpy_dir": "/d/np", "val_image_dir": "/d/val"})
    assert resolve_val_numpy_dir(held_out) == "/d/np_val"
    empty = default_config(data={"numpy_dir": caches[0],
                                 "val_numpy_dir": str(tmp_path)})
    with pytest.raises(ValueError, match="no .npy files"):
        make_loaders(empty)


def test_prefetch_loader_under_thread_stress(caches):
    """More crop threads than cores, a tiny queue and a short interpreter
    switch interval: every batch arrives, in plan order, equal to one
    thread's, and no waiting thread is left to its poll (each batch's
    producer is woken when its batch enters the window)."""
    import sys
    import time

    paths = list_numpy_files(caches[0])
    want = list(PrefetchLoader(CropSampler(paths, 8, 4, seed=2, backend="numpy"), 3, 120,
                               prefetch=1, workers=1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loader = PrefetchLoader(CropSampler(paths, 8, 4, seed=2, backend="numpy"), 3, 120,
                                prefetch=1, workers=24)
        t0 = time.perf_counter()
        got = list(loader)
        seconds = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(want) == 120
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert seconds < 0.5 * loader.POLL_S * 120 / 24
