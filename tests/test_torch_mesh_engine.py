"""The engine's data-parallel ``mesh=`` and ``infer --tile``, on the CPU.

The engine over ``mesh=[cpu, cpu]`` (one replica a distinct device, each
batch split into two contiguous slices) against ``mesh=None`` on the same
weights, random (8 filters, 2 blocks) and numpy-made: 0 uint8 counts and
2e-5 in fp32, bucketed and unbucketed, bf16 and int8 alike (the CPU runs
the same plain programs at either batch); ``effective_batch_size`` a
multiple of the mesh size; ``recalibrate`` reaching every replica.
``python -m fast_srgan_torch.infer --tile 1 --device cpu`` against the
engine, and its flag errors.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch import infer
from fast_srgan_torch.checkpoints.npz_io import save_npz_params
from fast_srgan_torch.inference import SRInferenceEngine
from fast_srgan_torch.parallel.mesh import Mesh
from test_torch_generator import random_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return random_params(8, 2, 4, seed=31)


def _batch(b=5, h=12, w=16, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)


def _pair(params, **kw):
    one = SRInferenceEngine(params, device="cpu", **kw)
    scales = {"act_scales": one.act_scales} if kw.get("quantize") else {}
    return one, SRInferenceEngine(params, device="cpu", mesh=["cpu", "cpu"], **kw, **scales)


@pytest.mark.parametrize("kw", [
    {"dtype": torch.float32},
    {"dtype": torch.float32, "bucket": 8},
    {"dtype": torch.bfloat16},
    {"dtype": torch.bfloat16, "bucket": 8},
    {"dtype": torch.float32, "quantize": True},
    {"dtype": torch.bfloat16, "quantize": True, "bucket": 8},
    {"dtype": torch.float32, "lr_tail": False},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_mesh_matches_one_device(params, kw):
    one, two = _pair(params, **kw)
    assert two.mesh.shape == {"data": 2} and len(two._replicas) == 1
    batch = _batch()
    assert np.array_equal(two.upscale_batch(batch), one.upscale_batch(batch))
    mixed = [_batch(1, 12, 16, 1)[0], _batch(1, 10, 14, 2)[0], _batch(1, 12, 16, 3)[0]]
    for a, b in zip(two.upscale_images(mixed), one.upscale_images(mixed)):
        assert np.array_equal(a, b)
    if kw["dtype"] == torch.float32:
        x = batch.astype(np.float32) / 127.5 - 1.0
        assert (two.upscale_float(x) - one.upscale_float(x)).abs().max().item() <= 2e-5


def test_effective_batch_size_is_a_multiple_of_the_mesh(params):
    one, two = _pair(params, dtype=torch.float32)
    assert one.effective_batch_size(12, 16, 5) == 5
    assert two.effective_batch_size(12, 16, 5) == 4  # 2 a device
    assert two.effective_batch_size(12, 16, 1) == 2
    two.pixel_budget = 3 * 12 * 16  # 3 frames a device
    assert two.effective_batch_size(12, 16, 8) == 6


def test_odd_batch_and_fewer_frames_than_devices(params):
    one, two = _pair(params, dtype=torch.float32)
    for b in (1, 3):
        batch = _batch(b, seed=b)
        assert np.array_equal(two.forward_u8(torch.from_numpy(batch)).numpy(),
                              one.forward_u8(torch.from_numpy(batch)).numpy())


def test_recalibrate_reaches_every_replica(params):
    engine = SRInferenceEngine(params, device="cpu", quantize=True,
                               mesh=Mesh(["cpu", "cpu"], ("data",)))
    assert engine.default_calibration
    engine.recalibrate([_batch(2, seed=9)])
    assert not engine.default_calibration
    for rep in engine._replicas.values():
        assert rep.act_scales is engine.act_scales or all(
            torch.equal(rep.act_scales[k], engine.act_scales[k]) for k in engine.act_scales)
    ref = SRInferenceEngine(params, device="cpu", quantize=True,
                            calib_batches=[_batch(2, seed=9)])
    assert all(torch.equal(engine.act_scales[k], ref.act_scales[k]) for k in ref.act_scales)


def test_mesh_must_be_1d(params):
    with pytest.raises(ValueError, match="1-D"):
        SRInferenceEngine(params, device="cpu", mesh=Mesh([["cpu"]], ("data", "sp")))


# --- python -m fast_srgan_torch.infer --tile -------------------------------


def _write_images(root, n=2, h=32, w=48):
    os.makedirs(root, exist_ok=True)
    images = []
    for i in range(n):
        im = _batch(1, h, w, seed=40 + i)[0]
        Image.fromarray(im).save(os.path.join(root, f"im{i}.png"))
        images.append(im)
    return images


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, params):
    path = str(tmp_path_factory.mktemp("ckpt") / "g.npz")
    save_npz_params(path, params)
    return path


@pytest.mark.parametrize("int8", [False, True])
def test_infer_tile_matches_the_engine(tmp_path, params, checkpoint, int8):
    images = _write_images(str(tmp_path / "in"))
    args = ["--image_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
            "--checkpoint", checkpoint, "--device", "cpu", "--fp32", "--tile", "1"]
    infer.main(args + (["--int8"] if int8 else []))
    from fast_srgan_torch import quant

    calib = [quant.calibration_batch_from_images(images)] if int8 else None
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=int8,
                               calib_batches=calib)
    for i, want in enumerate(engine.upscale_images(images)):
        got = np.asarray(Image.open(tmp_path / "out" / f"im{i}.png"))
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert got.shape == want.shape and diff.max() <= (3 if int8 else 1)
        assert (diff > 1).mean() < 0.02


def test_infer_tile_flag_errors(tmp_path, checkpoint, capsys):
    _write_images(str(tmp_path / "in"), n=1)
    base = ["--image_dir", str(tmp_path / "in"), "--output_dir", str(tmp_path / "out"),
            "--checkpoint", checkpoint, "--device", "cpu"]
    with pytest.raises(SystemExit):
        infer.main(base + ["--tile", "1", "--bucket", "8"])
    assert "exclude each other" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        infer.main(["--video", "v.mp4", "--video_out", "o.mp4", "--tile", "2"])
    assert "--video does not take --tile" in capsys.readouterr().err
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        infer.main(base + ["--tile", "2"])


def test_library_tiles_two_cpu_shards(params):
    from fast_srgan_torch.parallel.spatial import tiled_quant_upscale_u8, tiled_upscale_u8
    from fast_srgan_torch import quant

    frame = _batch(1, 16, 24, seed=50)[0]
    mesh = Mesh(["cpu", "cpu"], ("sp",))
    want = SRInferenceEngine(params, device="cpu", dtype=torch.float32).upscale_batch(frame[None])
    got = tiled_upscale_u8(params, frame, mesh, torch.float32)
    assert np.abs(got.astype(np.int16) - want[0].astype(np.int16)).max() <= 1
    q = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                          calib_batches=[frame[None]])
    got = tiled_quant_upscale_u8(params, q.act_scales, frame, mesh, torch.float32)
    diff = np.abs(got.astype(np.int16) - q.upscale_batch(frame[None])[0].astype(np.int16))
    assert diff.max() <= 3 and (diff > 1).mean() < 0.02
