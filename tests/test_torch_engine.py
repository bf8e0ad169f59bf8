"""The port's uint8 engine, CLI and micro-batcher, against the JAX engine.

The whole slice: uint8 images through the port's SRInferenceEngine on the
CPU (fp32) against the JAX SRInferenceEngine (fp32, LR tail) on the same
pretrained weights: at most 1 uint8 count apart, >= 99.9% of pixels equal.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.inference import SRInferenceEngine as JaxEngine
from fast_srgan_tpu.inference import arch_from_params as jax_arch_from_params
from fast_srgan_torch import infer
from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.inference import SRInferenceEngine, arch_from_params, sr_forward_u8
from fast_srgan_torch.serving import MicroBatcher
from test_torch_generator import PRETRAINED, random_params

torch.set_num_threads(1)


def _images(rng, shapes):
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


def _save_npz(path, params):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v

    walk(params, "")
    with open(path, "wb") as f:
        np.savez(f, **flat)


@pytest.fixture(scope="module")
def pretrained():
    return load_npz_params(PRETRAINED)


@pytest.fixture(scope="module")
def small_engine():
    return SRInferenceEngine(
        random_params(8, 1, 4, seed=5), device="cpu", dtype=torch.float32
    )


class TestAgainstJax:
    def test_upscale_images_matches_jax_engine(self, pretrained):
        images = _images(np.random.default_rng(0), [(24, 32), (20, 28), (24, 32)])
        want = JaxEngine(pretrained, dtype=jnp.float32).upscale_images(images)
        got = SRInferenceEngine(
            pretrained, device="cpu", dtype=torch.float32
        ).upscale_images(images)
        for g, w, im in zip(got, want, images):
            assert g.dtype == np.uint8 and g.shape == (4 * im.shape[0], 4 * im.shape[1], 3)
            diff = np.abs(g.astype(np.int16) - np.asarray(w).astype(np.int16))
            assert diff.max() <= 1
            assert np.mean(diff == 0) >= 0.999

    def test_arch_from_params_matches_jax(self, pretrained):
        assert arch_from_params(pretrained) == jax_arch_from_params(pretrained)
        small = random_params(8, 2, 8)
        assert arch_from_params(small) == jax_arch_from_params(small)


class TestEngine:
    def test_cuda_without_cuda_raises(self, pretrained):
        if torch.cuda.is_available():
            pytest.skip("checks the CPU-only case")
        with pytest.raises(RuntimeError, match="is_available"):
            SRInferenceEngine(pretrained, device="cuda")

    def test_scale_mismatch_raises(self):
        with pytest.raises(ValueError, match="scale_factor=2"):
            SRInferenceEngine(random_params(8, 1, 4), device="cpu", scale_factor=2)

    def test_not_a_generator_raises(self):
        with pytest.raises(ValueError, match="neck_conv"):
            arch_from_params({"params": {"foo": {}}})

    def test_effective_batch_size_budget(self):
        eng = SRInferenceEngine(
            random_params(8, 1, 4), device="cpu", pixel_budget=10 * 100
        )
        assert eng.effective_batch_size(10, 10, 8) == 8
        assert eng.effective_batch_size(10, 30, 8) == 3  # no 2..7 rule
        assert eng.effective_batch_size(100, 100, 8) == 1

    def test_upscale_batch_chunks_equal_single(self):
        params = random_params(8, 1, 4, seed=6)
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                pixel_budget=2 * 6 * 7)
        batch = np.stack(_images(np.random.default_rng(1), [(6, 7)] * 5))
        got = eng.upscale_batch(batch)
        assert got.shape == (5, 24, 28, 3)
        assert eng.forward_calls == 3  # chunks of 2, 2, 1
        for i in range(5):
            np.testing.assert_array_equal(got[i], eng.upscale_batch(batch[i:i + 1])[0])
        assert eng.upscale_batch(batch[:0]).shape == (0, 24, 28, 3)

    def test_upscale_images_groups_shapes(self, small_engine):
        images = _images(np.random.default_rng(2), [(5, 6), (7, 4), (5, 6)])
        before = small_engine.forward_calls
        outs = small_engine.upscale_images(images, batch_size=8, pad_singletons=True)
        assert small_engine.forward_calls - before == 2  # one per shape
        for out, im in zip(outs, images):
            np.testing.assert_array_equal(out, small_engine.upscale_batch(im[None])[0])

    def test_lr_tail_off_agrees(self):
        params = random_params(8, 1, 4, seed=7)
        images = _images(np.random.default_rng(3), [(6, 5)])
        a = SRInferenceEngine(params, device="cpu", dtype=torch.float32).upscale_images(images)
        b = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                              lr_tail=False).upscale_images(images)
        assert np.abs(a[0].astype(np.int16) - b[0].astype(np.int16)).max() <= 1

    def test_upscale_float_shape(self, small_engine):
        y = small_engine.upscale_float(np.zeros((1, 5, 6, 3), np.float32))
        assert y.shape == (1, 20, 24, 3) and y.dtype == torch.float32

    def test_sr_forward_u8_normalization(self):
        x = torch.tensor([[[[0, 128, 255]]]], dtype=torch.uint8)  # [1,1,1,3]
        seen = {}

        def apply(t):
            seen["x"] = t
            return torch.tensor([-1.0, 0.0, 0.999, 1.5]).view(1, 4, 1, 1)

        out = sr_forward_u8(apply, x)
        np.testing.assert_allclose(seen["x"].flatten().numpy(),
                                   [-1.0, 128 / 127.5 - 1, 1.0], atol=1e-7)
        # clamp then truncate, as numpy's astype does
        assert out.flatten().tolist() == [0, 127, 254, 255]


class TestFilesAndCli:
    def test_infer_cli_writes_outputs(self, tmp_path):
        from PIL import Image

        params = random_params(8, 1, 4, seed=9)
        ckpt = tmp_path / "g.npz"
        _save_npz(ckpt, params)
        src, dst = tmp_path / "in", tmp_path / "out"
        src.mkdir()
        images = _images(np.random.default_rng(4), [(6, 8), (5, 7), (6, 8)])
        for i, im in enumerate(images):
            Image.fromarray(im).save(src / f"im{i}.PNG")
        (src / "notes.txt").write_text("skip me")
        infer.main(["--image_dir", str(src), "--output_dir", str(dst),
                    "--checkpoint", str(ckpt), "--fp32", "--device", "cpu"])
        engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
        for i, im in enumerate(images):
            out = np.asarray(Image.open(dst / f"im{i}.PNG"))
            np.testing.assert_array_equal(out, engine.upscale_images([im])[0])
        assert not (dst / "notes.txt").exists()

    def test_missing_checkpoint_exits(self, tmp_path):
        with pytest.raises(SystemExit):
            infer.main(["--image_dir", str(tmp_path), "--output_dir", str(tmp_path),
                        "--checkpoint", str(tmp_path / "none.npz"), "--device", "cpu"])

    def test_upscale_files_bad_file_keeps_earlier_outputs(self, tmp_path, small_engine):
        from PIL import Image

        good = _images(np.random.default_rng(5), [(16, 16)])[0]
        Image.fromarray(good).save(tmp_path / "a.png")
        Image.fromarray(good).save(tmp_path / "b.png")
        raw = (tmp_path / "b.png").read_bytes()
        (tmp_path / "b.png").write_bytes(raw[: len(raw) // 2])  # header intact
        paths = [str(tmp_path / "a.png"), str(tmp_path / "b.png")]
        gen = small_engine.upscale_files(paths, batch_size=1)
        i, out = next(gen)
        assert i == 0
        np.testing.assert_array_equal(out, small_engine.upscale_images([good])[0])
        with pytest.raises(OSError):
            next(gen)


class TestMicroBatcher:
    def test_concurrent_requests(self, small_engine):
        rng = np.random.default_rng(6)
        images = _images(rng, [(5, 6)] * 6 + [(4, 4)] * 3)
        want = [small_engine.upscale_images([im])[0] for im in images]
        batcher = MicroBatcher(small_engine, max_batch=4, max_wait_ms=20)
        replies = [None] * len(images)

        def client(k):
            for i in range(k, len(images), 3):
                replies[i] = batcher.submit(images[i], timeout=60)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        batcher.close()
        assert not any(t.is_alive() for t in threads)
        for got, exp in zip(replies, want):
            np.testing.assert_array_equal(got, exp)
        assert batcher.stats["requests"] == len(images)
        assert batcher.stats["errors"] == 0

    def test_closed_batcher_refuses(self, small_engine):
        batcher = MicroBatcher(small_engine)
        batcher.close()
        with pytest.raises(RuntimeError, match="shutting down"):
            batcher.submit(np.zeros((4, 4, 3), np.uint8))

    def test_engine_error_reaches_caller(self):
        class Broken:
            def upscale_images(self, images, batch_size):
                raise ValueError("boom")

        batcher = MicroBatcher(Broken(), max_wait_ms=1)
        with pytest.raises(ValueError, match="boom"):
            batcher.submit(np.zeros((4, 4, 3), np.uint8), timeout=30)
        batcher.close()
        assert batcher.stats["errors"] == 1
