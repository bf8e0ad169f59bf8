"""The port's bucketed engine and ``stream``, against the JAX engine and
against the port's own exact-shape engine.

On the CPU, fp32: the ``bucket=16`` engine against the JAX ``bucket=16``
engine on the same weights (at most 1 uint8 count, >= 99.9% of pixels
equal) and against the port's unbucketed engine (at most 1 count); mixed
sizes share one bucket batch; the masked int8 engine (``ups``, fp32 glue,
the same scales) against JAX's bucketed int8 engine within the bounded-flip
contract. ``stream`` yields in input order, bitwise equal to
``upscale_batch`` on the same batches, trailing partial batch included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.inference import SRInferenceEngine as JaxEngine
from fast_srgan_torch.inference import SRInferenceEngine
from test_torch_generator import random_params
from test_torch_quant import _input

torch.set_num_threads(1)


def _images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


def _diff(a, b) -> np.ndarray:
    return np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))


MIXED = [(10, 12), (8, 8), (16, 16), (12, 20), (5, 9)]


@pytest.fixture(scope="module")
def params():
    return random_params(8, 2, 4, seed=11)


@pytest.fixture(scope="module")
def exact(params):
    return SRInferenceEngine(params, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def bucketed(params):
    return SRInferenceEngine(params, device="cpu", dtype=torch.float32, bucket=16)


class TestAgainstJax:
    def test_bucketed_matches_jax_bucketed(self, params, bucketed):
        images = _images(0, MIXED)
        want = JaxEngine(params, n_filters=8, n_layers=2, dtype=jnp.float32,
                         bucket=16).upscale_images(images)
        got = bucketed.upscale_images(images)
        for g, w, im in zip(got, want, images):
            assert g.shape == (4 * im.shape[0], 4 * im.shape[1], 3) and g.dtype == np.uint8
            d = _diff(g, w)
            assert d.max() <= 1 and np.mean(d == 0) >= 0.999

    def test_masked_int8_matches_jax(self, params):
        x = _input((2, 12, 14), seed=3)
        images = _images(1, [(12, 14), (7, 10), (16, 9)])
        want = JaxEngine(params, n_filters=8, n_layers=2, dtype=jnp.float32, bucket=16,
                         quantize=True, calib_batches=[x]).upscale_images(images)
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32, bucket=16,
                                quantize=True, calib_batches=[x])
        for g, w in zip(eng.upscale_images(images), want):
            d = _diff(g, w)
            assert d.max() <= 3 and (d > 1).mean() < 0.02


class TestBucketed:
    def test_bucketed_equals_exact(self, exact, bucketed):
        batch = np.stack(_images(2, [(12, 20)] * 2))
        a = exact.upscale_batch(batch)
        b = bucketed.upscale_batch(batch)
        assert a.shape == b.shape == (2, 48, 80, 3)
        assert _diff(a, b).max() <= 1

    def test_canonical_tail_bucketed_equals_exact(self, params, exact):
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32, bucket=16,
                                lr_tail=False)
        images = _images(3, MIXED[:3])
        for got, im in zip(eng.upscale_images(images), images):
            assert _diff(got, exact.upscale_batch(im[None])[0]).max() <= 1

    def test_mixed_shapes_share_one_bucket_batch(self, exact, bucketed):
        images = _images(4, [(10, 12), (8, 8), (16, 16)])  # all in the 16x16 bucket
        before = bucketed.forward_calls
        outs = bucketed.upscale_images(images, batch_size=3)
        assert bucketed.forward_calls - before == 1
        assert [o.shape for o in outs] == [(40, 48, 3), (32, 32, 3), (64, 64, 3)]
        for im, out in zip(images, outs):
            assert _diff(out, exact.upscale_batch(im[None])[0]).max() <= 1

    def test_batch_is_sized_at_the_padded_shape(self, params):
        # 9x9 pads to 16x16: a budget of two padded frames runs 5 frames in 3
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32, bucket=16,
                                pixel_budget=2 * 16 * 16)
        batch = np.stack(_images(5, [(9, 9)] * 5))
        out = eng.upscale_batch(batch)
        assert out.shape == (5, 36, 36, 3) and eng.forward_calls == 3

    def test_files_group_by_bucket(self, tmp_path, bucketed):
        from PIL import Image

        images = _images(6, [(10, 12), (16, 16), (20, 20)])
        paths = []
        for i, im in enumerate(images):
            Image.fromarray(im).save(tmp_path / f"{i}.png")
            paths.append(str(tmp_path / f"{i}.png"))
        got = dict(bucketed.upscale_files(paths, batch_size=8))
        for i, im in enumerate(images):
            np.testing.assert_array_equal(got[i], bucketed.upscale_images([im])[0])

    def test_refusals(self, params):
        with pytest.raises(ValueError, match=">= 0"):
            SRInferenceEngine(params, device="cpu", bucket=-1)
        for mode in ("full", "trunk"):
            with pytest.raises(ValueError, match="float trunk"):
                SRInferenceEngine(params, device="cpu", bucket=16, quantize=mode,
                                  calib_batches=[_input(seed=0)])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="is_available"):
                SRInferenceEngine(params, bucket=16)  # device="cuda" by default


class TestStream:
    def test_order_and_bitwise_equal_to_upscale_batch(self, exact):
        frames = _images(7, [(9, 11)] * 11)  # batches of 4, 4 and a trailing 3
        before = exact.forward_calls
        got = list(exact.stream(iter(frames), batch_size=4))
        assert exact.forward_calls - before == 3
        want = np.concatenate([exact.upscale_batch(np.stack(frames[i:i + 4]))
                               for i in range(0, 11, 4)])
        assert len(got) == 11
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_first_frame_fixes_the_batch(self, params):
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                pixel_budget=3 * 9 * 11)
        frames = _images(8, [(9, 11)] * 7)
        out = list(eng.stream(frames, batch_size=8))
        assert len(out) == 7 and eng.forward_calls == 3  # 3, 3, 1

    def test_empty_and_mismatched_streams(self, exact):
        assert list(exact.stream([])) == []
        frames = _images(9, [(9, 11), (9, 11), (8, 11)])
        with pytest.raises(ValueError, match="one shape"):
            list(exact.stream(frames, batch_size=1))
        with pytest.raises(ValueError, match="uint8 HWC"):
            list(exact.stream([np.zeros((4, 4), np.uint8)]))


class TestInferCli:
    @pytest.fixture
    def image_dir(self, tmp_path):
        from PIL import Image

        src = tmp_path / "in"
        src.mkdir()
        for i, im in enumerate(_images(10, [(10, 12), (16, 16), (7, 20)])):
            Image.fromarray(im).save(src / f"im{i}.png")
        return src

    def test_bucket_flag_end_to_end(self, tmp_path, params, image_dir):
        from PIL import Image

        from fast_srgan_torch import infer
        from test_torch_engine import _save_npz

        ckpt = tmp_path / "g.npz"
        _save_npz(ckpt, params)
        dst = tmp_path / "out"
        infer.main(["--image_dir", str(image_dir), "--output_dir", str(dst), "--checkpoint",
                    str(ckpt), "--bucket", "16", "--fp32", "--device", "cpu"])
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32, bucket=16)
        for i in range(3):
            im = np.asarray(Image.open(image_dir / f"im{i}.png"))
            np.testing.assert_array_equal(np.asarray(Image.open(dst / f"im{i}.png")),
                                          eng.upscale_images([im])[0])

    def test_runs_on_the_card_by_default(self, tmp_path, params, image_dir):
        from fast_srgan_torch import infer
        from test_torch_engine import _save_npz

        if torch.cuda.is_available():
            pytest.skip("checks the CPU-only case")
        ckpt = tmp_path / "g.npz"
        _save_npz(ckpt, params)
        with pytest.raises(RuntimeError, match="is_available"):
            infer.main(["--image_dir", str(image_dir), "--output_dir", str(tmp_path / "o"),
                        "--checkpoint", str(ckpt), "--bucket", "16"])
