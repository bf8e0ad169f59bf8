"""The port's int8 forward, engine and CLI, against the JAX package's.

On the CPU (the int8 kernels run their plain versions): the int8 forward of
each mode at 2x, 4x and 8x against ``fast_srgan_tpu.quant.sr_quant_forward``
on the same activation scales, and the uint8 int8 engine against the JAX
int8 engine, both under the bounded-flip contract (at most 3 uint8 counts,
under 2% of pixels off by more than 1; tests/test_spatial_quant.py), in
fp32 glue. Then the engine's surface: the default mode, ``recalibrate``,
``default_calibration``, ``upscale_float``, and ``python -m
fast_srgan_torch.infer --int8``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu import quant as jq
from fast_srgan_tpu.inference import SRInferenceEngine as JaxEngine
from fast_srgan_torch import quant
from fast_srgan_torch.inference import SRInferenceEngine
from test_torch_engine import _save_npz
from test_torch_generator import random_params
from test_torch_quant import _ONLY, _input, _nchw, _nhwc, _u8, assert_bounded_flips

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestQuantForward:
    """The port's int8 forward against JAX's, on the same activation scales
    (the port's calibration, fed to both)."""

    @pytest.mark.parametrize("mode", ["ups", "tail", "full", "trunk"])
    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_matches_jax_with_the_same_scales(self, scale, mode):
        params = random_params(8, 2, scale, seed=10 + scale)
        x = _input(seed=scale)
        scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x])
        want = jq.sr_quant_forward(
            jq.quantize_generator_params(params, only=_ONLY[mode]),
            {k: jnp.asarray(v.numpy()) for k, v in scales.items()},
            jnp.asarray(x), scale, jnp.float32,
        )
        plan = quant.prepare_generator(params, mode, torch.float32, device="cpu")
        with torch.no_grad():
            got = quant.sr_quant_forward(plan, scales, _nchw(x))
        assert got.shape == (2, 3, 7 * scale, 9 * scale) and got.dtype == torch.float32
        assert_bounded_flips(_nhwc(got), want)

    def test_plan_holds_int8_where_the_mode_says(self):
        params = random_params(8, 1, 4)
        ups = quant.prepare_generator(params, "ups", torch.bfloat16, device="cpu")
        assert "neck" not in ups.layers and "w" in ups.layers["head"]
        assert "q" in ups.layers["up0"] and "phases_q" in ups.layers["up1"]
        assert ups.trunk is not None  # Generator.trunk, with the IN+PReLU kernel
        full = quant.prepare_generator(params, "full", torch.bfloat16, device="cpu")
        assert "q" in full.layers["neck"] and "q" in full.layers["head"]
        assert full.trunk is None
        assert full.layers["head"]["q"].packed.shape == (64, 3, 3, 128)  # 48 -> 64 rows


def _small(seed=0):
    params = random_params(8, 2, 4, seed=seed)
    x = _input((2, 12, 14), seed=seed)
    return params, x


class TestEngine:
    def test_matches_jax_int8_engine(self):
        params, x = _small(1)
        batch = np.random.default_rng(1).integers(0, 256, (2, 12, 14, 3), dtype=np.uint8)
        want = JaxEngine(params, n_filters=8, n_layers=2, dtype=jnp.float32,
                         quantize=True, calib_batches=[x]).upscale_batch(batch)
        got = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                quantize=True, calib_batches=[x]).upscale_batch(batch)
        assert got.shape == (2, 48, 56, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
        assert diff.max() <= 3 and (diff > 1).mean() < 0.02

    def test_default_mode_is_ups(self):
        params, x = _small()
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                quantize=True, calib_batches=[x])
        assert eng.quantize and eng.quantize_mode == "ups"
        assert eng._plan.mode == "ups" and eng._plan.trunk is not None
        assert not eng.default_calibration

    @pytest.mark.parametrize("bad", ["int4", "UPS", 2])
    def test_bad_mode_raises(self, bad):
        with pytest.raises(ValueError, match="quantize must be"):
            SRInferenceEngine(random_params(8, 1, 4), device="cpu", quantize=bad)

    def test_recalibrate_swaps_scales_and_clears_default(self):
        params, x = _small(2)
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True)
        assert eng.default_calibration  # the synthetic batch
        want = quant.calibrate_scales(
            quant.prepare_generator(params, device="cpu"), [quant.default_calibration_batch()]
        )
        assert all(torch.equal(eng.act_scales[k], want[k]) for k in want)
        plan = eng._plan
        before = eng.upscale_float(x)
        eng.recalibrate([x * 0.5])
        assert not eng.default_calibration
        assert eng._plan is plan  # nothing else is rebuilt
        want = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x * 0.5])
        assert all(torch.equal(eng.act_scales[k], want[k]) for k in want)
        assert not torch.equal(eng.upscale_float(x), before)

    def test_recalibrate_requires_quantize(self):
        eng = SRInferenceEngine(random_params(8, 1, 4), device="cpu")
        with pytest.raises(ValueError, match="requires quantize"):
            eng.recalibrate([np.zeros((1, 8, 8, 3), np.float32)])

    def test_act_scales_given_are_used(self):
        params, x = _small(3)
        scales = {k: float(v) * 2 for k, v in quant.calibrate_scales(
            quant.prepare_generator(params, device="cpu"), [x]).items()}
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                quantize="tail", act_scales=scales)
        assert not eng.default_calibration
        assert eng.act_scales["head"].dtype == torch.float32
        assert float(eng.act_scales["head"]) == pytest.approx(scales["head"])

    def test_upscale_float_is_sr_quant_forward(self):
        params, x = _small(4)
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                quantize="full", calib_batches=[x])
        fplan = quant.prepare_generator(params, device="cpu")
        direct = quant.sr_quant_forward(
            quant.prepare_generator(params, "full", torch.float32, device="cpu"),
            quant.calibrate_scales(fplan, [x]), _nchw(x),
        )
        np.testing.assert_array_equal(eng.upscale_float(x).numpy(), _nhwc(direct))

    def test_bf16_glue_serves_uint8(self):
        params, x = _small(5)
        eng = SRInferenceEngine(params, device="cpu", dtype=torch.bfloat16,
                                quantize=True, calib_batches=[x])
        out = eng.upscale_images([((x[0] + 1) * 127.5).astype(np.uint8)])[0]
        ref = _u8(_nhwc(quant.sr_float_forward(quant.prepare_generator(params, device="cpu"),
                                               _nchw(x[:1]))))[0]
        assert out.shape == ref.shape == (48, 56, 3)
        mse = np.mean((out.astype(np.float64) - ref) ** 2)
        assert 10 * np.log10(255.0**2 / mse) > 30.0


class TestCli:
    def test_infer_int8_calibrates_on_the_inputs(self, tmp_path):
        from PIL import Image

        params = random_params(8, 1, 4, seed=9)
        ckpt = tmp_path / "g.npz"
        _save_npz(ckpt, params)
        src, dst = tmp_path / "in", tmp_path / "out"
        src.mkdir()
        rng = np.random.default_rng(6)
        images = [rng.integers(0, 256, (36, 40, 3), dtype=np.uint8) for _ in range(2)]
        for i, im in enumerate(images):
            Image.fromarray(im).save(src / f"im{i}.png")
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "fast_srgan_torch.infer", "--image_dir", str(src),
             "--output_dir", str(dst), "--checkpoint", str(ckpt), "--int8", "--fp32",
             "--device", "cpu"],
            capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "calibrating on 2 center crop(s) of 36x40" in proc.stdout
        calib = quant.calibration_batch_from_images(images)
        engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32,
                                   quantize=True, calib_batches=[calib])
        for i, im in enumerate(images):
            got = np.asarray(Image.open(dst / f"im{i}.png"))
            want = engine.upscale_images([im])[0]
            assert got.shape == want.shape == (144, 160, 3)
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            assert diff.max() <= 3 and (diff > 1).mean() < 0.02

    def test_infer_int8_without_usable_inputs_uses_the_synthetic_batch(self, tmp_path):
        from fast_srgan_torch import infer
        from PIL import Image

        params = random_params(8, 1, 4, seed=9)
        ckpt = tmp_path / "g.npz"
        _save_npz(ckpt, params)
        src, dst = tmp_path / "in", tmp_path / "out"
        src.mkdir()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src / "tiny.png")
        infer.main(["--image_dir", str(src), "--output_dir", str(dst), "--checkpoint",
                    str(ckpt), "--int8", "--fp32", "--device", "cpu"])
        assert np.asarray(Image.open(dst / "tiny.png")).shape == (32, 32, 3)
