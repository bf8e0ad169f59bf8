"""The port's int8 PTQ tier (fast_srgan_torch/quant.py) against the JAX package's.

Same numpy weights and inputs through ``fast_srgan_tpu.quant`` and the
port, on the CPU (the port's kernels run their plain versions here):

  * the quantized tree, activation quantization (planted ties included) and
    the plain int8 conv with its dequantize + bias + PReLU epilogue:
    bitwise (fp32 glue; the cast order is also checked in bf16 glue);
  * ``sr_float_forward``: 2e-5 max-abs in fp32 against JAX and against the
    port's ``generator_apply_lr_tail``; the calibration keys equal JAX's;
  * ``calibrate_scales``: rtol 1e-6; the percentile helper against
    ``numpy.percentile`` past torch.quantile's 2^24-element limit;
  * ``sr_quant_forward`` with the same activation scales: uint8 outputs
    under the bounded-flip contract (at most 3 counts, under 2% of pixels
    off by more than 1; tests/test_spatial_quant.py);
  * the pretrained npz: ups-only int8 above 37 dB and full int8 above
    33 dB against fp32 (tests/test_quant.py::TestPretrainedBound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu import quant as jq
from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.kernels.int8_conv import int8_conv, pack_int8_weight
from fast_srgan_torch.kernels.quantize import quantize_act
from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, prepare_lr_tail
from test_torch_generator import PRETRAINED, port_model, random_params

torch.set_num_threads(1)

_ONLY = {"ups": jq.is_ups_module, "tail": jq.is_tail_module,
         "trunk": jq.is_trunk_module, "full": None}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _u8(y) -> np.ndarray:
    """The engine's output mapping: (y + 1) * 127.5, clamped, truncated."""
    return np.clip((np.asarray(y, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def assert_bounded_flips(got, want) -> None:
    diff = np.abs(_u8(got).astype(np.int16) - _u8(want).astype(np.int16))
    assert diff.max() <= 3, diff.max()
    assert (diff > 1).mean() < 0.02, (diff > 1).mean()


def _psnr_u8(a, b) -> float:
    mse = np.mean((np.clip((np.asarray(a) + 1) * 127.5, 0, 255)
                   - np.clip((np.asarray(b) + 1) * 127.5, 0, 255)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


def _input(shape=(2, 7, 9), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, shape + (3,)).astype(np.float32)


class TestQuantizedTree:
    @pytest.mark.parametrize("mode", ["full", "ups", "tail", "trunk"])
    def test_bitwise_against_jax(self, mode):
        params = random_params(8, 2, 4, seed=1)
        want = jq.quantize_generator_params(params, only=_ONLY[mode])
        got = quant.quantize_generator_params(params, only=quant.MODES[mode])

        def walk(w, g, path):
            assert set(w) == set(g), path
            for k in w:
                if isinstance(w[k], dict):
                    walk(w[k], g[k], f"{path}/{k}")
                else:
                    a, b = np.asarray(w[k]), np.asarray(g[k])
                    assert a.dtype == b.dtype, (path, k)
                    np.testing.assert_array_equal(b, a, err_msg=f"{path}/{k}")

        walk(want, got, "")
        quantized = [k for k in got if "qkernel" in str(got[k])]
        assert quantized or mode == "trunk"

    def test_exact_zero_stays_zero(self):
        k = np.zeros((3, 3, 4, 4), np.float32)
        k[1, 1, 0, 0] = 1.0
        q, s = quant._quantize_kernel(k)
        assert int(np.sum(q != 0)) == 1
        np.testing.assert_array_equal(q, np.asarray(jq._quantize_kernel(jnp.asarray(k))[0]))


class TestActivationQuantization:
    def test_planted_ties_and_clipping_bitwise(self):
        # s = 127 / 2^j makes 127 / s exactly 2^j, so x = (k + 0.5) / 2^j
        # lands exactly on a tie: half to even for even and odd k, both signs
        for j in (0, 3, 5):
            s = np.float32(127.0 / 2**j)
            k = np.arange(-140, 140, dtype=np.float32)
            x = np.concatenate([(k + 0.5) / 2**j, k / 2**j, [3 * s, -3 * s]]).astype(np.float32)
            want = np.asarray(jq._quantize_act(jnp.asarray(x), jnp.float32(s)))
            got = quantize_act(torch.from_numpy(x), torch.tensor(s)).numpy()
            np.testing.assert_array_equal(got, want)
            ties = got[: len(k)].astype(np.int32)
            inside = np.abs(k) < 127
            assert np.all(ties[inside] % 2 == 0)  # half to even
            assert got.min() == -127 and got.max() == 127

    def test_reciprocal_first_then_product(self):
        # near-ties at scales where 127/s and reciprocal(s)*127 differ
        rng = np.random.default_rng(0)
        s = rng.uniform(0.05, 40, 64).astype(np.float32)
        for si in s:
            r = np.float32(127) / si
            x = ((np.arange(-120, 120) + 0.5) / r).astype(np.float32)
            x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                                np.nextafter(x, np.float32(-np.inf))])
            want = np.asarray(jq._quantize_act(jnp.asarray(x), jnp.float32(si)))
            got = quantize_act(torch.from_numpy(x), torch.tensor(si)).numpy()
            np.testing.assert_array_equal(got, want)

    def test_bf16_input(self):
        x = np.random.default_rng(1).normal(0, 3, 4096).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        want = np.asarray(jq._quantize_act(xb, jnp.float32(2.7)))
        got = quantize_act(torch.from_numpy(x).to(torch.bfloat16), torch.tensor(2.7))
        np.testing.assert_array_equal(got.numpy(), want)


_CONV_CASES = [
    ("3x3", 3, 8, 32, None),
    ("neck cin=3", 3, 3, 8, None),
    ("phase 00", 2, 32, 32, (0, 0)),
    ("phase 01", 2, 32, 32, (0, 1)),
    ("phase 10", 2, 32, 32, (1, 0)),
    ("phase 11", 2, 32, 32, (1, 1)),
]


class TestInt8Conv:
    """The plain int8 conv + epilogue against JAX ``_Exec.conv_q`` + bias +
    ``_prelu``."""

    @pytest.mark.parametrize("glue", ["float32", "bfloat16"])
    @pytest.mark.parametrize("label,k,cin,cout,phase", _CONV_CASES)
    def test_bitwise_against_jax(self, label, k, cin, cout, phase, glue):
        rng = np.random.default_rng(k * 100 + cin + cout)
        q = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
        xq = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
        wscale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
        bias = rng.normal(0, 0.5, cout).astype(np.float32)
        alpha = np.float32(0.173)
        s = np.float32(2.3)
        if phase is None:
            jpad, pad = ((1, 1), (1, 1)), (1, 1)
        else:
            p, qq = phase
            jpad, pad = ((1 - p, p), (1 - qq, qq)), (1 - p, 1 - qq)
        jglue, tglue = getattr(jnp, glue), getattr(torch, glue)
        ex = jq._Exec({"c": jnp.float32(s)}, None, jglue)
        y = ex.conv_q(jnp.asarray(xq), "c", jnp.asarray(q), jnp.asarray(wscale), jpad)
        y = jq._prelu(y + jnp.asarray(bias).astype(jglue), jnp.asarray(alpha), jglue)
        got = int8_conv(
            _nchw(xq), pack_int8_weight(torch.from_numpy(q)), torch.from_numpy(wscale),
            torch.tensor(s), pad, torch.from_numpy(bias).to(tglue),
            torch.tensor([alpha]).to(tglue), tglue,
        )
        assert got.dtype == tglue and got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(_nhwc(got), np.asarray(y.astype(jnp.float32)))

    def test_no_epilogue_matches_conv_q(self):
        rng = np.random.default_rng(5)
        q = rng.integers(-127, 128, (3, 3, 16, 12)).astype(np.int8)
        xq = rng.integers(-127, 128, (1, 6, 5, 16)).astype(np.int8)
        wscale = rng.uniform(1e-3, 2e-2, 12).astype(np.float32)
        ex = jq._Exec({"c": jnp.float32(0.7)}, None, jnp.float32)
        want = ex.conv_q(jnp.asarray(xq), "c", jnp.asarray(q), jnp.asarray(wscale), jq.PAD1)
        got = int8_conv(_nchw(xq), pack_int8_weight(torch.from_numpy(q)),
                        torch.from_numpy(wscale), torch.tensor(0.7), out_dtype=torch.float32)
        np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


class TestFloatOracle:
    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_matches_jax_and_lr_tail(self, scale):
        params = random_params(8, 2, scale, seed=scale)
        x = _input(seed=scale)
        plan = quant.prepare_generator(params, device="cpu")
        collect = {}
        with torch.no_grad():
            got = quant.sr_float_forward(plan, _nchw(x), collect=collect)
            model = port_model(params, n_filters=8, n_layers=2, scale_factor=scale)
            canonical = generator_apply_lr_tail(model, prepare_lr_tail(model), _nchw(x))
        want_collect = {}
        want = jq.sr_float_forward(params, jnp.asarray(x), scale, collect=want_collect)
        assert got.shape == (2, 3, 7 * scale, 9 * scale)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(got.numpy(), canonical.numpy(), atol=2e-5)
        assert set(collect) == set(want_collect)
        for k in collect:
            np.testing.assert_allclose(float(collect[k]), float(want_collect[k]), rtol=1e-6)

    def test_rejects_a_quantized_plan(self):
        plan = quant.prepare_generator(random_params(8, 1, 4), "ups", device="cpu")
        with pytest.raises(ValueError, match="sr_float_forward"):
            quant.sr_float_forward(plan, torch.zeros(1, 3, 4, 4))
        with pytest.raises(ValueError, match="quantize must be"):
            quant.prepare_generator(random_params(8, 1, 4), "int4", device="cpu")


class TestCalibration:
    def test_scales_match_jax(self):
        params = random_params(8, 2, 4, seed=3)
        plan = quant.prepare_generator(params, device="cpu")
        rng = np.random.default_rng(3)
        u8_hwc = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
        u8_nhwc = rng.integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
        batches = [_input(seed=4), u8_hwc, u8_nhwc]
        for percentile in (quant.DEFAULT_PERCENTILE, None):
            want = jq.calibrate_scales(params, batches, 4, margin=1.1, percentile=percentile)
            got = quant.calibrate_scales(plan, batches, margin=1.1, percentile=percentile)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == torch.float32 and got[k].dim() == 0
                np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)

    def test_rejects_empty(self):
        with pytest.raises(ValueError, match="at least one batch"):
            plan = quant.prepare_generator(random_params(8, 1, 4), device="cpu")
            quant.calibrate_scales(plan, [])

    def test_percentile_past_torch_quantile_limit(self):
        # 2^24 + 1 elements: torch.quantile refuses this many
        x = np.random.default_rng(7).random(2**24 + 1, dtype=np.float32)
        for q in (99.99, 50.0, 0.01):
            got = float(quant.percentile(torch.from_numpy(x), q))
            np.testing.assert_allclose(got, np.percentile(x.astype(np.float64), q), rtol=1e-6)

    def test_percentile_matches_jax_interpolation(self):
        # XLA may fuse the interpolation's multiply-add (one ulp)
        x = np.random.default_rng(8).normal(0, 1, 1001).astype(np.float32)
        for q in (99.99, 97.3, 50.0, 0.0, 100.0):
            got = quant.percentile(torch.from_numpy(x), q)
            np.testing.assert_allclose(
                float(got), float(jnp.percentile(jnp.asarray(x), q)), rtol=1e-6
            )

    def test_calibration_batches_match_jax(self):
        np.testing.assert_array_equal(
            quant.default_calibration_batch(h=24, w=32, n=3, seed=2),
            np.asarray(jq.default_calibration_batch(h=24, w=32, n=3, seed=2)),
        )
        rng = np.random.default_rng(4)
        images = [rng.integers(0, 256, s, dtype=np.uint8)
                  for s in [(40, 50, 3), (10, 10, 3), (64, 36, 4), (48, 48, 1), (36, 90, 3)]]
        got = quant.calibration_batch_from_images(iter(images), k=8)
        want = np.asarray(jq.calibration_batch_from_images(iter(images), k=8))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (3, 36, 36, 3)
        assert quant.calibration_batch_from_images([images[1], images[3]]) is None


class TestPretrainedBound:
    """The shipped weights' quality contract, the port's copy of
    tests/test_quant.py::TestPretrainedBound (fp32 glue, 2x48x64)."""

    def test_psnr_bound_pretrained(self):
        params = load_npz_params(PRETRAINED)
        x = quant.default_calibration_batch(h=48, w=64, n=2, seed=3)
        plan = quant.prepare_generator(params, device="cpu")
        with torch.no_grad():
            ref = _nhwc(quant.sr_float_forward(plan, _nchw(x)))
            scales = quant.calibrate_scales(plan, [x])

            def psnr_of(mode):
                qplan = quant.prepare_generator(params, mode, torch.float32, device="cpu")
                return _psnr_u8(_nhwc(quant.sr_quant_forward(qplan, scales, _nchw(x))), ref)

            psnr_full = psnr_of("full")
            psnr_ups = psnr_of("ups")
        assert psnr_full > 33.0, psnr_full
        assert psnr_ups > 37.0, psnr_ups
        assert psnr_ups > psnr_full
