"""The port's masked (bucketed-exact) forward against the JAX package's.

The same numpy weights and zero-padded inputs, fp32 on the CPU (the IN
kernels run their plain versions here): the masked norm, the masked forms of
both IN epilogues, the Generator with ``valid_hw`` (canonical tail) and the
LR-domain tail with ``valid_hw``, at 2x, 4x and 8x, agree with JAX to 2e-5
max-abs on each sample's valid region; the padded-and-masked port agrees
with the unpadded port to 2e-5; the masked int8 forward (``ups``, fp32 glue,
the same activation scales) agrees with JAX's within the bounded-flip
contract (at most 3 uint8 counts, under 2% of pixels off by more than 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu import quant as jq
from fast_srgan_tpu.models import Generator as JaxGenerator
from fast_srgan_tpu.ops.lr_tail import generator_apply_lr_tail as jax_apply_lr_tail
from fast_srgan_tpu.ops.norm import instance_norm_masked_nhwc, valid_mask_nhwc
from fast_srgan_torch import quant
from fast_srgan_torch.kernels.instance_norm import (
    check_valid_hw,
    instance_norm_add,
    instance_norm_prelu,
)
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, prepare_lr_tail
from fast_srgan_torch.ops.norm import instance_norm_masked, valid_mask, zero_outside
from test_torch_generator import port_model, random_params
from test_torch_quant import _nchw, _nhwc, assert_bounded_flips

torch.set_num_threads(1)

TOL = 2e-5
# three samples padded to 16x16: short, narrow, and one whole frame
VALID = ([11, 16, 5], [14, 9, 16])


def _valid(vh=VALID[0], vw=VALID[1]):
    return (torch.tensor(vh, dtype=torch.int32), torch.tensor(vw, dtype=torch.int32))


def _jax_valid(vh=VALID[0], vw=VALID[1]):
    return (jnp.asarray(np.array(vh, np.int32)), jnp.asarray(np.array(vw, np.int32)))


def _padded_input(seed, shape=(3, 16, 16), vh=VALID[0], vw=VALID[1]):
    """Uniform [-1, 1] NHWC frames, zero outside each valid region."""
    x = np.random.default_rng(seed).uniform(-1, 1, shape + (3,)).astype(np.float32)
    for b, (h, w) in enumerate(zip(vh, vw)):
        x[b, h:] = 0
        x[b, :, w:] = 0
    return x


def _activation(seed, shape=(3, 12, 16, 8)):
    """Conv-like NHWC activations, nonzero in the padding too (a conv's
    bias smears into it): the mask inside the sums is what removes them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.5, 2, shape[-1])
            + rng.uniform(-2, 2, shape[-1])).astype(np.float32)


def _cl(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _max_valid_err(got, want, scale=1, vh=VALID[0], vw=VALID[1]) -> float:
    return max(
        float(np.abs(got[b, :h * scale, :w * scale] - want[b, :h * scale, :w * scale]).max())
        for b, (h, w) in enumerate(zip(vh, vw))
    )


VH, VW = [7, 12, 1], [16, 9, 3]


class TestMaskedNorm:
    def test_mask_matches_jax(self):
        mask, count = valid_mask(12, 16, *_valid(VH, VW))
        jmask, jcount = valid_mask_nhwc(12, 16, *_jax_valid(VH, VW))
        assert mask.shape == (3, 1, 12, 16) and count.shape == (3, 1, 1, 1)
        assert mask.dtype == count.dtype == torch.float32
        np.testing.assert_array_equal(_nhwc(mask), np.asarray(jmask))
        np.testing.assert_array_equal(count.numpy().ravel(), np.asarray(jcount).ravel())

    def test_matches_jax_and_zeroes_padding(self):
        x = _activation(0)
        mask, count = valid_mask(12, 16, *_valid(VH, VW))
        got = _nhwc(instance_norm_masked(_cl(x), mask, count))
        jmask, jcount = valid_mask_nhwc(12, 16, *_jax_valid(VH, VW))
        want = np.asarray(instance_norm_masked_nhwc(jnp.asarray(x), jmask, jcount))
        np.testing.assert_allclose(got, want, atol=TOL)
        pad = _nhwc(mask) == 0
        assert np.all(got[np.broadcast_to(pad, got.shape)] == 0)

    def test_zero_outside_leaves_no_negative_zero(self):
        v = -torch.rand((2, 4, 3, 5)) - 0.1
        mask, _ = valid_mask(3, 5, *_valid([1, 3], [2, 5]))
        out = zero_outside(v, mask)
        pad = (mask == 0).expand_as(out)
        assert torch.all(out[pad] == 0) and not torch.signbit(out[pad]).any()
        assert torch.equal(out[~pad], v[~pad])

    def test_masked_prelu_epilogue_matches_jax(self):
        x = _activation(1)
        alpha = np.array([0.173], np.float32)
        before = (instance_norm_prelu.launches, instance_norm_prelu.masked_launches)
        got = _nhwc(instance_norm_prelu(_cl(x), torch.from_numpy(alpha), _valid(VH, VW)))
        assert (instance_norm_prelu.launches, instance_norm_prelu.masked_launches) == before
        jmask, jcount = valid_mask_nhwc(12, 16, *_jax_valid(VH, VW))
        y = instance_norm_masked_nhwc(jnp.asarray(x), jmask, jcount)
        want = np.asarray(jnp.where(y >= 0, y, alpha[0] * y))
        np.testing.assert_allclose(got, want, atol=TOL)
        assert np.all(got[np.broadcast_to(np.asarray(jmask) == 0, got.shape)] == 0)

    def test_masked_add_epilogue_matches_jax(self):
        """JAX's ``instance_norm_masked_nhwc(y) + x``, with x (the block's
        input) zero in the padding, as on the generator's path."""
        y = _activation(2)
        jmask, jcount = valid_mask_nhwc(12, 16, *_jax_valid(VH, VW))
        skip = (_activation(3) * np.asarray(jmask)).astype(np.float32)
        before = (instance_norm_add.launches, instance_norm_add.masked_launches)
        got = _nhwc(instance_norm_add(_cl(y), _cl(skip), _valid(VH, VW)))
        assert (instance_norm_add.launches, instance_norm_add.masked_launches) == before
        want = np.asarray(instance_norm_masked_nhwc(jnp.asarray(y), jmask, jcount)
                          + jnp.asarray(skip))
        np.testing.assert_allclose(got, want, atol=TOL)

    def test_masked_gradients_vanish_in_the_padding(self):
        x = _cl(_activation(4)).requires_grad_(True)
        skip = torch.zeros_like(x)
        mask, _ = valid_mask(12, 16, *_valid(VH, VW))
        y = instance_norm_prelu(x, torch.tensor([0.2]), _valid(VH, VW))
        z = instance_norm_add(y, skip, _valid(VH, VW))
        torch.sin(z).sum().backward()
        pad = (mask == 0).expand_as(x)
        assert torch.isfinite(x.grad).all() and torch.all(x.grad[pad] == 0)
        assert x.grad[~pad].abs().max() > 0

    def test_check_valid_hw(self):
        x = torch.zeros((3, 8, 4, 4))
        check_valid_hw(x, None)
        check_valid_hw(x, _valid([1, 2, 3], [4, 4, 4]))
        with pytest.raises(ValueError, match="int32"):
            check_valid_hw(x, (torch.ones(3, dtype=torch.int64), torch.ones(3, dtype=torch.int32)))
        with pytest.raises(ValueError, match=r"int32 \[3\]"):
            check_valid_hw(x, _valid([1, 2], [4, 4]))
        with pytest.raises(ValueError, match="pair"):
            check_valid_hw(x, (torch.ones(3, dtype=torch.int32),))


def _jax_model(scale, n_filters=16, n_layers=2):
    return JaxGenerator(n_filters=n_filters, n_layers=n_layers, scale_factor=scale)


class TestMaskedGenerator:
    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_canonical_tail_matches_jax(self, scale):
        params = random_params(16, 2, scale, seed=scale)
        x = _padded_input(scale)
        want = np.asarray(_jax_model(scale).apply(params, jnp.asarray(x), valid_hw=_jax_valid()))
        model = port_model(params, n_filters=16, n_layers=2, scale_factor=scale)
        with torch.inference_mode():
            got = _nhwc(model(_cl(x), valid_hw=_valid()))
        assert got.shape == (3, 16 * scale, 16 * scale, 3)
        assert _max_valid_err(got, want, scale) <= TOL

    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_lr_tail_matches_jax(self, scale):
        params = random_params(16, 2, scale, seed=10 + scale)
        x = _padded_input(10 + scale)
        want = np.asarray(jax_apply_lr_tail(_jax_model(scale), params, jnp.asarray(x),
                                            valid_hw=_jax_valid()))
        model = port_model(params, n_filters=16, n_layers=2, scale_factor=scale)
        with torch.inference_mode():
            got = _nhwc(generator_apply_lr_tail(model, prepare_lr_tail(model), _cl(x), _valid()))
        assert _max_valid_err(got, want, scale) <= TOL

    @pytest.mark.parametrize("lr_tail", [False, True])
    def test_mixed_valid_sizes_equal_the_unpadded_forward(self, lr_tail):
        """Each sample of a mixed batch, padded and masked, against the port
        on that sample alone and unpadded."""
        params = random_params(16, 2, 4, seed=3)
        model = port_model(params, n_filters=16, n_layers=2)
        tail = prepare_lr_tail(model)

        def run(x, valid_hw=None):
            with torch.inference_mode():
                if lr_tail:
                    return _nhwc(generator_apply_lr_tail(model, tail, _cl(x), valid_hw))
                return _nhwc(model(_cl(x), valid_hw=valid_hw))

        x = _padded_input(21)
        got = run(x, _valid())
        for b, (h, w) in enumerate(zip(*VALID)):
            alone = run(np.ascontiguousarray(x[b:b + 1, :h, :w]))
            np.testing.assert_allclose(got[b, :4 * h, :4 * w], alone[0], atol=TOL)

    def test_trunk_only_matches_jax(self):
        params = random_params(16, 2, 4, seed=5)
        x = _padded_input(5)
        want = np.asarray(_jax_model(4).apply(params, jnp.asarray(x), trunk_only=True,
                                              valid_hw=_jax_valid()))
        model = port_model(params, n_filters=16, n_layers=2)
        with torch.inference_mode():
            got = _nhwc(model(_cl(x), trunk_only=True, valid_hw=_valid()))
        assert _max_valid_err(got, want) <= TOL

    def test_fused_upsample_refuses_a_mask(self):
        model = Generator(n_filters=16, n_layers=1, fused_upsample=True).eval()
        x = _cl(_padded_input(6))
        with torch.inference_mode(), pytest.raises(ValueError, match="masking"):
            model(x, valid_hw=_valid())


class TestMaskedInt8:
    @pytest.mark.parametrize("mode,scale", [("ups", 2), ("ups", 4), ("ups", 8), ("tail", 4)])
    def test_matches_jax_with_the_same_scales(self, mode, scale):
        params = random_params(8, 2, scale, seed=30 + scale)
        x = _padded_input(30 + scale)
        scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x])
        want = jq.sr_quant_forward_masked(
            JaxGenerator(n_filters=8, n_layers=2, scale_factor=scale),
            jq.quantize_generator_params(params, only=quant.MODES[mode]),
            {k: jnp.asarray(v.numpy()) for k, v in scales.items()},
            jnp.asarray(x), _jax_valid(), glue_dtype=jnp.float32,
        )
        plan = quant.prepare_generator(params, mode, torch.float32, device="cpu")
        with torch.no_grad():
            got = quant.sr_quant_forward_masked(plan, scales, _nchw(x), _valid())
        got, want = _nhwc(got), np.asarray(want)
        for b, (h, w) in enumerate(zip(*VALID)):
            s = scale
            assert_bounded_flips(got[b, :h * s, :w * s], want[b, :h * s, :w * s])

    def test_padded_equals_unpadded_int8(self):
        """Masked zeros quantize to int8 zero: each sample matches the port's
        unmasked int8 forward on it alone (same scales, fp32 glue)."""
        params = random_params(8, 2, 4, seed=40)
        x = _padded_input(40)
        scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x])
        plan = quant.prepare_generator(params, "ups", torch.float32, device="cpu")
        with torch.no_grad():
            got = _nhwc(quant.sr_quant_forward_masked(plan, scales, _nchw(x), _valid()))
            for b, (h, w) in enumerate(zip(*VALID)):
                alone = _nhwc(quant.sr_quant_forward(
                    plan, scales, _nchw(np.ascontiguousarray(x[b:b + 1, :h, :w]))))
                assert_bounded_flips(got[b, :4 * h, :4 * w], alone[0])

    @pytest.mark.parametrize("mode", ["full", "trunk"])
    def test_int8_trunk_modes_refuse_a_mask(self, mode):
        params = random_params(8, 1, 4)
        plan = quant.prepare_generator(params, mode, torch.float32, device="cpu")
        scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"),
                                        [_padded_input(0)])
        with pytest.raises(ValueError, match="float trunk"):
            quant.sr_quant_forward_masked(plan, scales, _nchw(_padded_input(0)), _valid())
