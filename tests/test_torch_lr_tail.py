"""The port's LR-domain tail (fast_srgan_torch/ops/lr_tail.py) against JAX.

The kernel rearrangements must equal the JAX package's bitwise (both are
pure copies of the same fp32 weights). The tails must match the JAX tails
and the port's own canonical tail at fp32, atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.ops import lr_tail as jax_lr_tail
from fast_srgan_torch.ops import lr_tail as port_lr_tail
from fast_srgan_torch.ops.lr_tail import (
    generator_apply_lr_tail,
    head_form_4x,
    prepare_lr_tail,
)
from test_torch_generator import port_model, random_params

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


class TestRearrangedKernels:
    @pytest.fixture(scope="class")
    def kernel(self):
        return np.random.default_rng(3).standard_normal((3, 3, 8, 12)).astype(np.float32)

    def test_phase_kernels_2x_bitwise(self, kernel):
        want = jax_lr_tail._phase_kernels_2x(jnp.asarray(kernel))
        got = port_lr_tail._phase_kernels_2x(torch.from_numpy(kernel))
        assert list(got) == list(want)
        for pq in want:
            np.testing.assert_array_equal(got[pq].numpy(), np.asarray(want[pq]))

    @pytest.mark.parametrize("name", ["_head_kernel_4x", "_head_kernel_2x"])
    def test_head_kernels_bitwise(self, kernel, name):
        want = getattr(jax_lr_tail, name)(jnp.asarray(kernel))
        got = getattr(port_lr_tail, name)(torch.from_numpy(kernel))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _case(scale, seed, shape=(2, 7, 9)):
    params = random_params(8, 1, scale, seed=seed)
    model = port_model(params, n_filters=8, n_layers=1, scale_factor=scale)
    y = np.random.default_rng(seed).standard_normal(shape + (8,)).astype(np.float32)
    return params, model, y


class TestTails:
    @pytest.mark.parametrize("head", ["summed", "concat"])
    def test_4x_matches_jax_and_canonical(self, head):
        params, model, y = _case(4, seed=11)
        want = np.asarray(jax_lr_tail.lr_tail(
            jnp.asarray(y), params["params"], dtype=jnp.float32, head=head
        ))
        with torch.inference_mode():
            got = _nhwc(port_lr_tail.lr_tail(_nchw(y), prepare_lr_tail(model), head=head))
            canonical = _nhwc(model.tail(_nchw(y)))
        assert got.shape == (2, 28, 36, 3)
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_allclose(got, canonical, atol=2e-5)

    def test_2x_matches_jax_and_canonical(self):
        params, model, y = _case(2, seed=12)
        want = np.asarray(jax_lr_tail.lr_tail_2x(
            jnp.asarray(y), params["params"], dtype=jnp.float32
        ))
        with torch.inference_mode():
            got = _nhwc(port_lr_tail.lr_tail_2x(_nchw(y), prepare_lr_tail(model)))
            canonical = _nhwc(model.tail(_nchw(y)))
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_allclose(got, canonical, atol=2e-5)

    def test_8x_matches_jax_and_canonical(self):
        params, model, y = _case(8, seed=13, shape=(1, 5, 6))
        want = np.asarray(jax_lr_tail.lr_tail_8x(
            jnp.asarray(y), params["params"], dtype=jnp.float32
        ))
        with torch.inference_mode():
            got = _nhwc(port_lr_tail.lr_tail_8x(_nchw(y), prepare_lr_tail(model)))
            canonical = _nhwc(model.tail(_nchw(y)))
        assert got.shape == (1, 40, 48, 3)
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_allclose(got, canonical, atol=2e-5)

    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_generator_apply_matches_full_forward(self, scale):
        params, model, _ = _case(scale, seed=20 + scale)
        x = np.random.default_rng(scale).uniform(-1, 1, (2, 6, 7, 3)).astype(np.float32)
        with torch.inference_mode():
            got = generator_apply_lr_tail(model, prepare_lr_tail(model), _nchw(x))
            want = model(_nchw(x))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)

    def test_rejects_bad_head(self):
        _, model, y = _case(4, seed=1)
        with pytest.raises(ValueError, match="head must be"):
            port_lr_tail.lr_tail(_nchw(y), prepare_lr_tail(model), head="dense")

    def test_prepared_weights_in_compute_dtype(self):
        _, model, _ = _case(4, seed=2)
        tail = prepare_lr_tail(model, dtype=torch.bfloat16)
        assert tail["head_w"].dtype == torch.bfloat16
        assert all(w.dtype == torch.bfloat16 for _, w in tail["phases"])
        assert tail["head_b"].dtype == torch.float32  # summed in fp32


class TestHeadPolicy:
    def test_policy_table_matches_jax(self, monkeypatch):
        """The policy's mechanism, held at JAX's threshold: the port's own
        value is the card's (None: summed never loses, PERF.md section 6)."""
        monkeypatch.setattr(port_lr_tail, "CONCAT_HEAD_MIN_PIXELS",
                            jax_lr_tail.CONCAT_HEAD_MIN_PIXELS)
        for batch, px in [(128, 180 * 320), (512, 90 * 160), (1, 540 * 960),
                          (8, 540 * 960), (2, port_lr_tail.CONCAT_HEAD_MIN_PIXELS)]:
            assert head_form_4x(batch, px) == jax_lr_tail.head_form_4x(batch, px)
