"""The port's fused IN+PReLU (fast_srgan_torch/kernels) against the JAX package.

On the CPU the port's op takes its plain version, so these tests hold that
plain version (the kernel's numerical contract) to the JAX reference and to
the two Pallas kernels in interpret mode, at fp32, to atol 1e-5. The CUDA
kernel itself is checked on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fast_srgan_tpu.kernels.instance_norm import (
    _largest_chunk,
    _pallas_forward,
    _pallas_forward_chunked,
    _reference_impl,
    instance_norm_prelu_nhwc,
)
from fast_srgan_tpu.ops.norm import instance_norm_nhwc
from fast_srgan_torch.kernels import _build
from fast_srgan_torch.kernels.instance_norm import (
    check_kernel_inputs,
    instance_norm_prelu,
    instance_norm_prelu_reference,
)
from fast_srgan_torch.ops.norm import instance_norm

torch.set_num_threads(1)

SHAPE = (2, 12, 16, 64)  # NHWC, as the JAX functions take it


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(SHAPE) * 3 + rng.uniform(-2, 2, SHAPE[-1]))
    return x.astype(np.float32), np.asarray([0.173], np.float32)


class TestPlainVersusJax:
    def test_instance_norm_matches_jax(self, inputs):
        x, _ = inputs
        want = np.asarray(instance_norm_nhwc(jnp.asarray(x)))
        got = _nhwc(instance_norm(_nchw(x)))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_matches_jax_reference(self, inputs):
        x, a = inputs
        want = np.asarray(_reference_impl(jnp.asarray(x), jnp.asarray(a)))
        got = _nhwc(instance_norm_prelu_reference(_nchw(x), torch.from_numpy(a)))
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("variant", ["whole_block", "chunked"])
    def test_matches_pallas_interpret(self, inputs, variant):
        x, a = inputs
        xj, aj = jnp.asarray(x), jnp.asarray(a)
        with pltpu.force_tpu_interpret_mode():
            if variant == "whole_block":
                want = _pallas_forward(xj, aj)
            else:
                hw, fold = SHAPE[1] * SHAPE[2], 128 // SHAPE[3]
                want = _pallas_forward_chunked(
                    xj, aj, _largest_chunk(hw // fold, 8)
                )
        got = _nhwc(instance_norm_prelu(_nchw(x), torch.from_numpy(a)))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)

    def test_public_op_is_plain_on_cpu(self, inputs):
        x, a = inputs
        xt, at = _nchw(x), torch.from_numpy(a)
        before = instance_norm_prelu.launches
        out = instance_norm_prelu(xt, at)
        assert instance_norm_prelu.launches == before  # no kernel on the CPU
        assert torch.equal(out, instance_norm_prelu_reference(xt, at))

    def test_bf16_keeps_dtype(self, inputs):
        x, a = inputs
        xt = _nchw(x).to(torch.bfloat16)
        out = instance_norm_prelu(xt, torch.from_numpy(a))
        assert out.dtype == torch.bfloat16
        want = np.asarray(
            _reference_impl(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a)), np.float32
        )
        np.testing.assert_allclose(_nhwc(out.float()), want, atol=2e-2)

    def test_near_constant_input_is_finite(self):
        # fp32 cancellation regime of the one-pass variance (the clamp case)
        x = np.full((1, 16, 16, 64), 40.0, np.float32)
        x += np.random.default_rng(11).normal(0, 1e-4, x.shape).astype(np.float32)
        out = instance_norm_prelu(_nchw(x), torch.tensor([0.25]))
        assert torch.isfinite(out).all()


class TestGradient:
    # A local generator per seed: the shared ``rng`` fixture's draw depends
    # on which files the same xdist worker ran before this one.
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_matches_jax_grad(self, seed):
        x = np.random.default_rng(seed).standard_normal((1, 6, 6, 8)).astype(np.float32)
        a = np.asarray([0.25], np.float32)

        def f(xx, aa):
            return jnp.sum(jnp.sin(instance_norm_prelu_nhwc(xx, aa)))

        gx_want, ga_want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
        xt = _nchw(x).requires_grad_(True)
        at = torch.from_numpy(a.copy()).requires_grad_(True)
        torch.sin(instance_norm_prelu(xt, at)).sum().backward()
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_want), atol=1e-5)
        # The slope's gradient is an fp32 sum of 288 terms that reads ~100,
        # taken in another order than JAX's: relative, not absolute.
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_want), rtol=1e-5)


class TestKernelContract:
    """What the CUDA wrapper refuses, checked on CPU tensors of the shapes."""

    def _x(self, c=64, dtype=torch.bfloat16, h=5, w=7):
        return torch.zeros((2, c, h, w), dtype=dtype).contiguous(
            memory_format=torch.channels_last
        )

    def test_accepts_serving_shapes(self):
        check_kernel_inputs(self._x(), torch.zeros(1))
        check_kernel_inputs(self._x(dtype=torch.float32, c=4), torch.zeros(1))

    @pytest.mark.parametrize(
        "kwargs,match",
        [
            ({"c": 12}, "C=12"),
            ({"c": 6, "dtype": torch.float32}, "C=6"),
            ({"c": 4096}, "C=4096"),
            ({"dtype": torch.float16}, "bf16 or fp32"),
        ],
    )
    def test_rejects(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            check_kernel_inputs(self._x(**kwargs), torch.zeros(1))

    def test_rejects_nchw_contiguous(self):
        x = torch.zeros((2, 64, 5, 7), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="channels_last"):
            check_kernel_inputs(x, torch.zeros(1))

    def test_rejects_vector_slope(self):
        with pytest.raises(ValueError, match="alpha"):
            check_kernel_inputs(self._x(), torch.zeros(2))

    def test_other_devices_raise(self):
        x = torch.empty((1, 64, 4, 4), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            instance_norm_prelu(x, torch.empty(1, device="meta"))


class TestBuild:
    def test_sources_and_flags(self):
        names = [p.name for p in _build.sources()]
        assert "instance_norm.cu" in names
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_hash_follows_sources(self, tmp_path):
        src = tmp_path / "k.cu"
        src.write_text("// a")
        h1 = _build.source_hash([src])
        assert _build.source_hash([src]) == h1
        src.write_text("// b")
        assert _build.source_hash([src]) != h1

    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setenv("PATH", "/nonexistent")
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_build.os, "access", lambda *a: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
