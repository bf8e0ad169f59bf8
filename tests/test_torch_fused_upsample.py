"""The port's fused upsample stage (fast_srgan_torch/kernels/fused_upsample.py)
against the JAX package, on the CPU in fp32.

On the CPU the port's op takes its plain version, so these tests hold that
plain version (the CUDA kernel's numerical contract) to the JAX
``_reference_impl`` and to the v1 and v2 Pallas kernels in interpret mode,
to atol 1e-5; gradients to jax.vjp of the JAX op to 1e-5 of each
gradient's max-abs. The CUDA kernel itself is checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fast_srgan_tpu.kernels.fused_upsample import (
    _fused_pallas,
    _fused_pallas_v2,
    _reference_impl,
    build_packed_weights,
)
from fast_srgan_tpu.kernels.fused_upsample import fused_upsample as jax_fused_upsample
from fast_srgan_tpu.kernels.pixel_shuffle import phase_major_permutation
from fast_srgan_torch.kernels.fused_upsample import (
    check_kernel_inputs,
    fused_upsample,
    fused_upsample_reference,
)
from fast_srgan_torch.models.generator import Generator

torch.set_num_threads(1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(shape, seed=0, c4=256):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((3, 3, shape[-1], c4)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((c4,)) * 0.01).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return x, k, bias, alpha


def _port(x, k, bias, alpha, op=fused_upsample):
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return _nhwc(op(_nchw(x), w, torch.from_numpy(bias), torch.from_numpy(alpha)))


def _packed(k, bias):
    perm = phase_major_permutation(k.shape[-1])
    bias_pm = bias[perm]
    bias2 = np.concatenate([bias_pm, bias_pm]).reshape(1, 2 * k.shape[-1])
    return jnp.asarray(build_packed_weights(k)), jnp.asarray(bias2)


@pytest.mark.parametrize("shape", [(1, 5, 16, 64), (2, 8, 24, 64), (1, 7, 13, 64)])
def test_plain_matches_jax_reference(shape):
    x, k, bias, alpha = _inputs(shape, seed=sum(shape))
    want = np.asarray(_reference_impl(*map(jnp.asarray, (x, k, bias, alpha))))
    got = _port(x, k, bias, alpha, op=fused_upsample_reference)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 64)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "variant,shape", [("v1", (1, 5, 16, 64)), ("v2", (2, 8, 24, 64))]
)
def test_op_matches_pallas_interpret(variant, shape):
    x, k, bias, alpha = _inputs(shape, seed=3)
    wt, bias2 = _packed(k, bias)
    with pltpu.force_tpu_interpret_mode():
        if variant == "v1":
            want = _fused_pallas(jnp.asarray(x), wt, bias2, jnp.asarray(alpha))
        else:
            want = _fused_pallas_v2(jnp.asarray(x), wt, bias2, jnp.asarray(alpha), R=8)
    before = fused_upsample.launches
    got = _port(x, k, bias, alpha)
    assert fused_upsample.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_gradients_match_jax_vjp():
    x, k, bias, alpha = _inputs((2, 4, 6, 64), seed=5, c4=64)
    g = np.random.default_rng(6).standard_normal((2, 8, 12, 16)).astype(np.float32)
    _, vjp = jax.vjp(jax_fused_upsample, *map(jnp.asarray, (x, k, bias, alpha)))
    gx, gk, gb, ga = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    fused_upsample(xt, wt, bt, at).backward(_nchw(g))
    for got, want in [
        (_nhwc(xt.grad), gx), (wt.grad.numpy().transpose(2, 3, 1, 0), gk),
        (bt.grad.numpy(), gb), (at.grad.numpy(), ga),
    ]:
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_generator_fused_flag_is_the_same_function():
    # the twin of tests/test_fused_upsample.py's TestGeneratorFusedFlag
    torch.manual_seed(0)
    plain = Generator(n_filters=8, n_layers=2)
    fused = Generator(n_filters=8, n_layers=2, fused_upsample=True)
    with torch.no_grad():
        for p in plain.parameters():
            p.add_(0.05 * torch.randn_like(p))
    fused.load_state_dict(plain.state_dict())
    x = torch.rand((1, 3, 12, 12)) * 2 - 1
    a, b = plain(x), fused(x)
    torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    fused(x).square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in fused.parameters())


class TestKernelContract:
    """What the CUDA wrapper refuses, checked on CPU tensors of the shapes."""

    def _args(self, cin=64, c4=256, dtype=torch.bfloat16, nchw=False):
        x = torch.zeros((2, cin, 5, 7), dtype=dtype)
        if not nchw:
            x = x.contiguous(memory_format=torch.channels_last)
        return x, torch.zeros((c4, cin, 3, 3)), torch.zeros(c4), torch.zeros(1)

    def test_accepts_training_shapes(self):
        check_kernel_inputs(*self._args())
        check_kernel_inputs(*self._args(dtype=torch.float32, c4=64))

    @pytest.mark.parametrize(
        "kwargs,match",
        [
            ({"cin": 32}, "C_in=64"),
            ({"c4": 32}, "C % 16"),
            ({"dtype": torch.float16}, "bf16 or fp32"),
            ({"nchw": True}, "channels_last"),
        ],
    )
    def test_rejects(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            check_kernel_inputs(*self._args(**kwargs))

    def test_rejects_bias_shape(self):
        x, w, _, a = self._args()
        with pytest.raises(ValueError, match="bias"):
            check_kernel_inputs(x, w, torch.zeros(3), a)

    def test_other_devices_raise(self):
        x = torch.empty((1, 64, 4, 4), device="meta")
        w = torch.empty((256, 64, 3, 3), device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            fused_upsample(x, w, torch.empty(256, device="meta"), torch.empty(1, device="meta"))
