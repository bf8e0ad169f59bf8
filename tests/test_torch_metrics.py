"""The port's PSNR/SSIM (fast_srgan_torch/metrics/psnr_ssim.py) against the
JAX package's, on the CPU in fp32.

Tolerances: ssim_per_image within 1e-5 of JAX per image (the same 11-tap
separable Gaussian and 'valid' map, summed in another order), including the
near-identical pair where the variance clamp and the Cauchy-Schwarz cap
guard SSIM <= 1; PSNR accumulation rtol 1e-6; luma_bt601 to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_torch.metrics import psnr_ssim as port
from fast_srgan_tpu.metrics import psnr_ssim as ref

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _pair(seed, shape=(3, 32, 29, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + noise * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("seed,noise", [(0, 0.1), (1, 0.5), (2, 1e-4)])
def test_ssim_matches_jax(seed, noise):
    x, y = _pair(seed, noise=noise)
    want = np.asarray(ref.ssim_per_image(jnp.asarray(x), jnp.asarray(y)))
    got = port.ssim_per_image(_nchw(x), _nchw(y)).numpy()
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("value", [0.3, 0.1])
def test_ssim_near_identical_is_capped(value):
    """A flat image against itself plus one-ulp noise: E[x^2] - E[x]^2
    cancels to a negative variance in fp32 (asserted), which the clamp
    holds at 0."""
    rng = np.random.default_rng(3)
    x = np.full((2, 24, 24, 3), value, np.float32)
    y = (x + rng.choice([-1, 0, 1], x.shape) * np.spacing(np.float32(value))).astype(np.float32)
    k = torch.from_numpy(port._gaussian_kernel1d())
    ty = _nchw(y)
    raw_var = port._filter2d_valid(ty * ty, k) - port._filter2d_valid(ty, k) ** 2
    assert bool((raw_var < 0).any())
    want = np.asarray(ref.ssim_per_image(jnp.asarray(x), jnp.asarray(y)))
    got = port.ssim_per_image(_nchw(x), ty).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got <= 1.0) and np.all(got >= -1.0)


def test_ssim_rejects_small_images():
    with pytest.raises(ValueError, match="11x11"):
        port.ssim_per_image(torch.zeros(1, 3, 10, 20), torch.zeros(1, 3, 10, 20))


def test_ssim_ignores_autocast():
    x, y = _pair(4)
    want = port.ssim_per_image(_nchw(x), _nchw(y))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = port.ssim_per_image(_nchw(x), _nchw(y))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_psnr_accumulation_matches_jax():
    batches = [_pair(s, shape=(2, 16, 16, 3)) for s in range(3)]
    sse = n = 0.0
    j_sse = j_n = 0.0
    for x, y in batches:
        a, b = port.psnr_accumulate(_nchw(x), _nchw(y))
        sse, n = sse + float(a), n + float(b)
        ja, jb = ref.psnr_accumulate(jnp.asarray(x), jnp.asarray(y))
        j_sse, j_n = j_sse + float(ja), j_n + float(jb)
    assert n == j_n == 3 * 2 * 16 * 16 * 3
    np.testing.assert_allclose(sse, j_sse, rtol=1e-6)
    np.testing.assert_allclose(
        port.psnr_from_accumulator(sse, n), ref.psnr_from_accumulator(j_sse, j_n), rtol=1e-6
    )
    assert port.psnr_from_accumulator(0.0, 5.0) == float("inf")
    with pytest.raises(ValueError, match="empty"):
        port.psnr_from_accumulator(0.0, 0.0)


def test_aggregator_matches_jax():
    agg, j_agg = port.MetricAggregator(), ref.MetricAggregator()
    for s in range(2):
        x, y = _pair(10 + s, shape=(2, 20, 20, 3))
        agg.update(_nchw(x), _nchw(y))
        j_agg.update(jnp.asarray(x), jnp.asarray(y))
    (p, s), (jp, js) = agg.compute(), j_agg.compute()
    np.testing.assert_allclose(p, jp, rtol=1e-6)
    np.testing.assert_allclose(s, js, atol=1e-5)


def test_luma_matches_jax():
    x = np.random.default_rng(5).uniform(0, 1, (2, 7, 9, 3)).astype(np.float32)
    want = np.asarray(ref.luma_bt601(jnp.asarray(x)))
    got = port.luma_bt601(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="RGB"):
        port.luma_bt601(torch.zeros(1, 4, 2, 2))
