"""The port's phase-major pixel shuffle (fast_srgan_torch/kernels/pixel_shuffle.py)
against the JAX package, on the CPU.

A copy: the port's op (its plain version on the CPU, the CUDA kernel's
contract) is held bitwise equal to the JAX DMA kernel in interpret mode and
to ``pixel_shuffle_nhwc``. The CUDA kernel itself is checked on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from fast_srgan_tpu.kernels.pixel_shuffle import phase_major_permutation as jax_perm
from fast_srgan_tpu.kernels.pixel_shuffle import pixel_shuffle_phase_major_dma
from fast_srgan_tpu.ops.pixel_shuffle import pixel_shuffle_nhwc
from fast_srgan_torch.kernels.pixel_shuffle import (
    check_kernel_inputs,
    fast_pixel_shuffle_from_torch_order,
    phase_major_permutation,
    pixel_shuffle_phase_major,
    pixel_shuffle_phase_major_reference,
)

torch.set_num_threads(1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("c4", [4, 64, 256, 1024])
def test_permutation_matches_jax(c4):
    np.testing.assert_array_equal(phase_major_permutation(c4), jax_perm(c4))


def test_plain_is_bitwise_the_dma_kernel_and_nhwc_shuffle():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 256)).astype(np.float32)
    xp = x[..., jax_perm(256)]
    with pltpu.force_tpu_interpret_mode():
        dma = np.asarray(pixel_shuffle_phase_major_dma(jnp.asarray(xp)))
    before = pixel_shuffle_phase_major.launches
    got = pixel_shuffle_phase_major(_nchw(xp))
    assert pixel_shuffle_phase_major.launches == before  # no kernel on the CPU
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), dma)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(pixel_shuffle_nhwc(jnp.asarray(x), 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_torch_order_is_pixel_shuffle(dtype):
    x = torch.randn((2, 64, 3, 5), generator=torch.Generator().manual_seed(1)).to(dtype)
    got = fast_pixel_shuffle_from_torch_order(x.contiguous(memory_format=torch.channels_last))
    assert got.dtype == dtype and torch.equal(got, F.pixel_shuffle(x, 2))


def test_backward_is_the_inverse_copy():
    xp = torch.randn((1, 32, 3, 4), dtype=torch.float64).requires_grad_(True)
    g = torch.randn((1, 8, 6, 8), dtype=torch.float64)
    pixel_shuffle_phase_major(xp).backward(g)
    xr = xp.detach().clone().requires_grad_(True)
    pixel_shuffle_phase_major_reference(xr).backward(g)
    assert torch.equal(xp.grad, xr.grad)


class TestKernelContract:
    def test_accepts(self):
        check_kernel_inputs(torch.zeros((2, 256, 3, 5), dtype=torch.bfloat16)
                            .contiguous(memory_format=torch.channels_last))
        check_kernel_inputs(torch.zeros((1, 16, 3, 5))
                            .contiguous(memory_format=torch.channels_last))

    @pytest.mark.parametrize(
        "shape,dtype,match",
        [
            ((2, 16, 3, 5), torch.bfloat16, "multiple of 16"),
            ((2, 6, 3, 5), torch.float32, "4C"),
            ((2, 64, 0, 5), torch.float32, "unsupported size"),
        ],
    )
    def test_rejects(self, shape, dtype, match):
        x = torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)
        with pytest.raises(ValueError, match=match):
            check_kernel_inputs(x)

    def test_rejects_nchw_contiguous(self):
        with pytest.raises(ValueError, match="channels_last"):
            check_kernel_inputs(torch.zeros((1, 64, 3, 5)))

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="cpu or cuda"):
            pixel_shuffle_phase_major(torch.empty((1, 64, 2, 2), device="meta"))
