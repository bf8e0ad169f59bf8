"""The scaled generator (12 residual blocks, 96 filters) and the fused
upsample's routing by shape, on the CPU.

The fused upsample kernel is built for 64 input channels in bf16 or fp32
(``kernels.fused_upsample.kernel_takes``); a ``fused_upsample=True``
generator of any other width runs the unfused stage, the same function, as
the JAX ``fused_upsample`` sends such shapes to its lax composition. The
port's 12-block/96-filter generator holds against JAX's
``Generator(n_filters=96, n_layers=12)`` on the same seeded weights to 2e-5
fp32 max-abs (the counterpart of tests/test_scaled_configs.py), in both
upsample forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_srgan_torch.models.generator as generator_module
from fast_srgan_tpu.models import Generator as JaxGenerator
from fast_srgan_torch.kernels.fused_upsample import check_kernel_inputs, kernel_takes
from fast_srgan_torch.models.generator import Generator, UpSamplingBlock
from test_torch_generator import port_model, random_params, run_port

torch.set_num_threads(1)


def _stage_tensors(n_filters: int, dtype: torch.dtype):
    x = torch.zeros((2, n_filters, 6, 8), dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.zeros((4 * n_filters, n_filters, 3, 3))
    return x, w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_64_filters_not_96(dtype):
    assert kernel_takes(*_stage_tensors(64, dtype))
    assert not kernel_takes(*_stage_tensors(96, dtype))


def test_kernel_takes_refuses_other_dtypes_and_widths():
    x, w = _stage_tensors(64, torch.float16)
    assert not kernel_takes(x, w)
    x, _ = _stage_tensors(64, torch.float32)
    assert kernel_takes(x, torch.zeros((64, 64, 3, 3)))  # 4C = 64 (C = 16)
    assert not kernel_takes(x, torch.zeros((96, 64, 3, 3)))  # 4C % 64 != 0
    assert not kernel_takes(x, torch.zeros((256, 64, 1, 1)))


def test_check_kernel_inputs_still_raises_when_called_directly():
    x, w = _stage_tensors(96, torch.float32)
    with pytest.raises(ValueError, match="C_in=64"):
        check_kernel_inputs(x, w, torch.zeros(384), torch.zeros(1))


@pytest.mark.parametrize("n_filters,fused_calls", [(96, 0), (64, 1)])
def test_upsampling_block_routes_by_shape(monkeypatch, n_filters, fused_calls):
    """fused=True calls the fused stage only where the kernel takes the
    shapes; the unfused stage it picks otherwise computes the same."""
    calls = []
    real = generator_module.fused_upsample

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(generator_module, "fused_upsample", counting)
    torch.manual_seed(n_filters)
    fused = UpSamplingBlock(n_filters, fused=True).eval()
    plain = UpSamplingBlock(n_filters, fused=False).eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn((2, n_filters, 6, 8)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert len(calls) == fused_calls
    assert got.shape == (2, n_filters, 12, 16)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def scaled():
    """The BASELINE scaled configuration's weights (12 blocks, 96 filters)
    and a seeded input."""
    params = random_params(96, 12, 4, seed=12)
    x = np.random.default_rng(96).uniform(-1, 1, (1, 10, 12, 3)).astype(np.float32)
    want = np.asarray(JaxGenerator(n_filters=96, n_layers=12).apply(params, jnp.asarray(x)))
    return params, x, want


@pytest.mark.parametrize("fused", [False, True])
def test_12_block_96_filter_generator_matches_jax(scaled, fused):
    params, x, want = scaled
    model = port_model(params, n_filters=96, n_layers=12, fused_upsample=fused)
    got = run_port(model, x)
    assert got.shape == want.shape == (1, 40, 48, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_12_block_96_filter_fused_generator_trains():
    """Forward and backward of the fused=True scaled generator (the
    ``generator.n_filters=96 kernels.fused_upsample=true`` training
    config) give the unfused generator's gradients."""
    torch.manual_seed(0)
    fused = Generator(n_filters=96, n_layers=12, fused_upsample=True)
    plain = Generator(n_filters=96, n_layers=12)
    plain.load_state_dict(fused.state_dict())
    x = torch.rand((1, 3, 8, 8)) * 2 - 1
    grads = []
    for model in (fused, plain):
        model(x).square().mean().backward()
        grads.append(model.upsampling[1].conv.weight.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)
