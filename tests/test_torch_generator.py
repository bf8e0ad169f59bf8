"""The port's Generator (fast_srgan_torch/models) against the JAX Generator.

Same weights (the pretrained npz, or a small random tree made with numpy),
same inputs, fp32 on the CPU: outputs agree to 2e-5, the bar the JAX
package met against the PyTorch reference graph (PARITY.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.models import Generator as JaxGenerator
from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.models.generator import Generator

torch.set_num_threads(1)

PRETRAINED = "models/generator_pretrained.npz"

# The original Fast-SRGAN state_dict keys (tests/test_torch_compat.py's oracle).
REFERENCE_KEYS = (
    {"neck.0.weight", "neck.0.bias", "neck.1.weight", "bottleneck.0.weight",
     "head.0.weight", "head.0.bias"}
    | {f"stem.{i}.{m}.weight" for i in range(8) for m in ("conv1", "relu1", "conv2")}
    | {f"upsampling.{j}.{m}" for j in range(2)
       for m in ("conv.weight", "conv.bias", "relu.weight")}
)


def random_params(n_filters: int, n_layers: int, scale: int, seed: int = 0):
    """A generator param tree (HWIO numpy leaves) with off-init values."""
    rng = np.random.default_rng(seed)
    f = n_filters

    def conv(cin, cout, bias=True):
        leaf = {"kernel": (rng.standard_normal((3, 3, cin, cout))
                           / np.sqrt(9 * cin)).astype(np.float32)}
        if bias:
            leaf["bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        return leaf

    def alpha():
        return {"alpha": rng.uniform(0.05, 0.4, 1).astype(np.float32)}

    p = {"neck_conv": conv(3, f), "neck_relu": alpha(),
         "bottleneck_conv": conv(f, f, bias=False), "head_conv": conv(f, 3)}
    for i in range(n_layers):
        p[f"stem_{i}"] = {"conv1": conv(f, f, False), "relu1": alpha(),
                          "conv2": conv(f, f, False)}
    for j in range({2: 1, 4: 2, 8: 3}[scale]):
        p[f"upsampling_{j}"] = {"conv": conv(f, 4 * f), "relu": alpha()}
    return {"params": p}


def port_model(params, **arch) -> Generator:
    model = Generator(**arch)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.eval()


def run_port(model, x_nhwc: np.ndarray, **kw) -> np.ndarray:
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.inference_mode():
        y = model(x.contiguous(memory_format=torch.channels_last), **kw)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pretrained():
    return load_npz_params(PRETRAINED)


class TestPretrained:
    def test_state_dict_has_reference_names(self, pretrained):
        sd = state_dict_from_jax_params(pretrained)
        assert set(sd) == REFERENCE_KEYS
        assert set(Generator().state_dict()) == REFERENCE_KEYS

    def test_parameter_count(self):
        assert sum(p.numel() for p in Generator().parameters()) == 925_646

    def test_oihw_layout(self, pretrained):
        sd = state_dict_from_jax_params(pretrained)
        k = pretrained["params"]["upsampling_0"]["conv"]["kernel"]
        assert sd["upsampling.0.conv.weight"].shape == (256, 64, 3, 3)
        np.testing.assert_array_equal(
            sd["upsampling.0.conv.weight"][5, 7].numpy(), k[:, :, 7, 5]
        )

    def test_matches_jax_with_pallas_sites(self, pretrained):
        x = np.random.default_rng(21).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
        want = np.asarray(JaxGenerator(use_pallas=True).apply(pretrained, jnp.asarray(x)))
        got = run_port(port_model(pretrained), x)
        assert got.shape == (2, 64, 96, 3)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_trunk_only_matches_jax(self, pretrained):
        x = np.random.default_rng(22).uniform(-1, 1, (1, 9, 13, 3)).astype(np.float32)
        want = np.asarray(
            JaxGenerator().apply(pretrained, jnp.asarray(x), trunk_only=True)
        )
        got = run_port(port_model(pretrained), x, trunk_only=True)
        np.testing.assert_allclose(got, want, atol=2e-5)


class TestSmallRandom:
    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_matches_jax(self, scale):
        params = random_params(8, 2, scale, seed=scale)
        x = np.random.default_rng(scale).uniform(-1, 1, (2, 7, 9, 3)).astype(np.float32)
        want = np.asarray(
            JaxGenerator(n_filters=8, n_layers=2, scale_factor=scale).apply(
                params, jnp.asarray(x)
            )
        )
        got = run_port(port_model(params, n_filters=8, n_layers=2, scale_factor=scale), x)
        assert got.shape == (2, 7 * scale, 9 * scale, 3)
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_rejects_unsupported_scale(self):
        with pytest.raises(ValueError, match="2, 4, or 8"):
            Generator(scale_factor=3)

    def test_bf16_module_runs_in_bf16(self):
        model = port_model(random_params(8, 1, 4), n_filters=8, n_layers=1)
        model = model.to(torch.bfloat16)
        x = torch.zeros((1, 3, 5, 6)).contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            trunk = model(x, trunk_only=True)
            out = model(x)
        assert trunk.dtype == torch.bfloat16
        assert out.dtype == torch.float32  # tanh in fp32, as the JAX model
        assert out.shape == (1, 3, 20, 24)
