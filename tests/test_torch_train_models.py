"""The port's discriminator and VGG19 feature extractor against the JAX
modules, at full width, on the same weights, fp32 on the CPU.

Tolerance: 1e-5 of the output's max-abs (the same fp32 convolutions, their
sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fast_srgan_tpu.models import Discriminator as JaxDiscriminator
from fast_srgan_tpu.models import VGG19Features as JaxVGG
from fast_srgan_torch.checkpoints.convert import (
    discriminator_state_dict_from_jax_params,
    vgg_state_dict_from_jax_params,
)
from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.vgg import VGG19Features, conv_indices

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


class TestModels:
    def test_discriminator_matches_jax(self):
        x = np.random.default_rng(2).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
        jd = JaxDiscriminator()
        params = jax.jit(jd.init)(jax.random.key(0), jnp.asarray(x[:1]))
        want = np.asarray(jax.jit(jd.apply)(params, jnp.asarray(x)))
        model = Discriminator()
        assert sum(p.numel() for p in model.parameters()) == 4_684_033
        model.load_state_dict(discriminator_state_dict_from_jax_params(_host(params)))
        with torch.no_grad():
            got = model(_nchw(x).contiguous(memory_format=torch.channels_last))
        assert got.dtype == torch.float32 and got.shape == (2, 1, 6, 6)
        np.testing.assert_allclose(_nhwc(got), want, atol=1e-5 * np.abs(want).max())

    def test_vgg_matches_jax(self):
        x = np.random.default_rng(3).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
        jv = JaxVGG()
        params = jax.jit(jv.init)(jax.random.key(1), jnp.asarray(x))
        want = np.asarray(jax.jit(jv.apply)(params, jnp.asarray(x)))
        model = VGG19Features()
        model.load_state_dict(vgg_state_dict_from_jax_params(_host(params)))
        assert not any(p.requires_grad for p in model.parameters())
        with torch.no_grad():
            got = model(_nchw(x))
        assert got.shape == (1, 512, 2, 2)
        np.testing.assert_allclose(_nhwc(got), want, atol=1e-5 * np.abs(want).max())


    def test_names_are_the_reference_ones(self):
        d = set(Discriminator().state_dict())
        assert {"neck.0.weight", "neck.0.bias", "stem.7.weight", "stem.7.bias"} <= d
        assert {f"stem.{i}.conv.weight" for i in range(7)} <= d and len(d) == 11
        v = set(VGG19Features().state_dict())
        assert v == {f"features.{i}.{p}" for i in conv_indices() for p in ("weight", "bias")}
