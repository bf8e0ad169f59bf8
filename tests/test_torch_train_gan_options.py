"""The training options that act in the GAN step, against the JAX
package's ``build_bundle`` on the CPU in fp32 at tests/test_torch_train.py's
tiny config: the same initial weights, JAX's label noise and augmentation
coins replayed from its key splits (``fast_srgan_tpu/train/steps.py``
``_gan_shared``/``_gan_recompute``), one GAN step each. Bars: the six
metrics rtol 1e-5, and the update check of tests/test_torch_train.py for D
and G (within lr/100 where the gradient is above 1e-3 of its tensor's
scale, 2*lr elsewhere), its strong entries picked by the port's own
gradient, which that file holds to JAX's within 1e-4 of each tensor's
scale.

Here: ``gan_shared_forward=false``, ``grad_accum`` (the recompute form with
micro-batches), ``lr_schedule``; ``augment`` and ``remat`` are in
tests/test_torch_train_gan_augment_remat.py, the VGG options in
tests/test_torch_train_vgg_options.py and
tests/test_torch_train_vgg_concat.py (each JAX step compiles for seconds on
the CPU, so the cases are spread to keep each file under a minute).
Without JAX's steps: the shared form against the recompute form on the
same noise, and label noise drawn from (seed, step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_torch.checkpoints.convert import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
    vgg_state_dict_from_jax_params,
)
from fast_srgan_torch.config import default_config
from fast_srgan_torch.train.steps import METRICS, build_bundle
from fast_srgan_tpu.config import default_config as jax_default_config
from fast_srgan_tpu.train.steps import build_bundle as jax_build_bundle
from test_torch_train import _assert_update, _host, _params, hr_batch, tiny  # noqa: F401

torch.set_num_threads(1)

GAN_OPTIONS = {
    "gan_shared_forward": {"gan_shared_forward": False},
    "grad_accum": {"grad_accum": 2},
    # a milestone at 0: both first updates run at half the LR (the
    # generator's schedule starts at once with no pretrain updates)
    "lr_schedule": {"lr_schedule": "step", "lr_decay_steps": [0], "lr_decay_factor": 0.5,
                    "pretrain_iterations": 0},
}


def jax_gan_inputs(hr_u8, key, logits_hw, accum=1, augment=False):
    """JAX's GAN-step draws for ``key``: the augmentation coins (or None)
    and the three label-noise tensors for the whole batch (NCHW torch; a
    micro-batch's rows are its own draws)."""
    n = hr_u8.shape[0]
    rng, coins = key, None
    if augment:
        rng, k_aug = jax.random.split(rng, 2)
        coins = torch.from_numpy(np.array(jax.random.bernoulli(k_aug, shape=(3, n))))
    k_d, k_g = jax.random.split(rng, 2)
    micro = (n // accum, *logits_hw, 1)
    d_keys = [k_d] if accum == 1 else list(jax.random.split(k_d, accum))
    g_keys = [k_g] if accum == 1 else list(jax.random.split(k_g, accum))
    real, fake, gen = [], [], []
    for kd, kg in zip(d_keys, g_keys):
        k_real, k_fake = jax.random.split(kd, 2)
        real.append(jax.random.uniform(k_real, micro))
        fake.append(jax.random.uniform(k_fake, micro))
        gen.append(jax.random.uniform(kg, micro))
    noise = [torch.from_numpy(np.array(jnp.concatenate(u)).transpose(0, 3, 1, 2).copy())
             for u in (real, fake, gen)]
    return coins, noise


def assert_gan_option_matches_jax(opts, hr_batch):
    """One GAN step of the port and of JAX from the same weights on the
    same draws: metrics and both updates."""
    jb, g_state, d_state, vgg_params = jax_build_bundle(jax_default_config(**tiny(**opts)))
    g0, d0 = _host(g_state.params), _host(d_state.params)
    key = jax.random.key(11)
    coins, noise = jax_gan_inputs(hr_batch, key, (2, 2), opts.get("grad_accum", 1),
                                  opts.get("augment", False))
    g_state, d_state, m_j = jb.gan_step(g_state, d_state, vgg_params, jnp.asarray(hr_batch), key)

    bundle = build_bundle(default_config(**tiny(**opts)), "cpu")
    bundle.generator.load_state_dict(state_dict_from_jax_params(g0))
    bundle.discriminator.load_state_dict(discriminator_state_dict_from_jax_params(d0))
    if bundle.vgg is not None:
        bundle.vgg.load_state_dict(vgg_state_dict_from_jax_params(_host(vgg_params)))
    if coins is not None:
        bundle.coins = lambda n, *k: coins
    p0_g, p0_d = _params(bundle.generator), _params(bundle.discriminator)
    metrics = bundle.gan_step(torch.from_numpy(hr_batch), noise=noise)
    assert set(metrics) == set(METRICS) == set(m_j)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(m_j[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for model, p0, want in (
        (bundle.discriminator, p0_d, discriminator_state_dict_from_jax_params(_host(d_state.params))),
        (bundle.generator, p0_g, state_dict_from_jax_params(_host(g_state.params))),
    ):
        grads = {n: p.grad for n, p in model.named_parameters()}
        _assert_update(model, p0, want, grads)
    return bundle


@pytest.mark.parametrize("option", sorted(GAN_OPTIONS))
def test_gan_option_matches_jax(option, hr_batch):
    bundle = assert_gan_option_matches_jax(GAN_OPTIONS[option], hr_batch)
    assert bundle.shared_forward is (option == "lr_schedule")


def _fresh(opts, hr_batch, seed=3):
    bundle = build_bundle(default_config(**tiny(**opts)), "cpu", torch.Generator().manual_seed(seed))
    return bundle, torch.from_numpy(hr_batch)


def test_shared_form_equals_recompute_form(hr_batch):
    noise = [torch.rand((4, 1, 2, 2), generator=torch.Generator().manual_seed(i)) for i in range(3)]
    out = []
    for shared in (True, False):
        bundle, batch = _fresh({"gan_shared_forward": shared}, hr_batch)
        metrics = bundle.gan_step(batch, noise=noise)
        out.append((metrics, [p.detach().clone() for p in bundle.generator.parameters()],
                    [p.detach().clone() for p in bundle.discriminator.parameters()]))
    (m_a, g_a, d_a), (m_b, g_b, d_b) = out
    for k in METRICS:
        np.testing.assert_allclose(float(m_a[k]), float(m_b[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    for a, b in zip(g_a + d_a, g_b + d_b):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_label_noise_is_drawn_from_seed_and_step(hr_batch):
    """The same step draws the same labels in a fresh bundle (a resumed
    run), another step other labels; the default step is the
    discriminator's update count + 1."""
    runs = []
    for step in (5, 5, 6, None):
        bundle, batch = _fresh({}, hr_batch)
        runs.append({k: float(v) for k, v in bundle.gan_step(batch, step=step).items()})
    assert runs[0] == runs[1]
    assert runs[0]["loss_real"] != runs[2]["loss_real"]
    bundle, batch = _fresh({}, hr_batch)
    one = {k: float(v) for k, v in bundle.gan_step(batch, step=1).items()}
    assert one == runs[3]
