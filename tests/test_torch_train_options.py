"""The training options of fast_srgan_torch/train/steps.py against the JAX
package's, on the CPU in fp32 at tests/test_torch_train.py's tiny config,
held to that file's bars for a step: metrics rtol 1e-5, and the update
check (p1 - p0 against JAX's within lr/100 wherever the gradient is above
1e-3 of its tensor's scale, 2*lr elsewhere; its planted faults are in
tests/test_torch_train.py).

Here, the options that act in the pretrain step (one JAX ``build_bundle``
each, the same initial weights, JAX's own augmentation coins):
``ema_decay``, ``grad_clip``, ``augment``, ``grad_accum`` (``remat`` is
held against JAX in the GAN step, in
tests/test_torch_train_gan_augment_remat.py); and
without JAX's steps: ``make_lr_schedule`` against optax's schedules at
counts 0..N (abs 1e-12, both in float64), ``clip_by_global_norm_`` against
optax's ``clip_by_global_norm`` (rtol 1e-6), remat's gradients against the
plain ones, the per-step augmentation keys, and ``check_world``'s rules.
The GAN-side options are in tests/test_torch_train_gan_options.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.config import default_config
from fast_srgan_torch.train.steps import (
    PRETRAIN_AUGMENT_TAG,
    build_bundle,
    clip_by_global_norm_,
    make_lr_schedule,
    update_count,
)
from fast_srgan_torch.parallel.dist import DistInfo
from fast_srgan_torch.train.trainer import check_world
from fast_srgan_tpu.config import default_config as jax_default_config
from fast_srgan_tpu.ops.augment import augment_dihedral
from fast_srgan_tpu.train import losses as jax_losses
from fast_srgan_tpu.train.steps import build_bundle as jax_build_bundle
from fast_srgan_tpu.train.steps import make_lr_schedule as jax_make_lr_schedule
from fast_srgan_tpu.train.steps import prepare_batch as jax_prepare_batch
from test_torch_train import LR, _assert_grads, _assert_update, _host, _params, hr_batch, tiny  # noqa: F401

torch.set_num_threads(1)

PRETRAIN_OPTIONS = {
    "ema_decay": {"ema_decay": 0.9},
    # far below the gradients' norm: Adam's step then depends on the scale
    # through eps, so a missing or wrong clip moves the update
    "grad_clip": {"grad_clip": 1e-7},
    "augment": {"augment": True},
    "grad_accum": {"grad_accum": 2},
}


def _jax_pretrain_coins(seed, step, n):
    """JAX's pretrain coins: fold (seed, 0xD4, TrainState.step) into a key."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 0xD4), step)
    return key, np.array(jax.random.bernoulli(key, shape=(3, n)))


@pytest.mark.parametrize("option", sorted(PRETRAIN_OPTIONS))
def test_pretrain_option_matches_jax(option, hr_batch):
    opts = PRETRAIN_OPTIONS[option]
    jb, g_state, _, _ = jax_build_bundle(jax_default_config(**tiny(**opts)))
    g0 = _host(g_state.params)
    batch = jnp.asarray(hr_batch)
    bundle = build_bundle(default_config(**tiny(**opts)), "cpu")
    if option == "augment":
        seed = int(jax_default_config().experiment.seed)
        key, coins = _jax_pretrain_coins(seed, 0, hr_batch.shape[0])
        batch = augment_dihedral(batch, key)
        keys = []

        def jax_coins(n, *k):
            keys.append(k)
            return torch.from_numpy(coins)

        bundle.coins = jax_coins
    # the gradient of the (augmented) full batch: the mean over equal
    # micro-batches is the same gradient
    lr_img, hr_img = jax_prepare_batch(batch, 8)
    grads = state_dict_from_jax_params(_host(jax.jit(jax.grad(
        lambda p: jax_losses.smooth_l1_loss(jb.generator.apply(p, lr_img), hr_img)
    ))(g0)))
    g_state, loss_j = jb.pretrain_step(g_state, jnp.asarray(hr_batch))

    bundle.generator.load_state_dict(state_dict_from_jax_params(g0))
    bundle.reset_ema()
    p0 = _params(bundle.generator)
    loss = bundle.pretrain_step(torch.from_numpy(hr_batch))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = state_dict_from_jax_params(_host(g_state.params))
    _assert_update(bundle.generator, p0, want, grads)
    if option != "grad_clip":  # .grad holds the mean (unclipped) gradient
        _assert_grads(bundle.generator, grads)
    if option == "augment":
        assert keys == [(PRETRAIN_AUGMENT_TAG, 0)]
    if option == "ema_decay":
        d = opts["ema_decay"]
        ema_j = state_dict_from_jax_params(_host(g_state.ema_params))
        for name, e in bundle.g_ema.named_parameters():
            p1 = dict(bundle.generator.named_parameters())[name].detach()
            torch.testing.assert_close(e, d * p0[name] + (1 - d) * p1, rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(e.numpy(), ema_j[name].numpy(), rtol=0,
                                       atol=(1 - d) * (2 * LR + LR / 100) + 1e-7, err_msg=name)


SCHEDULES = {
    "cosine": {"lr_schedule": "cosine", "lr_min_ratio": 0.2},
    "step": {"lr_schedule": "step", "lr_decay_steps": [0, 3, 3, 7], "lr_decay_factor": 0.3},
}


@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(name, offset):
    """Counts 0..N past the end of the decay, both in float64 (optax under
    jax's x64 mode)."""
    gan_steps = 10
    port = make_lr_schedule(default_config(training=SCHEDULES[name]), 1e-4, gan_steps, offset)
    with jax.enable_x64(True):
        ref = jax_make_lr_schedule(
            jax_default_config(training=SCHEDULES[name]), 1e-4, gan_steps, offset
        )
        want = [float(ref(jnp.asarray(c, jnp.int64))) for c in range(gan_steps + offset + 4)]
    got = [port(c) for c in range(len(want))]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[0] == pytest.approx(1e-4 * (0.3 if name == "step" and not offset else 1.0))


def test_lr_schedule_null_is_constant_and_unknown_raises():
    constant = make_lr_schedule(default_config(), 3e-4, 10, 5)
    assert [constant(c) for c in (0, 5, 99)] == [3e-4] * 3
    with pytest.raises(ValueError, match="lr_schedule"):
        make_lr_schedule(default_config(training={"lr_schedule": "linear"}), 1e-4, 10)


def test_schedule_lr_is_set_before_each_update(hr_batch):
    """The generator's LR follows its update count, shifted by its pretrain
    updates; the count comes from the optimizer state."""
    cfg = default_config(**tiny(lr_schedule="step", lr_decay_steps=[1],
                                pretrain_iterations=1, iterations=4))
    bundle = build_bundle(cfg, "cpu")
    seen = []
    step = bundle.g_opt.step

    def recording_step():
        seen.append(bundle.g_opt.param_groups[0]["lr"])
        step()

    bundle.g_opt.step = recording_step
    batch = torch.from_numpy(hr_batch)
    for _ in range(3):
        bundle.pretrain_step(batch)
    assert seen == pytest.approx([1e-4, 1e-4, 5e-5])
    assert update_count(bundle.g_opt) == 3


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in arrays], None)
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    clip_by_global_norm_(grads, max_norm)
    for g, w, a in zip(grads, want, arrays):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if max_norm > 100:
            np.testing.assert_array_equal(g.numpy(), a)  # below the norm: as they are


def test_remat_gradients_equal_plain(hr_batch):
    grads = []
    for remat in (False, True):
        bundle = build_bundle(default_config(**tiny(remat=remat)), "cpu")
        assert bundle.generator.remat is remat
        bundle.pretrain_step(torch.from_numpy(hr_batch))
        grads.append([p.grad.clone() for p in bundle.generator.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_augment_keys_follow_the_update_count(hr_batch):
    bundle = build_bundle(default_config(**tiny(augment=True)), "cpu")
    keys = []
    coins = bundle.coins

    def recording(n, *key):
        keys.append(key)
        return coins(n, *key)

    bundle.coins = recording
    batch = torch.from_numpy(hr_batch)
    bundle.pretrain_step(batch)
    bundle.pretrain_step(batch)
    bundle.gan_step(batch)
    bundle.gan_step(batch, step=7)
    assert keys == [(PRETRAIN_AUGMENT_TAG, 0), (PRETRAIN_AUGMENT_TAG, 1), (1,), (7,)]
    # a key draws the same coins in any bundle (a resumed run replays them)
    other = build_bundle(default_config(**tiny(augment=True)), "cpu")
    assert torch.equal(coins(4, 7), other.coins(4, 7))
    assert not torch.equal(coins(64, 7), coins(64, 8))


def test_check_world_holds_the_config_to_the_processes():
    """parallel.num_devices is the number of processes; the global batch
    splits over them, and each rank's slice over grad_accum."""
    two = DistInfo(rank=1, world=2, group=object())
    check_world(default_config(parallel={"num_devices": 1}), DistInfo())
    check_world(default_config(parallel={"num_devices": 2},
                               training={"batch_size": 4, "grad_accum": 2}), two)
    with pytest.raises(SystemExit, match="nproc_per_node 2"):
        check_world(default_config(parallel={"num_devices": 2}), DistInfo())
    with pytest.raises(SystemExit, match="divisible by the mesh size"):
        check_world(default_config(training={"batch_size": 3}), two)
    with pytest.raises(SystemExit, match="grad_accum"):
        check_world(default_config(training={"batch_size": 4, "grad_accum": 4}), two)
