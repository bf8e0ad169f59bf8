"""The port's training pieces (fast_srgan_torch/train, ops/resize, config)
against the JAX package, on the CPU in fp32. The discriminator and VGG19
forwards are in tests/test_torch_train_models.py, the training options in
tests/test_torch_train_options.py.

Tolerances: losses, resize and prepare_batch to float32 rounding (rtol
1e-6 / atol 1e-4 on 0..255 values); one pretrain and one GAN step at the tiny config of
tests/test_train_steps.py: metrics rtol 1e-5, every gradient tensor within
1e-4 of its max-abs. One-value gradients (PReLU slopes) are held to 1e-4 of
the model's largest slope gradient (see _assert_grads). The update each
step made (p1 - p0) agrees with JAX's within lr/100 wherever JAX's gradient
is above 1e-3 of its scale; the first AdamW step moves a weight by about
lr*sign(g), so only where the gradient is near zero may it flip (2*lr). A
skipped and a reversed optimizer step are planted to show the check sees
them (see _assert_update).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_srgan_tpu.config import DEFAULTS as JAX_DEFAULTS
from fast_srgan_tpu.config import default_config as jax_default_config
from fast_srgan_tpu.ops.resize import resize_bicubic_nhwc
from fast_srgan_tpu.train import losses as jax_losses
from fast_srgan_tpu.train.steps import build_bundle as jax_build_bundle
from fast_srgan_tpu.train.steps import prepare_batch as jax_prepare_batch
from fast_srgan_torch.checkpoints.convert import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from fast_srgan_torch.config import DEFAULTS, default_config
from fast_srgan_torch.models.vgg import VGG19Features
from fast_srgan_torch.ops.resize import resize_bicubic
from fast_srgan_torch.train import losses
from fast_srgan_torch.train.steps import METRICS, build_bundle, prepare_batch

torch.set_num_threads(1)

LR = 1e-4


def tiny(**training):
    """tests/test_train_steps.py's tiny config, as plain sections."""
    return dict(
        data={"lr_image_size": 8, "scale_factor": 4},
        generator={"n_filters": 8, "n_layers": 2},
        discriminator={"n_filters": 8},
        training={"bf16": False, "vgg_weights": "pixel", **training},
    )


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _host(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_d_params(model):
    """The port discriminator's weights as a JAX param tree (OIHW -> HWIO)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def conv(name, bias=True):
        leaf = {"kernel": jnp.asarray(sd[f"{name}.weight"].transpose(2, 3, 1, 0))}
        if bias:
            leaf["bias"] = jnp.asarray(sd[f"{name}.bias"])
        return leaf

    p = {"neck_conv": conv("neck.0"), "head_conv": conv("stem.7")}
    for i in range(7):
        p[f"stem_{i}"] = {"conv": conv(f"stem.{i}.conv", bias=False)}
    return {"params": p}


@pytest.fixture(scope="module")
def hr_batch():
    return np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)


class TestPieces:
    def test_losses_match_jax(self):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((3, 5, 7)).astype(np.float32) * 2
        b = rng.standard_normal((3, 5, 7)).astype(np.float32)
        z = rng.uniform(0, 1, (3, 5, 7)).astype(np.float32)
        ta, tb, tz = map(torch.from_numpy, (a, b, z))
        np.testing.assert_allclose(
            float(losses.smooth_l1_loss(ta, tb)),
            float(jax_losses.smooth_l1_loss(a, b)), rtol=1e-6,
        )
        np.testing.assert_allclose(
            float(losses.bce_with_logits_loss(ta, tz)),
            float(jax_losses.bce_with_logits_loss(a, z)), rtol=1e-6,
        )

    @pytest.mark.parametrize("antialias", [True, False])
    def test_resize_matches_jax(self, antialias):
        x = np.random.default_rng(1).uniform(0, 255, (2, 30, 22, 3)).astype(np.float32)
        want = np.asarray(resize_bicubic_nhwc(jnp.asarray(x), 9, 13, antialias))
        got = _nhwc(resize_bicubic(_nchw(x), 9, 13, antialias))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_prepare_batch_matches_jax(self, hr_batch):
        lr_j, hr_j = jax_prepare_batch(jnp.asarray(hr_batch), 8)
        lr_t, hr_t = prepare_batch(torch.from_numpy(hr_batch), 8)
        assert lr_t.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(lr_t), np.asarray(lr_j), atol=1e-6)
        np.testing.assert_array_equal(_nhwc(hr_t), np.asarray(hr_j))

    def test_defaults_match_jax_but_device(self):
        want = copy.deepcopy(JAX_DEFAULTS)
        assert want["training"].pop("device") == "tpu"
        got = copy.deepcopy(DEFAULTS)
        assert got["training"].pop("device") == "cuda"
        assert got == want


class TestVggGate:
    def test_null_with_gan_phase_raises(self):
        with pytest.raises(ValueError, match="vgg_weights"):
            build_bundle(default_config(**tiny(vgg_weights=None)), "cpu")

    def test_null_pretrain_only_and_pixel_build_no_vgg(self):
        cfg = default_config(**tiny(vgg_weights=None, iterations=0))
        assert build_bundle(cfg, "cpu").vgg is None
        assert build_bundle(default_config(**tiny()), "cpu").vgg is None

    def test_init_builds_frozen_vgg(self):
        vgg = build_bundle(default_config(**tiny(vgg_weights="init")), "cpu").vgg
        assert isinstance(vgg, VGG19Features) and not vgg.training
        assert not any(p.requires_grad for p in vgg.parameters())

    def test_path_loads_torchvision_state_dict(self, tmp_path):
        src = VGG19Features()
        sd = dict(src.state_dict())
        sd["classifier.0.weight"] = torch.zeros(2, 2)  # ignored, as torchvision's
        path = tmp_path / "vgg19.pth"
        torch.save(sd, path)
        vgg = build_bundle(default_config(**tiny(vgg_weights=str(path))), "cpu").vgg
        for k, v in src.state_dict().items():
            assert torch.equal(vgg.state_dict()[k], v), k


@pytest.mark.parametrize("use_pallas", [False, True])
def test_use_pallas_leaves_the_stem_on_the_dispatching_wrapper(
    monkeypatch, hr_batch, use_pallas
):
    """kernels.use_pallas (the JAX package's switch) does not route the
    port around the wrapper that launches the kernel on a CUDA tensor."""
    from fast_srgan_torch.models import generator as generator_module

    calls = []
    wrapper = generator_module.instance_norm_prelu

    def counting(x, alpha, valid_hw=None):
        calls.append(x.shape)
        return wrapper(x, alpha, valid_hw)

    monkeypatch.setattr(generator_module, "instance_norm_prelu", counting)
    cfg = default_config(**tiny(), kernels={"use_pallas": use_pallas})
    build_bundle(cfg, "cpu").pretrain_step(torch.from_numpy(hr_batch))
    assert len(calls) == cfg.generator.n_layers


def _port_bundle(g_params, d_params=None):
    bundle = build_bundle(default_config(**tiny()), "cpu")
    bundle.generator.load_state_dict(state_dict_from_jax_params(g_params))
    if d_params is not None:
        bundle.discriminator.load_state_dict(
            discriminator_state_dict_from_jax_params(d_params)
        )
    return bundle


def _assert_grads(model, want_sd):
    """Each gradient within 1e-4 of its tensor's max-abs. A one-value
    tensor (a PReLU slope) is held to 1e-4 of the largest slope gradient of
    the model: its gradient sums every activation of its layer, with
    cancellation, so its rounding error follows the terms, not the sum."""
    slopes = max(
        float(np.abs(want_sd[n].numpy()).max())
        for n, p in model.named_parameters() if p.numel() == 1
    ) if any(p.numel() == 1 for p in model.parameters()) else 0.0
    for name, p in model.named_parameters():
        want = want_sd[name].numpy()
        scale = slopes if p.numel() == 1 else np.abs(want).max()
        np.testing.assert_allclose(
            p.grad.numpy(), want, atol=1e-4 * scale + 1e-12, err_msg=name
        )


def _grad_scales(model, grad_sd):
    """Each tensor's gradient scale: its max-abs, or for a one-value tensor
    the model's largest one-value gradient (as in _assert_grads)."""
    ones = [float(np.abs(grad_sd[n].numpy()).max())
            for n, p in model.named_parameters() if p.numel() == 1]
    return {
        n: max(ones) if p.numel() == 1 else float(np.abs(grad_sd[n].numpy()).max())
        for n, p in model.named_parameters()
    }


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _assert_update(model, p0, want_sd, grad_sd):
    """The step's update p1 - p0 against JAX's (want - p0). Where JAX's
    gradient is above 1e-3 of its scale (ten times the gradient bar), the
    sign is certain and the updates agree within lr/100; elsewhere a
    near-zero gradient may flip the ~lr*sign(g) step, so within 2*lr."""
    scales = _grad_scales(model, grad_sd)
    n_strong = 0
    for name, p in model.named_parameters():
        got = (p.detach() - p0[name]).numpy()
        want = want_sd[name].numpy() - p0[name].numpy()
        strong = np.abs(grad_sd[name].numpy()) > 1e-3 * scales[name]
        n_strong += int(strong.sum())
        np.testing.assert_allclose(got[strong], want[strong], atol=LR / 100, rtol=0,
                                   err_msg=f"{name} (|g| above 1e-3 of its scale)")
        np.testing.assert_allclose(got, want, atol=2 * LR + LR / 100, rtol=0,
                                   err_msg=name)
    assert n_strong > 0.9 * sum(p.numel() for p in model.parameters())


@pytest.fixture(scope="module")
def jax_pretrain(hr_batch):
    """JAX's initial params, loss, gradient and updated params (state
    dicts) of one pretrain step at the tiny config."""
    jb, g_state, _, _ = jax_build_bundle(jax_default_config(**tiny()))
    g0 = _host(g_state.params)
    lr_img, hr_img = jax_prepare_batch(jnp.asarray(hr_batch), 8)
    grads = jax.jit(jax.grad(
        lambda p: jax_losses.smooth_l1_loss(jb.generator.apply(p, lr_img), hr_img)
    ))(g0)
    g_state, loss_j = jb.pretrain_step(g_state, jnp.asarray(hr_batch))
    return (g0, float(loss_j), state_dict_from_jax_params(_host(grads)),
            state_dict_from_jax_params(_host(g_state.params)))


class TestStepsAgainstJax:
    def test_pretrain_step(self, hr_batch, jax_pretrain):
        g0, loss_j, grads, g1 = jax_pretrain
        bundle = _port_bundle(g0)
        p0 = _params(bundle.generator)
        loss = bundle.pretrain_step(torch.from_numpy(hr_batch))
        np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
        _assert_grads(bundle.generator, grads)
        _assert_update(bundle.generator, p0, g1, grads)

    @pytest.mark.parametrize("fault", ["skipped", "reversed"])
    def test_update_check_catches_a_planted_fault(self, hr_batch, jax_pretrain, fault):
        g0, _, grads, g1 = jax_pretrain
        bundle = _port_bundle(g0)
        if fault == "skipped":
            bundle.g_opt.step = lambda: None
        else:  # the LR each update is set to (the schedule's) is negated
            schedule = bundle.g_lr
            bundle.g_lr = lambda count: -schedule(count)
        p0 = _params(bundle.generator)
        bundle.pretrain_step(torch.from_numpy(hr_batch))
        with pytest.raises(AssertionError, match="above 1e-3"):
            _assert_update(bundle.generator, p0, g1, grads)

    def test_gan_step(self, hr_batch):
        jb, g_state, d_state, vgg_params = jax_build_bundle(jax_default_config(**tiny()))
        g0, d0 = _host(g_state.params), _host(d_state.params)
        key = jax.random.key(11)
        # JAX's label noise, replayed from its key splits (steps.py:424-449)
        k_d, k_g = jax.random.split(key, 2)
        k_real, k_fake = jax.random.split(k_d, 2)
        shape = (4, 2, 2, 1)
        u = [np.array(jax.random.uniform(k, shape)) for k in (k_real, k_fake, k_g)]

        g_state, d_state, m_j = jb.gan_step(
            g_state, d_state, vgg_params, jnp.asarray(hr_batch), key
        )
        lr_img, hr_img = jax_prepare_batch(jnp.asarray(hr_batch), 8)
        sr = jb.generator.apply(g0, lr_img)

        def d_loss(p):
            real = jax_losses.bce_with_logits_loss(
                jb.discriminator.apply(p, hr_img), 0.3 * u[0] + 0.8)
            fake = jax_losses.bce_with_logits_loss(
                jb.discriminator.apply(p, sr), 0.3 * u[1])
            return 0.5 * real + 0.5 * fake

        bundle = _port_bundle(g0, d0)
        p0_g, p0_d = _params(bundle.generator), _params(bundle.discriminator)
        noise = [torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in u]
        metrics = bundle.gan_step(torch.from_numpy(hr_batch), noise)

        # G's gradient against the port's updated D: the two updated Ds may
        # differ by 2*lr where a near-zero D gradient flipped sign
        d1 = _jax_d_params(bundle.discriminator)

        def g_loss(p):
            out = jb.generator.apply(p, lr_img)
            adv = 0.1 * jax_losses.bce_with_logits_loss(
                jb.discriminator.apply(d1, out), 0.3 * u[2] + 0.7)
            return 0.5 * adv + 0.5 * jax_losses.smooth_l1_loss(out, hr_img)

        d_grads = discriminator_state_dict_from_jax_params(
            _host(jax.jit(jax.grad(d_loss))(d0)))
        g_grads = state_dict_from_jax_params(_host(jax.jit(jax.grad(g_loss))(g0)))
        assert set(metrics) == set(METRICS) == set(m_j)
        for k in METRICS:
            np.testing.assert_allclose(
                float(metrics[k]), float(m_j[k]), rtol=1e-5, atol=1e-7, err_msg=k
            )
        # D's .grad holds the D update's gradient alone: none of the G loss
        _assert_grads(bundle.discriminator, d_grads)
        _assert_grads(bundle.generator, g_grads)
        _assert_update(
            bundle.discriminator, p0_d,
            discriminator_state_dict_from_jax_params(_host(d_state.params)), d_grads,
        )
        _assert_update(
            bundle.generator, p0_g, state_dict_from_jax_params(_host(g_state.params)),
            g_grads,
        )

    @pytest.mark.parametrize("vgg", ["pixel", "init"])
    def test_bf16_steps_run_under_autocast(self, hr_batch, vgg):
        bundle = build_bundle(default_config(**tiny(bf16=True, vgg_weights=vgg)), "cpu")
        batch = torch.from_numpy(hr_batch)
        assert np.isfinite(float(bundle.pretrain_step(batch)))
        metrics = bundle.gan_step(batch)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert all(p.dtype == torch.float32 for p in bundle.generator.parameters())
