"""The pretrain and GAN training steps on PyTorch: the port of
``fast_srgan_tpu/train/steps.py`` (its single-device, shared-forward form).

  * ``pretrain_step`` — the generator-only phase: SmoothL1(G(lr), hr), one
    AdamW update.
  * ``gan_step`` — one GAN iteration with ONE generator forward:
      D update on sr.detach(): labels real ~ 0.3u+0.8, fake ~ 0.3u;
        d_loss = 0.5*BCE(D(hr), real) + 0.5*BCE(D(sr), fake); D steps.
      G update against the UPDATED D:
        g_loss = 0.5 * 0.1*BCE(D(sr), 0.3u+0.7) + 0.5 * content
        content = SmoothL1(VGG(sr), VGG(hr)), or SmoothL1(sr, hr) with
        training.vgg_weights=pixel; one backward into G (D's parameters take
        no gradient from it).

Input is a uint8 [B, H, W, 3] HR crop batch on the device; the LR input is
synthesized on the device (antialiased bicubic). bf16 policy
(``training.bf16``): fp32 parameters and AdamW state, compute under
``torch.autocast`` in bf16, losses in fp32. JAX's jit, donation and mesh
have no counterpart here: the steps run eagerly and update in place.

Not ported yet, and refused with NotImplementedError rather than ignored:
grad_accum, ema_decay, grad_clip, lr_schedule, augment,
gan_shared_forward=false, remat, remat_vgg, vgg_concat.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.models.init import lecun_normal_init_
from fast_srgan_torch.models.vgg import VGG19Features, load_torchvision_state_dict
from fast_srgan_torch.ops.resize import resize_bicubic
from fast_srgan_torch.train.losses import bce_with_logits_loss, smooth_l1_loss

#: training options of the JAX package the port does not run yet, with the
#: only value it takes (the default, which is the reference recipe).
UNPORTED_TRAINING_OPTIONS = {
    "grad_accum": 1,
    "ema_decay": 0.0,
    "grad_clip": 0.0,
    "lr_schedule": None,
    "augment": False,
    "gan_shared_forward": True,
    "remat": False,
    "remat_vgg": False,
    "vgg_concat": False,
}

METRICS = ("d_loss", "loss_real", "loss_fake", "g_loss", "adv_loss", "content_loss")


def make_optimizer(params, lr: float) -> torch.optim.AdamW:
    """AdamW with torch defaults (betas (0.9, 0.999), eps 1e-8, weight decay
    0.01) at a constant LR: the update optax's ``adamw`` makes."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )


def prepare_batch(hr_u8: torch.Tensor, lr_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W, 3] HR crops -> ([-1,1] LR, [-1,1] HR), fp32 NCHW
    channels_last, on hr_u8's device: float -> antialiased bicubic of the
    0..255 values -> /127.5 - 1 (the reference pipeline's order)."""
    hr_f = hr_u8.permute(0, 3, 1, 2).float()
    lr_f = resize_bicubic(hr_f, lr_size, lr_size, antialias=True)
    hr_f = hr_f.contiguous(memory_format=torch.channels_last)
    return lr_f / 127.5 - 1.0, hr_f / 127.5 - 1.0


def check_supported(config) -> None:
    """Raise NotImplementedError for a training option the port lacks."""
    for key, default in UNPORTED_TRAINING_OPTIONS.items():
        value = config.training.get(key, default)
        if value != default:
            raise NotImplementedError(
                f"training.{key}={value!r} is not ported to fast_srgan_torch yet"
                f" (only {default!r})"
            )


def _load_vgg(config, generator: torch.Generator) -> Optional[VGG19Features]:
    """The VGG mode gate of the JAX build_bundle: null with a GAN phase
    raises; "pixel" runs no VGG; "init" fixed-seed weights; else a path to a
    torchvision vgg19 state_dict."""
    vgg_path = config.training.vgg_weights
    if not vgg_path and config.training.iterations > 0:
        raise ValueError(
            "training.iterations > 0 (GAN phase) but training.vgg_weights is "
            "not set. The reference recipe needs ImageNet VGG19 weights: pass "
            "torchvision's vgg19-dcbb9e9d.pth as training.vgg_weights=/path. "
            "Explicit opt-outs: training.vgg_weights=pixel (pixel-space "
            "SmoothL1 content loss, NOT the reference recipe) or =init "
            "(fixed-seed random VGG: profiling only). Pretrain-only runs "
            "(training.iterations=0) need no VGG."
        )
    if not vgg_path or vgg_path == "pixel":
        if vgg_path == "pixel":
            print(
                "training.vgg_weights=pixel: GAN content loss is pixel-space "
                "SmoothL1 (explicit opt-out; the reference recipe uses "
                "ImageNet-VGG19 features)"
            )
        return None
    vgg = lecun_normal_init_(VGG19Features(), generator)
    if vgg_path != "init":
        sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
        load_torchvision_state_dict(vgg, sd)
    return vgg


class GanBundle:
    """Models, optimizers and the two steps, on one device.

    ``pretrain_step(hr_u8)`` returns the loss; ``gan_step(hr_u8, noise)``
    returns the six metrics (fp32 scalar tensors, not synchronized).
    ``noise`` is the three U[0,1) draws (real labels, fake labels, G
    labels), each of the logits' shape [B, 1, h, w]; without it they come
    from ``self.noise_generator``.
    """

    def __init__(self, config, generator, discriminator, vgg, device, noise_generator):
        self.config = config
        self.generator = generator
        self.discriminator = discriminator
        self.vgg = vgg
        self.device = device
        self.noise_generator = noise_generator
        self.lr_size = config.data.lr_image_size
        self.bf16 = bool(config.training.bf16)
        self.g_opt = make_optimizer(generator.parameters(), config.training.generator_lr)
        self.d_opt = make_optimizer(
            discriminator.parameters(), config.training.discriminator_lr
        )

    def _autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def pretrain_step(self, hr_u8: torch.Tensor) -> torch.Tensor:
        lr_img, hr_img = prepare_batch(hr_u8, self.lr_size)
        with self._autocast():
            sr = self.generator(lr_img)
        loss = smooth_l1_loss(sr, hr_img)
        self.g_opt.zero_grad(set_to_none=True)
        loss.backward()
        self.g_opt.step()
        return loss.detach()

    def _content(self, sr: torch.Tensor, hr_img: torch.Tensor) -> torch.Tensor:
        if self.vgg is None:
            return smooth_l1_loss(sr, hr_img)  # the pixel anchor
        with self._autocast():
            f_sr = self.vgg(sr)
            with torch.no_grad():
                f_hr = self.vgg(hr_img)
        return smooth_l1_loss(f_sr, f_hr)

    def gan_step(
        self, hr_u8: torch.Tensor, noise: Optional[Sequence[torch.Tensor]] = None
    ) -> Dict[str, torch.Tensor]:
        d = self.discriminator
        lr_img, hr_img = prepare_batch(hr_u8, self.lr_size)
        with self._autocast():
            sr = self.generator(lr_img)  # the one G forward
            y_real = d(hr_img)
            y_fake = d(sr.detach())
        if noise is None:
            noise = [
                torch.rand(y_real.shape, device=self.device, generator=self.noise_generator)
                for _ in range(3)
            ]
        u_real, u_fake, u_g = (n.to(self.device, torch.float32) for n in noise)

        loss_real = bce_with_logits_loss(y_real, 0.3 * u_real + 0.8)
        loss_fake = bce_with_logits_loss(y_fake, 0.3 * u_fake)
        d_loss = 0.5 * loss_real + 0.5 * loss_fake
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_opt.step()

        # G against the updated D; D's parameters stay out of this graph, so
        # their .grad keeps the D update's gradient.
        d.requires_grad_(False)
        try:
            with self._autocast():
                y_g = d(sr)
            adv_loss = 0.1 * bce_with_logits_loss(y_g, 0.3 * u_g + 0.7)
            content_loss = self._content(sr, hr_img)
            g_loss = 0.5 * adv_loss + 0.5 * content_loss
            self.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
        finally:
            d.requires_grad_(True)
        self.g_opt.step()
        values = (d_loss, loss_real, loss_fake, g_loss, adv_loss, content_loss)
        return {k: v.detach() for k, v in zip(METRICS, values)}


def build_bundle(
    config, device="cuda", generator: Optional[torch.Generator] = None
) -> GanBundle:
    """Models (channels_last, fp32 parameters, the JAX package's init),
    the VGG content mode, and both AdamW optimizers on ``device``.

    ``generator`` (a CPU ``torch.Generator``; default seeded from
    ``experiment.seed``) draws the initial weights and then the label noise.

    ``kernels.use_pallas`` has no effect here: on a CUDA device every kernel
    of the path runs, on the CPU every plain version. ``kernels.fused_upsample``
    chooses the upsample stage's form (one fused kernel, or conv + shuffle).
    """
    check_supported(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.experiment.seed))
    vgg = _load_vgg(config, generator)  # the config error surfaces first
    g = Generator(
        n_filters=config.generator.n_filters,
        n_layers=config.generator.n_layers,
        scale_factor=config.data.scale_factor,
        fused_upsample=bool(config.kernels.get("fused_upsample", False)),
    )
    d = Discriminator(n_filters=config.discriminator.n_filters)
    models = [lecun_normal_init_(g, generator), lecun_normal_init_(d, generator)]
    if vgg is not None:
        models.append(vgg)
    for m in models:
        m.to(device=device, memory_format=torch.channels_last)
    noise_generator = generator
    if device.type != "cpu":
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        noise_generator = torch.Generator(device=device).manual_seed(seed)
    return GanBundle(config, g, d, vgg, device, noise_generator)
