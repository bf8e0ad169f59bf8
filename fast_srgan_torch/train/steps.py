"""The training steps on PyTorch: the port of ``fast_srgan_tpu/train/steps.py``.

  * ``pretrain_step`` — the generator-only phase: SmoothL1(G(lr), hr), one
    AdamW update.
  * ``gan_step`` — one GAN iteration:
      D update on a detached sr: labels real ~ 0.3u+0.8, fake ~ 0.3u;
        d_loss = 0.5*BCE(D(hr), real) + 0.5*BCE(D(sr), fake); D steps.
      G update against the UPDATED D:
        g_loss = 0.5 * 0.1*BCE(D(sr), 0.3u+0.7) + 0.5 * content
        content = SmoothL1(VGG(sr), VGG(hr)), or SmoothL1(sr, hr) with
        training.vgg_weights=pixel; one backward into G (D's parameters take
        no gradient from it).
    The shared form (default) runs the generator ONCE and serves both
    updates from it; ``training.gan_shared_forward=false``, and any
    ``grad_accum`` > 1, take the recompute form (a detached forward for the
    D update, a fresh one for the G update, as the reference does). Both
    give the same result on the same noise.
  * ``eval_step`` — masked per-batch (SSE, SSIM sum, count) on
    [0,1]-mapped images, reduced on the device; ``render_step`` — a panel.

Input is a uint8 [B, H, W, 3] HR crop batch on the device; the LR input is
synthesized on the device (antialiased bicubic). bf16 policy
(``training.bf16``): fp32 parameters and AdamW state, compute under
``torch.autocast`` in bf16, losses in fp32. JAX's jit, donation and mesh
have no counterpart here: the steps run eagerly and update in place.

The training options, each as the JAX package runs it:

  * ``lr_schedule`` (``step``, ``cosine``): a plain function of the
    optimizer's update count, set on its param group before each update;
    the generator's is shifted by ``pretrain_iterations``. The count lives
    in the optimizer state, so a resume continues the decay.
  * ``grad_clip``: optax's ``clip_by_global_norm`` (gradients as they are
    below the norm, else ``g / norm * max_norm``), before both AdamWs.
  * ``ema_decay``: ``e <- d*e + (1-d)*p`` after every generator update, in
    both phases; ``g_ema`` starts at the initial parameters.
  * ``augment``: per-sample dihedral transforms of the HR crops; the coins
    come from (seed, 0xD4, G update count) in pretrain and (seed, step) in
    the GAN phase, so a resumed run replays them.
  * ``grad_accum`` k: the mean gradient (and mean metrics) over k equal
    micro-batches before one update.
  * ``remat``: ``torch.utils.checkpoint`` around each ResidualBlock (the
    recompute runs the IN kernels' forwards again).
  * ``remat_vgg``, ``vgg_concat``: the VGG content term checkpointed, and
    one VGG forward over ``cat([sr, hr])`` split in two.

Label noise per GAN step comes from (seed, step); ``gan_step(noise=...)``
takes it explicitly instead.

Data parallel (``dist=``, :mod:`fast_srgan_torch.parallel.dist`): each rank
steps on its contiguous slice of the global batch, and every rank applies
the update one process would apply to the global batch, as the JAX mesh
step does. The initial parameters are rank 0's (broadcast at build); each
model's gradients are all-reduced to their mean through one flat buffer
after the micro-batch mean and before the clip, so the clip sees the global
norm; the augmentation coins and the label noise are drawn for the global
batch and sliced, so a sample gets the draws it gets in one process.
``training.grad_accum`` splits each rank's slice. Metrics stay per rank
until :meth:`GanBundle.mean_over_ranks` (the trainer calls it on the steps
it logs). ``parallel.scale_lr`` multiplies both learning rates by the world
size. The all-reduce is not overlapped with the backward (no DDP: its hooks
and unused-parameter search sit badly with the GAN step's several backward
passes through D and its ``requires_grad_`` toggling).
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fast_srgan_torch.metrics.psnr_ssim import ssim_per_image
from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.models.init import lecun_normal_init_
from fast_srgan_torch.models.vgg import VGG19Features, load_torchvision_state_dict
from fast_srgan_torch.ops.augment import apply_dihedral, draw_coins
from fast_srgan_torch.ops.resize import resize_bicubic
from fast_srgan_torch.parallel.dist import (
    SINGLE,
    DistInfo,
    all_reduce_mean_,
    broadcast_module_,
)
from fast_srgan_torch.train.losses import bce_with_logits_loss, smooth_l1_loss

METRICS = ("d_loss", "loss_real", "loss_fake", "g_loss", "adv_loss", "content_loss")
#: the pretrain phase's augmentation key tag (the JAX package's fold-in).
PRETRAIN_AUGMENT_TAG = 0xD4
#: the GAN label noise's key tag, apart from the GAN step's augmentation.
NOISE_TAG = 0x4E

def make_optimizer(params, lr: float) -> torch.optim.AdamW:
    """AdamW with torch defaults (betas (0.9, 0.999), eps 1e-8, weight decay
    0.01): the update optax's ``adamw`` makes. The LR is set per update
    (:func:`make_lr_schedule`)."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )


def make_lr_schedule(
    config, base_lr: float, gan_steps: int, pretrain_offset: int = 0
) -> Callable[[int], float]:
    """training.lr_schedule as a function of the optimizer's update count
    (the LR of the update that follows ``count`` updates), optax's
    schedules in float64:

      * null: base_lr (the reference's constant LR);

      * ``"step"``: base_lr times lr_decay_factor for each milestone of
        lr_decay_steps the count has reached (``piecewise_constant``);
      * ``"cosine"``: from base_lr to base_lr * lr_min_ratio over
        ``gan_steps`` updates, then flat (``cosine_decay_schedule``).

    Milestones count GAN-phase updates for both nets: the generator's
    schedule is base_lr for its first ``pretrain_offset`` updates and then
    the same function of ``count - pretrain_offset`` (``join_schedules``).
    """
    sched = config.training.get("lr_schedule")
    if not sched:
        return lambda count: base_lr
    if sched == "cosine":
        decay = float(max(1, int(gan_steps)))
        alpha = float(config.training.get("lr_min_ratio", 0.1))

        def inner(count: int) -> float:
            t = min(float(count), decay)
            cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
            return base_lr * ((1 - alpha) * cosine + alpha)
    elif sched == "step":
        factor = float(config.training.get("lr_decay_factor", 0.5))
        milestones = sorted({int(s) for s in config.training.get("lr_decay_steps") or []})

        def inner(count: int) -> float:
            v = base_lr
            for m in milestones:
                if count >= m:
                    v = factor * v
            return v
    else:
        raise ValueError(
            f"unknown training.lr_schedule {sched!r} (null, 'step', 'cosine')"
        )
    if not pretrain_offset:
        return inner
    offset = int(pretrain_offset)
    return lambda count: base_lr if count < offset else inner(count - offset)


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates the optimizer has taken: AdamW's per-parameter ``step``
    (a CPU tensor, so reading it does not wait for the card), 0 before
    the first."""
    state = opt.state.get(opt.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: leave the gradients as they
    are where their global norm is below ``max_norm``, else ``g / norm *
    max_norm``. No host sync: the branch is a select on the device.
    (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
    1e-6)`` instead.)"""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


def step_seed(*parts: int) -> int:
    """A 63-bit seed from the integers ``parts`` (numpy's SeedSequence mixes
    them, so nearby tuples give unrelated streams)."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)
    return int(words[0]) & (2**63 - 1)


def prepare_batch(hr_u8: torch.Tensor, lr_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W, 3] HR crops -> ([-1,1] LR, [-1,1] HR), fp32 NCHW
    channels_last, on hr_u8's device: float -> antialiased bicubic of the
    0..255 values -> /127.5 - 1 (the reference pipeline's order)."""
    hr_f = hr_u8.permute(0, 3, 1, 2).float()
    lr_f = resize_bicubic(hr_f, lr_size, lr_size, antialias=True)
    hr_f = hr_f.contiguous(memory_format=torch.channels_last)
    return lr_f / 127.5 - 1.0, hr_f / 127.5 - 1.0


def _load_vgg(
    config, generator: torch.Generator, dist: DistInfo = SINGLE
) -> Optional[VGG19Features]:
    """The VGG mode gate of the JAX build_bundle: null with a GAN phase
    raises; "pixel" runs no VGG; "init" fixed-seed weights; else a path to a
    torchvision vgg19 state_dict. The gate runs before any model is built,
    so a config error surfaces first."""
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
        if vgg_path == "pixel" and dist.is_main:
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
    """Models, optimizers and the steps, on one device.

    ``pretrain_step(hr_u8)`` returns the loss; ``gan_step(hr_u8, noise,
    step)`` the six metrics (fp32 scalar tensors, not synchronized).
    ``noise`` is the three U[0,1) draws (real labels, fake labels, G
    labels), each of the logits' shape [B, 1, h, w] for the global batch (a
    rank and a micro-batch take their rows); without it they are drawn from
    (experiment.seed, step), ``step`` defaulting to the discriminator's
    update count + 1 (the GAN loop's step).
    ``g_ema`` is the generator's weight average (``training.ema_decay``), or
    None; ``eval_model`` is what validation and panels run.
    """

    def __init__(self, config, generator, discriminator, vgg, device,
                 dist: Optional[DistInfo] = None):
        cfg = config.training
        self.dist = dist or SINGLE
        for model in (generator, discriminator):
            broadcast_module_(model, self.dist)
        self.config = config
        self.generator = generator
        self.discriminator = discriminator
        self.vgg = vgg
        self.device = device
        self.seed = int(config.experiment.seed)
        self.lr_size = config.data.lr_image_size
        self.bf16 = bool(cfg.bf16)
        # parallel.scale_lr: the linear rule for a global batch world times
        # a rank's
        scale = self.dist.world if config.parallel.get("scale_lr") else 1
        g_lr, d_lr = cfg.generator_lr * scale, cfg.discriminator_lr * scale
        self.g_opt = make_optimizer(generator.parameters(), g_lr)
        self.d_opt = make_optimizer(discriminator.parameters(), d_lr)
        self.g_lr = make_lr_schedule(
            config, g_lr, cfg.iterations, pretrain_offset=cfg.pretrain_iterations
        )
        self.d_lr = make_lr_schedule(config, d_lr, cfg.iterations)
        self.grad_clip = float(cfg.get("grad_clip", 0.0) or 0.0)
        self.ema_decay = float(cfg.get("ema_decay", 0.0) or 0.0)
        self.augment = bool(cfg.get("augment", False))
        self.accum = int(cfg.get("grad_accum", 1) or 1)
        self.shared_forward = bool(cfg.get("gan_shared_forward", True)) and self.accum == 1
        self.remat_vgg = bool(cfg.get("remat_vgg", False))
        self.vgg_concat = bool(cfg.get("vgg_concat", False))
        self.g_ema = None
        self.reset_ema()
        self._noise_generator = torch.Generator(device=device)

    # -- helpers ---------------------------------------------------------------

    def reset_ema(self) -> None:
        """Start the weight average at the generator's current parameters
        (build, warm start)."""
        if self.ema_decay:
            self.g_ema = copy.deepcopy(self.generator).requires_grad_(False)

    @property
    def eval_model(self) -> Generator:
        return self.g_ema if self.g_ema is not None else self.generator

    def _autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def coins(self, n: int, *key: int) -> torch.Tensor:
        """The augmentation coins for ``key``: bool [3, n] on the device,
        drawn on the host from a generator seeded by (seed, *key)."""
        coins = draw_coins(n, torch.Generator().manual_seed(step_seed(self.seed, *key)))
        return coins.to(self.device, non_blocking=True)

    def _augment(self, hr_u8: torch.Tensor, *key: int) -> torch.Tensor:
        """The dihedral transforms of this rank's rows: the coins are drawn
        for the global batch and sliced."""
        n = hr_u8.shape[0]
        coins = self.coins(n * self.dist.world, *key)[:, self.dist.rows(n)]
        return apply_dihedral(hr_u8, coins)

    def _microbatches(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        if x.shape[0] % self.accum:
            raise ValueError(
                f"training.batch_size {x.shape[0]} not divisible by "
                f"training.grad_accum {self.accum}"
            )
        return x.chunk(self.accum) if self.accum > 1 else (x,)

    def _update(self, opt, schedule: Callable[[int], float], model) -> None:
        """One optimizer update from the accumulated .grad: the mean over
        the micro-batches, clipped, at the scheduled LR."""
        lr = schedule(update_count(opt))
        for group in opt.param_groups:
            group["lr"] = lr
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        all_reduce_mean_(grads, self.dist)
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip)
        opt.step()
        if model is self.generator and self.g_ema is not None:
            ema = list(self.g_ema.parameters())
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(
                ema, [p.detach() for p in model.parameters()], alpha=1.0 - self.ema_decay
            )

    def _vgg(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat_vgg and torch.is_grad_enabled():
            return checkpoint(self.vgg, x, use_reentrant=False, preserve_rng_state=False)
        return self.vgg(x)

    def _content(self, sr: torch.Tensor, hr_img: torch.Tensor) -> torch.Tensor:
        if self.vgg is None:
            return smooth_l1_loss(sr, hr_img)  # the pixel anchor
        with self._autocast():
            if self.vgg_concat:
                f_sr, f_hr = self._vgg(torch.cat([sr, hr_img.detach()])).chunk(2)
            else:
                f_sr = self._vgg(sr)
                with torch.no_grad():
                    f_hr = self.vgg(hr_img)
        return smooth_l1_loss(f_sr, f_hr)

    def _label_noise(self, noise, shape, step: int) -> List[torch.Tensor]:
        """(u_real, u_fake, u_g) for this rank's rows (``shape``), fp32 on
        the device: the global batch's draws, sliced."""
        rows = self.dist.rows(shape[0])
        if noise is not None:
            return [n.to(self.device, torch.float32)[rows] for n in noise]
        self._noise_generator.manual_seed(step_seed(self.seed, step, NOISE_TAG))
        shape = (shape[0] * self.dist.world,) + tuple(shape[1:])
        return [torch.rand(shape, device=self.device, generator=self._noise_generator)[rows]
                for _ in range(3)]

    def _g_adv_content(self, sr, hr_img, u_g):
        with self._autocast():
            y_g = self.discriminator(sr)
        adv_loss = 0.1 * bce_with_logits_loss(y_g, 0.3 * u_g + 0.7)
        content_loss = self._content(sr, hr_img)
        return 0.5 * adv_loss + 0.5 * content_loss, adv_loss, content_loss

    def mean_over_ranks(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Metrics (fp32 scalars) as means over the global batch: their mean
        over the ranks, whose slices are of one size (one all-reduce; the
        values themselves in a world of one)."""
        flat = [v.detach().float().reshape(1) for v in values]
        all_reduce_mean_(flat, self.dist)
        return [v[0] for v in flat]

    # -- steps -----------------------------------------------------------------

    def pretrain_step(self, hr_u8: torch.Tensor) -> torch.Tensor:
        if self.augment:
            hr_u8 = self._augment(hr_u8, PRETRAIN_AUGMENT_TAG, update_count(self.g_opt))
        self.g_opt.zero_grad(set_to_none=True)
        losses = []
        for hr_i in self._microbatches(hr_u8):
            lr_img, hr_img = prepare_batch(hr_i, self.lr_size)
            with self._autocast():
                sr = self.generator(lr_img)
            loss = smooth_l1_loss(sr, hr_img)
            loss.backward()
            losses.append(loss.detach())
        self._update(self.g_opt, self.g_lr, self.generator)
        return losses[0] if len(losses) == 1 else torch.stack(losses).mean()

    def gan_step(
        self,
        hr_u8: torch.Tensor,
        noise: Optional[Sequence[torch.Tensor]] = None,
        step: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        if step is None:
            step = update_count(self.d_opt) + 1
        if self.augment:
            hr_u8 = self._augment(hr_u8, step)
        if self.shared_forward:
            values = self._gan_shared(hr_u8, noise, step)
        else:
            values = self._gan_recompute(hr_u8, noise, step)
        return {k: v.detach() for k, v in zip(METRICS, values)}

    def _d_losses(self, y_real, y_fake, u_real, u_fake):
        loss_real = bce_with_logits_loss(y_real, 0.3 * u_real + 0.8)
        loss_fake = bce_with_logits_loss(y_fake, 0.3 * u_fake)
        return 0.5 * loss_real + 0.5 * loss_fake, loss_real, loss_fake

    def _gan_shared(self, hr_u8, noise, step):
        d = self.discriminator
        lr_img, hr_img = prepare_batch(hr_u8, self.lr_size)
        with self._autocast():
            sr = self.generator(lr_img)  # the one G forward
            y_real = d(hr_img)
            y_fake = d(sr.detach())
        u_real, u_fake, u_g = self._label_noise(noise, y_real.shape, step)
        d_loss, loss_real, loss_fake = self._d_losses(y_real, y_fake, u_real, u_fake)
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self._update(self.d_opt, self.d_lr, d)

        # G against the updated D; D's parameters stay out of this graph, so
        # their .grad keeps the D update's gradient.
        d.requires_grad_(False)
        try:
            g_loss, adv_loss, content_loss = self._g_adv_content(sr, hr_img, u_g)
            self.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
        finally:
            d.requires_grad_(True)
        self._update(self.g_opt, self.g_lr, self.generator)
        return d_loss, loss_real, loss_fake, g_loss, adv_loss, content_loss

    def _gan_recompute(self, hr_u8, noise, step):
        """The reference's two generator forwards a step (and the only form
        with micro-batches): a detached one for the D update, a fresh one
        for the G update against the updated D. Micro-batch i takes rows
        i*B/k.. of the noise."""
        d = self.discriminator
        micro = self._microbatches(hr_u8)
        k = len(micro)
        outs = []
        self.d_opt.zero_grad(set_to_none=True)
        for i, hr_i in enumerate(micro):
            lr_img, hr_img = prepare_batch(hr_i, self.lr_size)
            with self._autocast():
                with torch.no_grad():
                    sr = self.generator(lr_img)
                y_real = d(hr_img)
                y_fake = d(sr)
            if i == 0:
                shape = (hr_u8.shape[0],) + tuple(y_real.shape[1:])
                noise = [n.chunk(k) for n in self._label_noise(noise, shape, step)]
            losses = self._d_losses(y_real, y_fake, noise[0][i], noise[1][i])
            losses[0].backward()
            outs.append(losses)
        self._update(self.d_opt, self.d_lr, d)

        d.requires_grad_(False)
        try:
            self.g_opt.zero_grad(set_to_none=True)
            for i, hr_i in enumerate(micro):
                lr_img, hr_img = prepare_batch(hr_i, self.lr_size)
                with self._autocast():
                    sr = self.generator(lr_img)
                g_losses = self._g_adv_content(sr, hr_img, noise[2][i])
                g_losses[0].backward()
                outs[i] = outs[i] + g_losses
        finally:
            d.requires_grad_(True)
        self._update(self.g_opt, self.g_lr, self.generator)
        return tuple(torch.stack([o[j].detach() for o in outs]).mean() for j in range(6))

    @torch.no_grad()
    def eval_step(
        self, hr_u8: torch.Tensor, valid: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Masked [0,1]-mapped (SSE sum, SSIM sum, count) of a batch, fp32
        scalars on the device; ``valid`` is a float [B] mask (0 for the rows
        a tail batch was padded with)."""
        lr_img, hr_img = prepare_batch(hr_u8, self.lr_size)
        with self._autocast():
            sr = self.eval_model(lr_img)
        sr01 = (sr.float() + 1.0) / 2.0
        hr01 = (hr_img + 1.0) / 2.0
        diff = sr01 - hr01
        sse = (diff * diff).sum(dim=(1, 2, 3))
        ssim = ssim_per_image(sr01, hr01)
        v = valid.to(torch.float32)
        return (sse * v).sum(), (ssim * v).sum(), v.sum()

    @torch.no_grad()
    def render_step(self, lr01: torch.Tensor) -> torch.Tensor:
        """Panel render: [0,1] NCHW LR -> [0,1] SR (reference trainer.py:122)."""
        with self._autocast():
            sr = self.eval_model(2.0 * lr01 - 1.0)
        return ((sr.float() + 1.0) / 2.0).clamp(0.0, 1.0)


def build_bundle(
    config,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    dist: Optional[DistInfo] = None,
) -> GanBundle:
    """Models (channels_last, fp32 parameters, the JAX package's init),
    the VGG content mode, and both AdamW optimizers on ``device``.

    ``generator`` (a CPU ``torch.Generator``; default seeded from
    ``experiment.seed``) draws the initial weights.

    ``kernels.use_pallas`` has no effect here: on a CUDA device every kernel
    of the path runs, on the CPU every plain version. ``kernels.fused_upsample``
    chooses the upsample stage's form (one fused kernel, or conv + shuffle).

    ``dist`` (default: a world of one) makes the steps data-parallel; rank
    0's initial weights are broadcast to the others.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False")
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.experiment.seed))
    vgg = _load_vgg(config, generator, dist or SINGLE)
    g = Generator(
        n_filters=config.generator.n_filters,
        n_layers=config.generator.n_layers,
        scale_factor=config.data.scale_factor,
        fused_upsample=bool(config.kernels.get("fused_upsample", False)),
        remat=bool(config.training.get("remat", False)),
    )
    d = Discriminator(n_filters=config.discriminator.n_filters)
    models = [lecun_normal_init_(g, generator), lecun_normal_init_(d, generator)]
    if vgg is not None:
        models.append(vgg)
    for m in models:
        m.to(device=device, memory_format=torch.channels_last)
    return GanBundle(config, g, d, vgg, device, dist)
