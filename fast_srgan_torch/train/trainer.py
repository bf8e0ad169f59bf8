"""Two-phase GAN trainer: the port of ``fast_srgan_tpu/train/trainer.py``.

Behavioral parity with the reference's Trainer (its trainer.py):

  * Phase 1 ``pretrain`` — generator-only SmoothL1 (trainer.py:89-141):
    val metrics at step 0, fixed-image panels (HighRes + antialiased 4x
    Bicubic) once, scalar `Pretrain/Generator/Loss` every log_iter,
    `Pretrain/Generated` panel + full val metrics every checkpoint_iter,
    end-of-phase checkpoint. Resume: skip the phase when the pretrain
    checkpoint exists (the reference's intent; its filename bug is not
    replicated), continue mid-phase from the latest progress snapshot.
  * Phase 2 ``train`` — adversarial + perceptual (trainer.py:158-233):
    per-step D then G updates, the reference's 4 scalar tags every
    log_iter, `GAN/Generated` + val metrics + a checkpoint every
    checkpoint_iter, and one at the end of the phase. ``iterations`` is the
    phase's total budget: a resumed run runs only what is left.

Host discipline (the steps are host-bound on the card): batches go from
pinned host memory to the device with ``non_blocking=True``; a loss is
read back (``float``) only on ``log_iter`` steps; validation keeps its sums
on the device and lets the host run at most one batch ahead; checkpoints
copy to host memory behind the step on the card's stream and write in a
background thread. Nothing in the step loop synchronizes the card.

Data parallel (``dist=``, one process a device under ``torchrun``): each
rank's loader yields its slice of the global ``training.batch_size``, the
steps all-reduce the gradients, and the logged losses are all-reduced on the
``log_iter`` steps only. Validation walks the full val list on every rank
and all-reduces its sums once a pass. Rank 0 alone writes: checkpoints, the
.pt exports, metrics and panels, and prints; the other ranks' writer drops
everything. Barriers: before every resume read (rank 0 may still be writing),
after the end-of-pretrain checkpoint, at the end of each phase. The
interrupt handlers call no collective (torchrun signals every rank at once).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from tqdm import tqdm

from fast_srgan_torch.checkpoints.io import (
    PRETRAIN_STEP,
    CheckpointIO,
    defer_sigint,
    to_host,
    tree_skeleton,
)
from fast_srgan_torch.data.pipeline import CropSampler, PrefetchLoader
from fast_srgan_torch.metrics.psnr_ssim import psnr_from_accumulator
from fast_srgan_torch.ops.resize import resize_bicubic
from fast_srgan_torch.parallel.dist import (
    SINGLE,
    DistInfo,
    all_reduce_sum_,
    barrier,
    local_rows,
)
from fast_srgan_torch.train.steps import GanBundle, build_bundle, prepare_batch, update_count
from fast_srgan_torch.utils.logging import MetricsWriter


def check_world(config, dist: DistInfo) -> None:
    """The run's processes against its config (``train.py``'s rules, with a
    process a device): ``parallel.num_devices``, when set, is the world
    size; ``training.batch_size`` is the global batch and splits over the
    ranks, and each rank's slice over ``training.grad_accum``;
    ``parallel.multihost`` needs torchrun's environment. Exits with the
    reason otherwise."""
    n = config.parallel.get("num_devices")
    if n is not None and int(n) != dist.world:
        raise SystemExit(
            f"parallel.num_devices={n} but this run has {dist.world} process(es), one a"
            f" device: launch `torchrun --nproc_per_node {n} -m fast_srgan_torch.train"
            " ...` (or leave parallel.num_devices unset)"
        )
    if config.parallel.get("multihost") and dist.group is None:
        raise SystemExit(
            "parallel.multihost needs torchrun's environment (RANK, WORLD_SIZE,"
            " MASTER_ADDR): launch `torchrun --nnodes N --nproc_per_node M"
            " --rdzv_endpoint HOST:PORT -m fast_srgan_torch.train ...` on every host"
        )
    batch = config.training.batch_size
    if batch % dist.world:
        raise SystemExit(
            f"training.batch_size={batch} must be divisible by the mesh size"
            f" ({dist.world} devices)"
        )
    accum = int(config.training.get("grad_accum", 1) or 1)
    if (batch // dist.world) % accum:
        raise SystemExit(
            f"training.batch_size={batch} over {dist.world} device(s) leaves"
            f" {batch // dist.world} a device, not divisible by training.grad_accum"
            f" {accum}"
        )


class _NullWriter:
    """The metrics writer of a rank other than 0: drops everything."""

    def scalar(self, *args) -> None:
        pass

    images = flush = close = scalar


def evaluate_pass(
    bundle: GanBundle, val_sampler: CropSampler, batch_size: int, seed: int, put
) -> Dict[str, float]:
    """One full deterministic pass over ``val_sampler``: aggregate PSNR and
    mean SSIM on [0,1] images (reference trainer.py:53-69 protocol), and the
    image count.

    Batches are of the global ``batch_size``, the tail padded up to it (one
    shape for the whole pass) and its padding rows masked out of the
    statistics on the device. Every rank walks the same full list (the val
    sampler is never sharded) and evaluates its rows of each batch; the
    three sums are all-reduced once, so each image counts once and every
    rank returns the one-process result. ``put`` moves a host batch to the
    device. The sums stay on the device; an event a batch lets the host run
    at most one batch ahead of the card, with no sync per batch; the totals
    are read back once."""
    dist, device = bundle.dist, bundle.device
    rows = local_rows(batch_size, dist.rank, dist.world)
    hr_size = bundle.lr_size * bundle.config.data.scale_factor
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    index = torch.arange(batch_size, device=device)[rows]
    in_flight = []
    for batch in val_sampler.sequential_batches(batch_size, seed=seed, drop_last=False):
        valid = batch.shape[0]
        if valid < batch_size:
            batch = np.concatenate([batch, batch[-1:].repeat(batch_size - valid, 0)])
        out = bundle.eval_step(put(batch[rows]), index < valid)
        sums += torch.stack(out).double()
        if device.type == "cuda":
            in_flight.append(torch.cuda.Event())
            in_flight[-1].record()
            if len(in_flight) > 1:
                in_flight.pop(0).synchronize()
    all_reduce_sum_([sums], dist)
    sse, ssim_sum, images = sums.tolist()
    return {
        "psnr": psnr_from_accumulator(sse, float(hr_size * hr_size * 3) * images),
        "ssim": ssim_sum / max(images, 1),
        # JAX counts each image once a host (every host evaluates the whole
        # global batch); its PSNR and SSIM are the same ratios
        "images": images,
    }


class PinnedFeed:
    """Host batches onto the device through a ring of pinned staging
    buffers (one ring a batch shape): copy the batch into the next slot,
    upload it with ``non_blocking=True``, and record an event; a slot is
    refilled only after the upload that last read it has completed, which
    has long happened by the time the ring comes round. No allocation and
    no wait for the card on the common path."""

    SLOTS = 3

    def __init__(self, device: torch.device):
        self.device = device
        self._rings: Dict[tuple, list] = {}  # uint8 batch shape -> slots
        self._turn = 0

    def __call__(self, batch: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(batch)
        ring = self._rings.get(batch.shape)
        if ring is None:
            ring = self._rings[batch.shape] = [
                [torch.empty(batch.shape, dtype=torch.uint8, pin_memory=True), None]
                for _ in range(self.SLOTS)
            ]
        slot = ring[self._turn % self.SLOTS]
        self._turn += 1
        if slot[1] is not None:
            slot[1].synchronize()
        slot[0].numpy()[...] = batch
        on_device = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return on_device


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


class Trainer:
    """Owns the bundle (models, optimizers, steps), the metrics writer and
    checkpoint IO, on one device (``"cuda"`` by default); ``dist`` makes it
    one rank of a data-parallel run (its loaders yield its slices)."""

    def __init__(self, config, device="cuda", dist: Optional[DistInfo] = None):
        self.dist = dist or SINGLE
        check_world(config, self.dist)
        self.config = config
        self.device = torch.device(device)
        # training.ema_decay > 0: the steps keep an average of the
        # generator's weights; validation, panels and exports run on it.
        self._ema = float(config.training.get("ema_decay", 0) or 0) > 0
        self.bundle = build_bundle(config, self.device, dist=self.dist)
        self._put = PinnedFeed(self.device)
        main = self.dist.is_main
        self.writer = (
            MetricsWriter(os.path.join("runs", config.experiment.name)) if main
            else _NullWriter()
        )
        ckpt_dir = config.training.checkpoint_dir or os.path.join(
            "runs", config.experiment.name, "ckpt"
        )
        # Separate managers: GAN-phase retention must never delete the
        # end-of-pretrain snapshot, so it lives in its own directory. Only
        # rank 0 creates the directories and writes; every rank reads.
        self.ckpt = CheckpointIO(
            ckpt_dir, max_to_keep=config.training.get("keep_checkpoints", 5) or 5,
            create=main,
        )
        self.pretrain_ckpt = CheckpointIO(ckpt_dir + "_pretrain", max_to_keep=1, create=main)
        # Mid-pretrain snapshots (interrupt recovery in phase 1); apart from
        # pretrain_ckpt, whose single reserved key marks phase COMPLETION.
        self.pretrain_progress = CheckpointIO(
            ckpt_dir + "_pretrain_steps", max_to_keep=2, create=main
        )
        init_pt = config.training.get("init_generator_pt")
        if init_pt:
            self._warm_start(init_pt, config.training.get("init_generator_optim_pt"))
        self.fixed_lr01: Optional[torch.Tensor] = None
        self.fixed_hr01: Optional[torch.Tensor] = None
        self._panel_phases: set = set()
        self.gan_step = 0  # GAN loop step (checkpoint/metric key)
        self._pretrain_step = 0
        # Steps saved BY THIS PROCESS (per phase): the interrupt handlers
        # key their skip-redundant-save guard on these, not on has_step(),
        # so a stale prior-run checkpoint at the interrupt step is
        # overwritten rather than trusted.
        self._last_gan_saved: Optional[int] = None
        self._last_pretrain_saved: Optional[int] = None
        #: host seconds of each validation pass (its sums read back at the end)
        self.validate_seconds: list = []

    # -- helpers --------------------------------------------------------------

    def _say(self, message: str) -> None:
        if self.dist.is_main:
            print(message)

    def _warm_start(self, init_pt: str, init_opt: Optional[str]) -> None:
        """Weights (and optionally AdamW state) from reference-format .pt
        files: the port's modules carry the reference's names, so the file
        loads as it is once torch.compile's ``_orig_mod.`` prefix is
        stripped. The EMA restarts at the warm-start point."""
        sd = torch.load(init_pt, map_location="cpu", weights_only=True)
        sd = {k.removeprefix("_orig_mod."): v for k, v in sd.items()}
        self.bundle.generator.load_state_dict(sd)
        self.bundle.reset_ema()
        if init_opt:
            self.bundle.g_opt.load_state_dict(
                torch.load(init_opt, map_location="cpu", weights_only=True)
            )
        self._say(f"Initialized generator from {init_pt}")

    def _state_tree(self) -> Dict[str, Any]:
        b = self.bundle
        tree = {
            "g_params": b.generator.state_dict(),
            "g_opt": b.g_opt.state_dict(),
            "d_params": b.discriminator.state_dict(),
            "d_opt": b.d_opt.state_dict(),
        }
        if self._ema:
            # present only when EMA is on: a checkpoint resumes under the
            # ema_decay setting it was written with
            tree["g_ema"] = b.g_ema.state_dict()
        return tree

    def _resume(self, io: CheckpointIO, step: int) -> None:
        """Load the state tree saved at ``step``, diagnosing a checkpoint
        written under other settings first.

        Top-level key sets that differ (EMA on in one run, off in the
        other) raise before any tensor is read: they can only come from
        other training settings. Nested drift (an optimizer that has not
        stepped yet, another torch's param-group keys) is tried, and raises
        the same diagnosis only if the load fails."""
        like = tree_skeleton(self._state_tree())
        saved = io.saved_skeleton(step)
        if saved is None or saved == like:
            self._load_state_tree(io.restore(step))
            return
        if isinstance(saved, dict):
            differing = sorted(
                set(saved) ^ set(like)
                | {k for k in set(saved) & set(like) if saved[k] != like[k]}
            )
            detail = f"differing subtrees: {differing}"
            top_level = set(saved) != set(like)
        else:
            detail, top_level = "saved item is not a state-tree dict", True
        error = ValueError(
            "checkpoint structure mismatch on resume: the run that wrote "
            "this checkpoint used other training settings (training.ema_decay "
            f"or the model widths shape the checkpointed state tree; {detail})."
            " Resume with the original settings, or start a fresh run dir "
            f"(checkpoint step {step})."
        )
        if top_level:
            raise error
        try:
            self._load_state_tree(io.restore(step))
        except (RuntimeError, ValueError, KeyError) as e:
            raise error from e

    def _load_state_tree(self, tree: Dict[str, Any]) -> None:
        if self._ema and "g_ema" not in tree:
            raise ValueError(
                "training.ema_decay > 0 but the checkpoint being resumed "
                "has no EMA tree (it was written with ema_decay=0). Resume "
                "with the original setting, or start a fresh run dir to "
                "train with EMA."
            )
        b = self.bundle
        b.generator.load_state_dict(tree["g_params"])
        b.g_opt.load_state_dict(tree["g_opt"])
        b.discriminator.load_state_dict(tree["d_params"])
        b.d_opt.load_state_dict(tree["d_opt"])
        if self._ema:
            b.g_ema.load_state_dict(tree["g_ema"])

    def validate(self, val_sampler: CropSampler, phase: str, step: int) -> Dict[str, float]:
        """:func:`evaluate_pass` over the global batch size, logged under
        ``{phase}/PSNR`` and ``{phase}/SSIM``."""
        t0 = time.perf_counter()
        result = evaluate_pass(
            self.bundle, val_sampler, self.config.training.batch_size,
            self.config.experiment.seed, self._put,
        )
        self.writer.scalar(f"{phase}/PSNR", result["psnr"], step)
        self.writer.scalar(f"{phase}/SSIM", result["ssim"], step)
        self.writer.flush()
        self.validate_seconds.append(time.perf_counter() - t0)
        return result

    def _setup_fixed_images(self, val_sampler: CropSampler, phase: str) -> None:
        """Grab the first val batch for the panels (cached) and log the
        HighRes + antialiased Bicubic references once *per phase* (the
        reference logs them only for whichever phase ran first). Rank 0
        only."""
        if not self.dist.is_main:
            return
        if self.fixed_lr01 is None:
            batch = next(
                val_sampler.sequential_batches(
                    self.config.training.batch_size,
                    seed=self.config.experiment.seed,
                    drop_last=False,
                )
            )
            lr_img, hr_img = prepare_batch(self._put(batch), self.config.data.lr_image_size)
            self.fixed_lr01 = (lr_img + 1.0) / 2.0
            self.fixed_hr01 = (hr_img + 1.0) / 2.0
        if phase not in self._panel_phases:
            self._panel_phases.add(phase)
            scale = self.config.data.scale_factor
            h, w = self.fixed_lr01.shape[2:]
            bicubic = resize_bicubic(self.fixed_lr01, h * scale, w * scale, antialias=True)
            self.writer.images(f"{phase}/HighRes", _nhwc(self.fixed_hr01), 0)
            self.writer.images(f"{phase}/Bicubic", _nhwc(bicubic), 0)

    def _log_generated(self, tag: str, step: int) -> None:
        if self.dist.is_main:
            self.writer.images(tag, _nhwc(self.bundle.render_step(self.fixed_lr01)), step)

    # -- phase 1 ---------------------------------------------------------------

    def pretrain(self, loader: PrefetchLoader, val_sampler: CropSampler) -> None:
        resume = self.config.training.resume
        barrier(self.dist)  # every rank reads the same checkpoints
        if resume and self.pretrain_ckpt.has_step(PRETRAIN_STEP):
            self._say("Pretrained checkpoint found, skipping pretraining")
            self._resume(self.pretrain_ckpt, PRETRAIN_STEP)
            return
        start_step = 0
        latest = self.pretrain_progress.latest_step()
        if resume and latest is not None:
            self._say(f"Resuming pretrain from step {latest}")
            self._resume(self.pretrain_progress, latest)
            start_step = latest
        self._pretrain_step = start_step
        self.validate(val_sampler, "Pretrain", step=start_step)
        self._setup_fixed_images(val_sampler, "Pretrain")
        log_iter = self.config.training.log_iter
        ckpt_iter = self.config.training.checkpoint_iter
        batches = tqdm(
            loader.iter_from(start_step), desc="Pretraining Generator",
            total=len(loader) - start_step, disable=not self.dist.is_main,
        )
        try:
            for step, batch in enumerate(batches, start=start_step + 1):
                loss = self.bundle.pretrain_step(self._put(batch))
                self._pretrain_step = step
                if step % log_iter == 0:
                    (loss,) = self.bundle.mean_over_ranks([loss])
                    self.writer.scalar("Pretrain/Generator/Loss", float(loss), step)
                    if self.config.training.get("lr_schedule"):
                        self.writer.scalar("Pretrain/LR", self._current_lrs()[0], step)
                if step % ckpt_iter == 0:
                    self._log_generated("Pretrain/Generated", step)
                    self.validate(val_sampler, "Pretrain", step)
                    # the bookkeeping rides inside the SIGINT-deferral
                    # window: an interrupt never separates a save from it
                    with defer_sigint():
                        if self.dist.is_main:
                            self.pretrain_progress.save(step, self._state_tree())
                        self._last_pretrain_saved = step
        except KeyboardInterrupt:
            step = self._pretrain_step
            if not self.dist.is_main:
                raise
            try:
                self.pretrain_progress.wait()
                if step == self._last_pretrain_saved:
                    print(f"\nInterrupted at pretrain step {step}; already checkpointed")
                else:
                    print(f"\nInterrupted at pretrain step {step}; checkpointing")
                    self.pretrain_progress.save(step, self._state_tree())
                    self._last_pretrain_saved = step
                    self.pretrain_progress.wait()
            except (RuntimeError, ValueError) as e:
                print(
                    f"Could not snapshot pretrain step {step} ({e}); latest "
                    f"saved step is {self.pretrain_progress.latest_step()}"
                )
            raise
        # the phase's last progress snapshot is written before the GAN phase
        # starts: a write in flight would hold the interpreter against its
        # first steps
        if self.dist.is_main:
            self.pretrain_progress.wait()
            self.pretrain_ckpt.save(PRETRAIN_STEP, self._state_tree())
            self.pretrain_ckpt.wait()
        # no rank starts the GAN phase before the checkpoint is on disk
        barrier(self.dist)

    # -- phase 2 ---------------------------------------------------------------

    def train(self, loader: PrefetchLoader, val_sampler: CropSampler) -> None:
        """GAN phase. `training.iterations` is the phase's TOTAL step budget:
        a restart resumes from the latest checkpoint and runs only the
        remaining steps (not another full `iterations`)."""
        start_step = 0
        barrier(self.dist)  # every rank reads the same checkpoints
        latest = self.ckpt.latest_step()
        if self.config.training.resume and latest is not None:
            self._say(f"Resuming GAN phase from step {latest}")
            self._resume(self.ckpt, latest)
            start_step = latest
        self.gan_step = start_step
        remaining = len(loader) - start_step
        if remaining <= 0:
            self._say(
                f"GAN phase already complete at step {start_step} "
                f"(training.iterations={len(loader)})"
            )
            return
        self.validate(val_sampler, "GAN", step=start_step)
        self._setup_fixed_images(val_sampler, "GAN")
        try:
            self._gan_loop(loader, val_sampler, start_step, remaining)
        except KeyboardInterrupt:
            # Snapshot the live state so the run resumes where it stopped;
            # gan_step advances only after a step's updates were issued.
            step = self.gan_step
            if not self.dist.is_main:
                raise
            try:
                self.ckpt.wait()
                if step == self._last_gan_saved:
                    print(f"\nInterrupted at step {step}; already checkpointed")
                else:
                    print(f"\nInterrupted at step {step}; checkpointing before exit")
                    self.save_checkpoints(step)
                    self.ckpt.wait()
            except (RuntimeError, ValueError) as e:
                print(
                    f"Could not snapshot step {step} ({e}); the latest "
                    f"periodic checkpoint is step {self.ckpt.latest_step()}"
                )
            raise

    def _gan_loop(self, loader, val_sampler, start_step: int, remaining: int) -> None:
        log_iter = self.config.training.log_iter
        ckpt_iter = self.config.training.checkpoint_iter
        batches = tqdm(
            loader.iter_from(start_step), desc="GAN Training", total=remaining,
            disable=not self.dist.is_main,
        )
        logged = (
            ("Loss/Discriminator/Real", "loss_real"),
            ("Loss/Discriminator/Fake", "loss_fake"),
            ("Loss/Generator/Adversarial", "adv_loss"),
            ("Loss/Generator/Content", "content_loss"),
        )
        for step, batch in enumerate(batches, start=start_step + 1):
            metrics = self.bundle.gan_step(self._put(batch), step=step)
            self.gan_step = step
            if step % log_iter == 0:
                values = self.bundle.mean_over_ranks([metrics[key] for _, key in logged])
                for (tag, _), value in zip(logged, values):
                    self.writer.scalar(tag, float(value), step)
                if self.config.training.get("lr_schedule"):
                    g_lr, d_lr = self._current_lrs()
                    self.writer.scalar("LR/Generator", g_lr, step)
                    self.writer.scalar("LR/Discriminator", d_lr, step)
            if step % ckpt_iter == 0:
                self._log_generated("GAN/Generated", step)
                self.validate(val_sampler, "GAN", step=step)
                self.save_checkpoints(step)
        # End-of-phase snapshot: without it every step after the last
        # checkpoint_iter multiple would be lost (the reference's flaw).
        if self.gan_step > 0 and self.gan_step % ckpt_iter != 0:
            self.save_checkpoints(self.gan_step)
        self.ckpt.wait()
        barrier(self.dist)

    # -- checkpointing -----------------------------------------------------------

    def save_checkpoints(self, step: int) -> None:
        """A checkpoint, and with ``training.export_pt`` the reference's four
        ``.pt`` files (plus the EMA generator's), with SIGINT deferred
        across the whole unit. Rank 0 only."""
        with defer_sigint():
            if self.dist.is_main:
                self.ckpt.save(step, self._state_tree())
                if self.config.training.get("export_pt", False):
                    self._export_pt(step)
            self._last_gan_saved = step

    def _export_pt(self, step: int) -> None:
        """The reference's files (trainer.py:143-156): both networks'
        state_dicts and both torch-AdamW state_dicts, at the LR the next
        update would use (``parallel.scale_lr``'s scaling included), so the
        upstream trainer can resume from them."""
        b = self.bundle
        save_dir = os.path.join("runs", self.config.experiment.name)
        os.makedirs(save_dir, exist_ok=True)

        def dump(tree, name):
            torch.save(to_host(tree), os.path.join(save_dir, name))

        g_lr, d_lr = self._current_lrs()
        dump(b.generator.state_dict(), f"generator_epoch_{step}.pt")
        if self._ema:
            # the averaged weights are the ones to deploy; the raw generator
            # keeps the reference's four-file set intact
            dump(b.g_ema.state_dict(), f"generator_ema_epoch_{step}.pt")
        dump(b.discriminator.state_dict(), f"discriminator_epoch_{step}.pt")
        for opt, lr, name in ((b.g_opt, g_lr, "generator"), (b.d_opt, d_lr, "discriminator")):
            sd = opt.state_dict()
            sd["param_groups"] = [{**g, "lr": lr} for g in sd["param_groups"]]
            dump(sd, f"{name}_optim_epoch_{step}.pt")

    def _current_lrs(self) -> tuple:
        """(generator_lr, discriminator_lr) for the NEXT optimizer update,
        logged under LR/* when training.lr_schedule is set (absent
        otherwise, keeping the reference's tag schema)."""
        b = self.bundle
        return b.g_lr(update_count(b.g_opt)), b.d_lr(update_count(b.d_opt))

    def close(self) -> None:
        self.ckpt.close()
        self.pretrain_ckpt.close()
        self.pretrain_progress.close()
        self.writer.close()
