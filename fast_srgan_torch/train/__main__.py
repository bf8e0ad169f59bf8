"""Training entry point: two-phase SRGAN training with dotted overrides.

    python -m fast_srgan_torch.train [--device cuda|cpu] [key.path=value ...]
    python -m fast_srgan_torch.train data.image_dir=/data/DIV2K \\
        training.batch_size=32 training.vgg_weights=/path/vgg19-dcbb9e9d.pth
    torchrun --standalone --nproc_per_node 8 -m fast_srgan_torch.train ...

The port of the repo's root ``train.py`` (the JAX package's CLI), with the
reference's override surface: ``configs/config.yaml`` (read by path from
the checkout) under ``key.path=value`` overrides. It builds the .npy cache
from ``data.image_dir`` when missing, seeds, builds the val/pretrain/train
loaders, and runs ``Trainer.pretrain`` then ``Trainer.train``.

Hydra-1.1 run-dir semantics: the run chdirs into ``outputs/<date>/<time>/``
(``hydra.run.dir=DIR`` picks the directory, ``hydra.run.dir=.`` stays in
the launch directory); input paths are anchored to the launch directory
first. ``--device`` defaults to ``cuda`` and raises without a card.

Data parallel: under ``torchrun`` (``python -m torch.distributed.run``) each
process is a rank on ``cuda:LOCAL_RANK`` (NCCL; ``--device cpu``: gloo),
``training.batch_size`` is the global batch, each rank's loaders draw its
slice from its share of the files, and rank 0 alone writes. Rank 0 picks
the dated run directory and sends it to the others;
``parallel.multihost=true`` (ranks on several hosts) needs an explicit,
shared ``hydra.run.dir``. ``parallel.num_devices``, when set, must equal
the number of processes.
"""

from __future__ import annotations

import glob
import os
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from fast_srgan_torch.config import load_config
from fast_srgan_torch.data.pipeline import make_loaders, resolve_val_numpy_dir
from fast_srgan_torch.data.preprocess import ensure_numpy_cache
from fast_srgan_torch.parallel import dist as pdist
from fast_srgan_torch.train.trainer import Trainer, check_world

#: the checkout's config file, read by path (the launch directory may differ)
BUNDLED_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "config.yaml"

# Config keys naming *inputs* the user supplies (data, weights, an explicit
# checkpoint dir to resume from). These are anchored to the launch cwd
# before the Hydra-style chdir, so relative data paths (and a stable
# relative training.checkpoint_dir, which makes auto-resume work across
# per-run dirs) keep working. Output paths (runs/..., the defaulted
# checkpoint dir) stay relative: they belong inside the run dir.
_INPUT_PATH_KEYS = (
    ("data", "image_dir"),
    ("data", "numpy_dir"),
    ("data", "val_image_dir"),
    ("data", "val_numpy_dir"),
    ("training", "vgg_weights"),  # "pixel"/"init" sentinels excluded below
    ("training", "init_generator_pt"),
    ("training", "init_generator_optim_pt"),
    ("training", "checkpoint_dir"),
)
_VGG_SENTINELS = ("pixel", "init")


def explicit_run_dir(config):
    """The user-passed hydra.run.dir, or None when defaulted."""
    try:
        return config["hydra"]["run"]["dir"]
    except (KeyError, TypeError):
        return None


def resolve_run_dir(config) -> str:
    """``outputs/<date>/<time>/`` by default, else ``hydra.run.dir``
    (``.`` = stay in the launch directory)."""
    run_dir = explicit_run_dir(config)
    if run_dir is None:
        now = datetime.now()
        run_dir = f"outputs/{now:%Y-%m-%d}/{now:%H-%M-%S}"
    return str(run_dir)


def _absolutize_input_paths(config, base: str) -> None:
    for section, key in _INPUT_PATH_KEYS:
        value = config[section].get(key)
        if not value or not isinstance(value, str):
            continue
        if key == "vgg_weights" and value in _VGG_SENTINELS:
            continue
        if not os.path.isabs(value):
            config[section][key] = os.path.join(base, value)


def _warn_if_resume_has_prior_runs(config) -> None:
    """training.resume=true defaults on, but a fresh per-run dir has
    nothing to resume: if earlier runs of this experiment exist under
    outputs/, say so instead of silently restarting from step 0."""
    if not config.training.get("resume", False) or config.training.get("checkpoint_dir"):
        return
    prior = sorted(glob.glob(
        os.path.join("outputs", "*", "*", "runs", config.experiment.name, "ckpt")
    ))
    if prior:
        latest_run = os.sep.join(prior[-1].split(os.sep)[:3])
        print(
            f"NOTE: training.resume=true, but this launch created a fresh "
            f"run dir — it will NOT resume the {len(prior)} earlier "
            f"run(s) found under outputs/. To continue the latest, pass "
            f"hydra.run.dir={latest_run} (or use a stable "
            f"training.checkpoint_dir)."
        )


def enter_run_dir(config, dist: pdist.DistInfo = pdist.SINGLE) -> None:
    """chdir into the run directory, so runs/... and the checkpoints land
    inside it; input paths are re-anchored to the launch cwd first. Every
    rank enters rank 0's directory."""
    if config.parallel.get("multihost") and explicit_run_dir(config) is None:
        # each host would date its own default: the run would splinter
        raise SystemExit(
            "multihost runs need an explicit shared run directory: pass "
            "hydra.run.dir=<dir> (or hydra.run.dir=. to stay in the "
            "launch cwd)"
        )
    run_dir = pdist.broadcast_object(resolve_run_dir(config), dist)
    if run_dir != ".":
        if dist.is_main:
            _warn_if_resume_has_prior_runs(config)
        _absolutize_input_paths(config, os.getcwd())
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)
        if dist.is_main:
            print(f"Working directory: {os.getcwd()}")


def build_caches(config, dist: pdist.DistInfo = pdist.SINGLE) -> None:
    """The .npy caches of the training (and held-out) images, built once a
    host, by its local rank 0, as the JAX CLI builds them in each host's
    process; every rank waits until they are built."""
    if dist.local_rank == 0:
        workers = config.training.num_workers
        ensure_numpy_cache(config.data.image_dir, config.data.numpy_dir, workers=workers)
        val_numpy_dir = resolve_val_numpy_dir(config)
        if val_numpy_dir and config.data.get("val_image_dir"):
            # (val_numpy_dir alone means a prebuilt cache: nothing to build)
            ensure_numpy_cache(config.data.val_image_dir, val_numpy_dir, workers=workers)
    pdist.barrier(dist)


def _split_device(argv):
    """(device, overrides) from argv: ``--device X`` or ``--device=X``."""
    device, rest, it = "cuda", [], iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
        elif arg.startswith("--device="):
            device = arg.partition("=")[2]
        else:
            rest.append(arg)
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device takes cuda or cpu, got {device!r}")
    return device, rest


def main(argv=None):
    """Run both phases; returns the (closed) trainer and the training
    images' crop sampler (its ``backend`` says which loader ran). Under
    torchrun, joins the process group first and leaves it at the end."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a in ("-h", "--help") for a in argv):
        print(__doc__)
        return None
    device, overrides = _split_device(argv)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) but torch.cuda.is_available() is False;"
            " pass --device cpu to train on the CPU"
        )
    config = load_config(str(BUNDLED_CONFIG), overrides=overrides)
    dist = pdist.init_from_env(device)
    try:
        return _run(config, device, dist)
    finally:
        pdist.destroy(dist)


def _run(config, device: str, dist: pdist.DistInfo):
    check_world(config, dist)
    enter_run_dir(config, dist)
    if device == "cuda":
        device = f"cuda:{dist.local_rank}"

    np.random.seed(config.experiment.seed)
    torch.manual_seed(config.experiment.seed)
    build_caches(config, dist)
    if not any(f.endswith(".npy") for f in os.listdir(config.data.numpy_dir)):
        raise SystemExit(
            f"No training images: data.image_dir={config.data.image_dir!r} "
            f"produced an empty cache at {config.data.numpy_dir!r} "
            "(expected .png/.jpg images)"
        )
    # training.batch_size is the global batch: each rank's loaders draw its
    # slice from its own share of the files
    shard = (dist.rank, dist.world) if dist.world > 1 else None
    val_sampler, pretrain_loader, train_loader = make_loaders(config, shard=shard)
    if dist.is_main:
        print(
            f"Device: {device} x {dist.world} rank(s), global batch"
            f" {config.training.batch_size}, crop loader backend:"
            f" {pretrain_loader.sampler.backend}"
        )
    trainer = Trainer(config, device=device, dist=dist)
    try:
        trainer.pretrain(pretrain_loader, val_sampler)
        trainer.train(train_loader, val_sampler)
    finally:
        trainer.close()
    return trainer, pretrain_loader.sampler


if __name__ == "__main__":
    main()
