"""Data-parallel training through the trainer and its entry points, on the
CPU with gloo ranks: ``torchrun --nproc_per_node 2 -m fast_srgan_torch.train
--device cpu`` (both phases, then a resumed launch), the rank-0-only writes
of a Trainer that is not rank 0, the run-directory rules (rank 0's dated
directory sent to the others; ``parallel.multihost`` needs an explicit one),
``check_world``'s refusals, the loaders' file shards, and ``python -m
fast_srgan_torch.scripts.multihost_smoke``.

Every subprocess is limited to 60 s and every process group to a 30-60 s
collective timeout, so a hang fails fast; rendezvous is ``file://`` or
torchrun's ``--standalone`` (a free port), never a fixed port.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch.config import default_config
from fast_srgan_torch.data.pipeline import make_loaders
from fast_srgan_torch.models.discriminator import Discriminator
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.parallel.dist import DistInfo
from fast_srgan_torch.train import __main__ as cli
from fast_srgan_torch.train.trainer import Trainer, check_world

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
LR = 1e-4  # configs/config.yaml's generator_lr and discriminator_lr

TINY = [
    "data.lr_image_size=8", "generator.n_filters=8", "generator.n_layers=1",
    "discriminator.n_filters=8", "training.bf16=false", "training.vgg_weights=pixel",
    "training.batch_size=4", "training.log_iter=1", "training.checkpoint_iter=2",
    "training.num_workers=1", "training.pretrain_iterations=2",
]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(0)
    (root / "imgs").mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.png")
    return root


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def no_tensorflow(tmp_path_factory):
    """A path entry whose ``tensorflow`` fails to import: rank 0's
    SummaryWriter then takes tensorboard's own stub, as on a machine
    without TensorFlow, instead of importing TensorFlow for ~16 s."""
    root = tmp_path_factory.mktemp("no_tensorflow")
    (root / "tensorflow").mkdir()
    (root / "tensorflow" / "__init__.py").write_text("raise ImportError('hidden in this test')\n")
    return {**ENV, "PYTHONPATH": os.pathsep.join([str(root), REPO])}


def _torchrun(cwd, env, *overrides):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "fast_srgan_torch.train", "--device", "cpu",
           "data.image_dir=imgs", "data.numpy_dir=npy", "parallel.num_devices=2",
           "parallel.scale_lr=true", "training.export_pt=true",
           "training.lr_schedule=cosine", "training.lr_min_ratio=1.0", *TINY, *overrides]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_torchrun_trains_both_phases_and_resumes(images, no_tensorflow):
    """Two gloo ranks: rank 0's dated run directory is the run's, rank 0
    writes every row once, parallel.scale_lr doubles both logged and
    exported learning rates, and a second launch resumes at GAN step 2."""
    first = _torchrun(images, no_tensorflow, "training.iterations=2")
    assert first.stdout.count("Device: cpu x 2 rank(s), global batch 4") == 1
    (run_dir,) = glob.glob(str(images / "outputs" / "*" / "*"))
    run = os.path.join(run_dir, "runs", "SRGAN")
    rows = _rows(os.path.join(run, "metrics.jsonl"))
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys)), "a (tag, step) logged twice"
    assert {"Pretrain/Generator/Loss", "Pretrain/PSNR", "GAN/SSIM", "Loss/Generator/Content",
            "LR/Generator", "LR/Discriminator"} <= {t for t, _ in keys}
    lrs = {r["value"] for r in rows if r["tag"].startswith(("LR/", "Pretrain/LR"))}
    assert lrs and all(v == pytest.approx(2 * LR) for v in lrs)
    for name in ("generator", "discriminator"):
        sd = torch.load(os.path.join(run, f"{name}_optim_epoch_2.pt"), weights_only=True)
        assert sd["param_groups"][0]["lr"] == pytest.approx(2 * LR)
    assert os.path.exists(os.path.join(run, "ckpt_pretrain", "step_0.pt"))

    second = _torchrun(images, no_tensorflow, "training.iterations=4", f"hydra.run.dir={run_dir}")
    assert second.stdout.count("Resuming GAN phase from step 2") == 1
    new = _rows(os.path.join(run, "metrics.jsonl"))[len(rows):]
    assert {(r["tag"], r["step"]) for r in new if r["tag"] == "Loss/Generator/Content"} == {
        ("Loss/Generator/Content", 3), ("Loss/Generator/Content", 4)}
    assert not any(r["tag"].startswith("Pretrain/") for r in new)
    tree = torch.load(os.path.join(run, "ckpt", "step_4.pt"), weights_only=True)
    Generator(n_filters=8, n_layers=1).load_state_dict(tree["g_params"])
    Discriminator(n_filters=8).load_state_dict(tree["d_params"])
    assert int(tree["g_opt"]["state"][0]["step"]) == 2 + 4


def test_a_rank_other_than_0_writes_nothing(images, tmp_path, monkeypatch):
    """A Trainer of rank 1 (no group: its rows and duties, no collective)
    trains both phases with checkpoints and exports on, and leaves its
    working directory empty."""
    npy = images / "npy_rank1"
    rng = np.random.default_rng(1)
    npy.mkdir()
    for i in range(4):
        np.save(npy / f"im{i}.npy", rng.integers(0, 256, (48, 48, 3), dtype=np.uint8))
    config = default_config(
        data={"numpy_dir": str(npy), "lr_image_size": 8},
        generator={"n_filters": 8, "n_layers": 1}, discriminator={"n_filters": 8},
        training={"bf16": False, "vgg_weights": "pixel", "pretrain_iterations": 2,
                  "iterations": 2, "batch_size": 4, "log_iter": 1, "checkpoint_iter": 1,
                  "export_pt": True, "num_workers": 1},
    )
    monkeypatch.chdir(tmp_path)
    info = DistInfo(rank=1, world=2)
    val, pretrain, train = make_loaders(config, shard=(1, 2))
    trainer = Trainer(config, "cpu", info)
    try:
        trainer.pretrain(pretrain, val)
        trainer.train(train, val)
    finally:
        trainer.close()
    assert trainer.gan_step == 2
    assert os.listdir(tmp_path) == []


RUN_DIR_RANK = r"""
import os, sys
from datetime import datetime
from fast_srgan_torch.parallel import dist as pdist
from fast_srgan_torch.train import __main__ as cli
rank = int(sys.argv[1])
info = pdist.init("gloo", rank, 2, "file://" + sys.argv[2], timeout_s=30)
if rank == 1:  # another clock: a rank that dated its own directory would differ
    class Clock(datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime(2001, 1, 1)
    cli.datetime = Clock
cli.enter_run_dir(cli.load_config(str(cli.BUNDLED_CONFIG)), info)
print("CWD", os.getcwd())
pdist.barrier(info)
pdist.destroy(info)
"""


def test_every_rank_enters_rank_0s_dated_directory(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", RUN_DIR_RANK, str(r),
                               str(tmp_path / "rendezvous")], cwd=tmp_path, env=ENV,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    cwds = [line.split(" ", 1)[1] for out in outs for line in out.splitlines()
            if line.startswith("CWD ")]
    assert len(cwds) == 2 and cwds[0] == cwds[1], cwds
    rel = os.path.relpath(cwds[0], tmp_path).split(os.sep)
    assert rel[0] == "outputs" and len(rel) == 3 and not rel[1].startswith("2001")
    assert os.listdir(tmp_path / "outputs") == [rel[1]]


def test_multihost_needs_an_explicit_run_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    config = default_config(parallel={"multihost": True})
    with pytest.raises(SystemExit, match="explicit shared run directory"):
        cli.enter_run_dir(config, DistInfo(rank=0, world=2))
    config["hydra"] = {"run": {"dir": "shared"}}
    cli.enter_run_dir(config, DistInfo(rank=0, world=2))
    assert os.getcwd() == str(tmp_path / "shared")


@pytest.mark.parametrize("overrides, world, match", [
    ({"training": {"batch_size": 5}}, 2, "must be divisible by the mesh size \\(2 devices\\)"),
    ({"parallel": {"num_devices": 4}}, 2, "num_devices=4 .* `torchrun --nproc_per_node 4"),
    ({"parallel": {"multihost": True}}, 1, "multihost needs torchrun's environment"),
])
def test_check_world_refuses(overrides, world, match):
    info = DistInfo(rank=0, world=world, group=object() if world > 1 else None)
    with pytest.raises(SystemExit, match=match):
        check_world(default_config(**overrides), info)


def test_multihost_without_torchrun_exits_from_the_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="multihost needs torchrun's environment"):
        cli.main(["--device", "cpu", "hydra.run.dir=.", "parallel.multihost=true"])


@pytest.mark.parametrize("rank, local_rank, builds", [(0, 0, True), (1, 0, True), (1, 1, False)])
def test_each_host_builds_its_own_cache(images, tmp_path, rank, local_rank, builds):
    """Each host's local rank 0 builds the .npy cache (the data directory
    need not be shared); the host's other ranks leave it to that one."""
    config = default_config(data={"image_dir": str(images / "imgs"),
                                  "numpy_dir": str(tmp_path / "npy")},
                            training={"num_workers": 1})
    cli.build_caches(config, DistInfo(rank=rank, world=4, local_rank=local_rank))
    npy = tmp_path / "npy"
    built = sorted(f for f in os.listdir(npy) if f.endswith(".npy")) if npy.is_dir() else []
    assert built == ([f"im{i}.npy" for i in range(5)] if builds else [])


def test_a_shard_with_no_files_names_its_rank(tmp_path):
    for i in range(4):
        np.save(tmp_path / f"im{i}.npy", np.zeros((40, 40, 3), np.uint8))
    config = default_config(data={"numpy_dir": str(tmp_path), "lr_image_size": 8},
                            training={"batch_size": 4})
    with pytest.raises(ValueError, match="shard 5 of 6 \\(rank 5\\) has none of the 4"):
        make_loaders(config, shard=(5, 6))
    val, pretrain, _ = make_loaders(config, shard=(1, 2))
    assert len(val) == 4 and len(pretrain.sampler) == 2  # the val sampler is never sharded
    assert pretrain.batch_size == 2  # the shard's slice of the global batch


def test_multihost_smoke_exits_0_with_its_json_line():
    proc = subprocess.run(
        [sys.executable, "-m", "fast_srgan_torch.scripts.multihost_smoke", "--device", "cpu",
         "--timeout", "45"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["world"] == 2 and result["device"] == "cpu"
    assert set(result["arms"]) == {"unfused", "fused"}
    for arm in result["arms"].values():
        assert arm["images"] == [5.0, 5.0] and arm["bitwise_across_ranks"]
        # the JAX package's bars hold here at every step and on every weight
        assert max(arm["loss_rel_by_step"]) <= 2e-5 and arm["max_param_abs"] <= 1e-5
        # and, on the same weights, every update's gradient of G and D
        assert arm["updates"] == ["g", "d", "g", "d", "g", "d", "g"]
        assert max(arm["forced_loss_rel_by_step"]) <= 2e-5
        assert max(arm["grad_rel_by_update"]) <= 1e-5
        # the same slices in one process sum the same terms in the same order
        assert max(arm["split_loss_rel_by_step"] + arm["split_grad_rel_by_update"]) <= 1e-6
        assert min(arm["no_allreduce_rel_by_update"]) > 0.1
