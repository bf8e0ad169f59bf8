"""``python -m fast_srgan_torch.train`` (fast_srgan_torch/train/__main__.py)
on the CPU at a tiny size: both phases end to end in a subprocess with
``--device cpu``; the Hydra-1.1 run-dir semantics (``outputs/<date>/<time>``
by default, ``hydra.run.dir=DIR``, ``.`` stays, input paths anchored to the
launch directory); the empty-cache error; ``--device cuda`` without a card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch.train import __main__ as cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    "data.lr_image_size=8", "generator.n_filters=8", "generator.n_layers=1",
    "discriminator.n_filters=8", "training.bf16=false", "training.vgg_weights=pixel",
    "training.batch_size=2", "training.log_iter=1", "training.checkpoint_iter=2",
    "training.num_workers=2",
]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(0)
    (root / "imgs").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.png")
    return root


def test_module_runs_both_phases_on_the_cpu(images):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "fast_srgan_torch.train", "--device", "cpu",
           "hydra.run.dir=run", "data.image_dir=imgs", "data.numpy_dir=npy",
           "training.pretrain_iterations=2", "training.iterations=2",
           "training.export_pt=true", *TINY]
    proc = subprocess.run(cmd, cwd=images, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "crop loader backend" in proc.stdout
    run = images / "run" / "runs" / "SRGAN"
    tags = {json.loads(line)["tag"] for line in (run / "metrics.jsonl").read_text().splitlines()}
    assert {"Pretrain/Generator/Loss", "Pretrain/PSNR", "GAN/SSIM",
            "Loss/Generator/Content"} <= tags
    for name in ("generator_epoch_2.pt", "discriminator_optim_epoch_2.pt",
                 "ckpt/step_2.pt", "ckpt_pretrain/step_0.pt"):
        assert (run / name).exists(), name
    assert (images / "npy" / ".complete").exists()  # inputs anchored to the launch dir


def test_default_run_dir_is_dated_and_inputs_are_anchored(images, monkeypatch):
    monkeypatch.chdir(images)
    trainer, sampler = cli.main(["--device", "cpu", "data.image_dir=imgs",
                                 "data.numpy_dir=npy_default", "training.pretrain_iterations=1",
                                 "training.iterations=0", *TINY])
    cwd = os.getcwd()
    rel = os.path.relpath(cwd, images).split(os.sep)
    assert rel[0] == "outputs" and len(rel) == 3 and len(rel[1]) == 10  # outputs/<date>/<time>
    assert trainer.config.data.numpy_dir == str(images / "npy_default")
    assert os.path.exists(os.path.join(cwd, "runs", "SRGAN", "metrics.jsonl"))
    assert sampler.backend in ("native", "numpy")


def test_dot_run_dir_stays_in_the_launch_dir(images, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    cli.main(["--device=cpu", "hydra.run.dir=.", f"data.image_dir={images / 'imgs'}",
              f"data.numpy_dir={tmp_path / 'npy'}", "training.pretrain_iterations=1",
              "training.iterations=0", *TINY])
    assert os.getcwd() == str(tmp_path)
    assert (tmp_path / "runs" / "SRGAN" / "ckpt_pretrain" / "step_0.pt").exists()


def test_empty_cache_is_an_error(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="No training images"):
        cli.main(["--device", "cpu", "hydra.run.dir=.", "data.image_dir=empty",
                  "data.numpy_dir=npy", *TINY])


def test_arguments(monkeypatch):
    assert cli._split_device(["a=1", "--device", "cpu", "b=2"]) == ("cpu", ["a=1", "b=2"])
    assert cli._split_device(["--device=cuda"]) == ("cuda", [])
    with pytest.raises(SystemExit, match="cuda or cpu"):
        cli._split_device(["--device", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["hydra.run.dir=."])
    with pytest.raises(KeyError, match="Unknown config key"):
        cli.main(["--device", "cpu", "hydra.run.dir=.", "training.no_such_key=1"])
    with pytest.raises(SystemExit, match="num_devices=2 .*nproc_per_node 2"):
        cli.main(["--device", "cpu", "hydra.run.dir=.", "parallel.num_devices=2"])


def test_no_module_of_the_port_imports_jax():
    """Every module of fast_srgan_torch imports in a fresh interpreter
    without bringing in JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys, fast_srgan_torch\n"
        "for m in pkgutil.walk_packages(fast_srgan_torch.__path__, 'fast_srgan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'fast_srgan_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('fast_srgan_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) > 40
