"""``python -m fast_srgan_torch.infer --config`` and the checkpoint search,
against the JAX package's ``infer.py``, on the CPU.

The config file given with ``--config`` must exist (the default path may
be absent); its ``inference:`` section sets the defaults of
``--batch_size``, ``--tile`` and ``--bucket`` (a flag given wins).
Without ``--checkpoint`` the CLI takes the first of ``DEFAULT_CHECKPOINTS``
that exists: JAX's paths inside the checkout, in JAX's order (JAX's list
ends with an absolute path outside it, which the port does not read), and
the same path as JAX's ``resolve_default_checkpoint`` in the same working
directory.
"""

import importlib
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from fast_srgan_torch import infer
from fast_srgan_torch.checkpoints.npz_io import save_npz_params
from fast_srgan_torch.inference import SRInferenceEngine
from test_torch_generator import random_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return random_params(8, 1, 4, seed=5)


@pytest.fixture
def run_dir(tmp_path, params):
    """A working directory with a checkpoint and two input images."""
    save_npz_params(str(tmp_path / "g.npz"), params)
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(6, 8), (5, 7)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "in" / f"im{i}.png")
    return tmp_path


def _config(path, **inference):
    with open(path, "w") as f:
        yaml.safe_dump({"inference": {"tile": 0, "batch_size": 8, "bucket": 0, **inference}}, f)
    return str(path)


class _Spy:
    """Records what the CLI hands the engine and the directory loops."""

    def __init__(self, monkeypatch):
        self.engine_kwargs, self.batch_sizes, self.tiled = [], [], 0
        real_engine, real_dir = infer.SRInferenceEngine, infer.upscale_directory

        def engine(params, **kw):
            self.engine_kwargs.append(kw)
            return real_engine(params, **kw)

        def directory(engine, image_dir, output_dir, batch_size):
            self.batch_sizes.append(batch_size)
            return real_dir(engine, image_dir, output_dir, batch_size)

        def tiled(*args, **kw):
            self.tiled += 1
            return 0

        monkeypatch.setattr(infer, "SRInferenceEngine", engine)
        monkeypatch.setattr(infer, "upscale_directory", directory)
        monkeypatch.setattr(infer, "upscale_directory_tiled", tiled)


def _main(run_dir, *extra):
    infer.main(["--image_dir", str(run_dir / "in"), "--output_dir", str(run_dir / "out"),
                "--checkpoint", str(run_dir / "g.npz"), "--fp32", "--device", "cpu", *extra])


def test_config_sets_bucket_and_batch_size(run_dir, params, monkeypatch):
    spy = _Spy(monkeypatch)
    _main(run_dir, "--config", _config(run_dir / "c.yaml", bucket=8, batch_size=3))
    assert spy.engine_kwargs[-1]["bucket"] == 8 and spy.batch_sizes == [3]
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32, bucket=8)
    for i in range(2):
        im = np.asarray(Image.open(run_dir / "in" / f"im{i}.png"))
        got = np.asarray(Image.open(run_dir / "out" / f"im{i}.png"))
        np.testing.assert_array_equal(got, engine.upscale_images([im])[0])


def test_flags_win_over_the_config(run_dir, monkeypatch):
    spy = _Spy(monkeypatch)
    _main(run_dir, "--config", _config(run_dir / "c.yaml", bucket=8, batch_size=3),
          "--bucket", "0", "--batch_size", "5")
    assert spy.engine_kwargs[-1]["bucket"] == 0 and spy.batch_sizes == [5]


def test_config_tile_runs_the_tiled_path(run_dir, monkeypatch):
    spy = _Spy(monkeypatch)
    _main(run_dir, "--config", _config(run_dir / "c.yaml", tile=1))
    assert spy.tiled == 1 and not spy.engine_kwargs
    spy = _Spy(monkeypatch)
    _main(run_dir, "--config", _config(run_dir / "c.yaml", tile=1), "--tile", "0")
    assert spy.tiled == 0 and spy.batch_sizes == [8]


def test_config_tile_and_bucket_exclude_each_other(run_dir, capsys):
    with pytest.raises(SystemExit):
        _main(run_dir, "--config", _config(run_dir / "c.yaml", tile=1, bucket=8))
    assert "exclude each other" in capsys.readouterr().err


def test_config_kernels_section_leaves_the_engine_as_it_is(run_dir, monkeypatch):
    """``kernels:`` holds training options only: the engine gets none."""
    spy = _Spy(monkeypatch)
    path = run_dir / "c.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({"kernels": {"fused_upsample": True, "use_pallas": True}}, f)
    _main(run_dir, "--config", str(path))
    assert set(spy.engine_kwargs[-1]) == {"dtype", "device", "bucket", "quantize",
                                          "calib_batches"}


def test_missing_config_given_explicitly_exits(run_dir, capsys):
    with pytest.raises(SystemExit):
        _main(run_dir, "--config", str(run_dir / "none.yaml"))
    assert "config file not found" in capsys.readouterr().err


def test_default_config_may_be_absent(run_dir, monkeypatch):
    monkeypatch.chdir(run_dir)  # no configs/config.yaml here
    spy = _Spy(monkeypatch)
    _main(run_dir)
    assert spy.batch_sizes == [8] and spy.engine_kwargs[-1]["bucket"] == 0


def test_architecture_override_is_printed(run_dir, capsys):
    _main(run_dir, "--config", os.path.join(REPO, "configs", "config.yaml"))
    out = capsys.readouterr().out
    assert "checkpoint architecture {'n_filters': 8, 'n_layers': 1, 'scale_factor': 4}" in out
    assert "(overrides config {'n_filters': 64, 'n_layers': 8, 'scale_factor': 4})" in out


def _jax_infer():
    return importlib.import_module("infer")  # the JAX package's CLI, at the repo root


def test_checkpoint_search_order_is_jax_order():
    jax_paths = _jax_infer().DEFAULT_CHECKPOINTS
    assert infer.DEFAULT_CHECKPOINTS == tuple(p for p in jax_paths if not os.path.isabs(p))
    assert infer.DEFAULT_CHECKPOINTS[0] == "models/generator_pretrained.npz"
    assert all(os.path.isabs(p) for p in jax_paths[len(infer.DEFAULT_CHECKPOINTS):])


@pytest.mark.parametrize("present", [(0, 1), (1,), (0,), ()])
def test_resolve_default_checkpoint_matches_jax(tmp_path, monkeypatch, present):
    """Each combination of the relative defaults in a working directory."""
    jax_infer = _jax_infer()
    monkeypatch.chdir(tmp_path)
    for i in present:
        path = infer.DEFAULT_CHECKPOINTS[i]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    if present:
        assert infer.resolve_default_checkpoint() == jax_infer.resolve_default_checkpoint()
        assert infer.resolve_default_checkpoint() == infer.DEFAULT_CHECKPOINTS[min(present)]
        return
    with pytest.raises(SystemExit, match="No checkpoint found"):
        infer.resolve_default_checkpoint()
    if not any(os.path.exists(p) for p in jax_infer.DEFAULT_CHECKPOINTS):
        with pytest.raises(SystemExit, match="No checkpoint found"):
            jax_infer.resolve_default_checkpoint()


def test_cli_without_checkpoint_takes_the_first_found(run_dir, monkeypatch, params):
    monkeypatch.chdir(run_dir)
    os.makedirs("models")
    save_npz_params("models/generator_pretrained.npz", params)
    spy = _Spy(monkeypatch)
    infer.main(["--image_dir", "in", "--output_dir", "out", "--fp32", "--device", "cpu"])
    assert spy.batch_sizes == [8] and len(os.listdir("out")) == 2


def test_missing_checkpoint_exits(run_dir):
    with pytest.raises(SystemExit, match="checkpoint not found"):
        infer.load_generator_params(str(run_dir / "none.npz"))
