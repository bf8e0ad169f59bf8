"""``python -m fast_srgan_torch.scripts.evaluate`` against ``scripts/evaluate.py``.

On the CPU, fp32, with a small generator (8 filters, 2 layers) saved as
.npz: the per-image PSNR and SSIM of the port's CLI match the JAX script's
printed values on 2 generated images within 0.01 dB and 1e-4, in RGB and
in the literature's protocol (``--y_channel --shave 4``), and with a
``--crop``. The JAX script runs in this process (``runpy``), its lines read
from stdout; it prints PSNR to 0.01 dB and SSIM to 1e-4, so the bars hold
the port's unrounded values to the JAX script's rounded ones.
"""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fast_srgan_torch.checkpoints.npz_io import save_npz_params
from fast_srgan_torch.scripts import evaluate
from test_torch_generator import random_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^(\S+)\s+PSNR\s+([-\d.]+|inf) dB\s+SSIM\s+([-\d.]+)")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    ckpt = str(root / "tiny.npz")
    save_npz_params(ckpt, random_params(8, 2, 4, seed=9))
    img_dir = root / "hr"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:80, 0:72]
    for name, (h, w) in (("a.png", (64, 72)), ("b.png", (80, 66))):
        # smooth content plus noise, so the metrics sit well inside their range
        base = 127 + 60 * np.sin(yy[:h, :w] / 9.0)[..., None] * np.cos(xx[:h, :w] / 7.0)[..., None]
        img = np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(img, "RGB").save(img_dir / name)
    return ckpt, str(img_dir)


def _jax_lines(ckpt, img_dir, extra, capsys):
    argv = sys.argv
    try:
        sys.argv = ["evaluate.py", "--image_dir", img_dir, "--checkpoint", ckpt, "--fp32", *extra]
        runpy.run_path(os.path.join(REPO, "scripts", "evaluate.py"), run_name="__main__")
    finally:
        sys.argv = argv
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        m = LINE.match(line)
        if m:
            rows[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return rows


@pytest.mark.parametrize("extra", [[], ["--y_channel", "--shave", "4"], ["--crop", "50"]],
                         ids=["rgb", "y_shave4", "crop50"])
def test_matches_the_jax_script(inputs, capsys, extra):
    ckpt, img_dir = inputs
    want = _jax_lines(ckpt, img_dir, extra, capsys)
    got = evaluate.main(["--image_dir", img_dir, "--checkpoint", ckpt, "--fp32",
                         "--device", "cpu", *extra])
    printed = capsys.readouterr().out
    assert "(2 images)" in printed
    assert len(got["images"]) == 2 and set(want) == {"a.png", "b.png", "aggregate"}
    for name, psnr, ssim in got["images"] + [("aggregate", got["psnr"], got["ssim"])]:
        assert np.isfinite(psnr) and 0 < psnr < 60, (name, psnr)
        assert abs(psnr - want[name][0]) <= 0.01, (name, psnr, want[name])
        assert abs(ssim - want[name][1]) <= 1e-4, (name, ssim, want[name])


def test_y_channel_shaves_the_scale_by_default(inputs, capsys):
    ckpt, img_dir = inputs
    base = ["--image_dir", img_dir, "--checkpoint", ckpt, "--fp32", "--device", "cpu",
            "--y_channel"]
    assert evaluate.main(base) == evaluate.main([*base, "--shave", "4"])


def test_bf16_runs_and_errors_exit(inputs, tmp_path, monkeypatch):
    ckpt, img_dir = inputs
    got = evaluate.main(["--image_dir", img_dir, "--checkpoint", ckpt, "--device", "cpu"])
    assert np.isfinite(got["psnr"])
    with pytest.raises(SystemExit, match="no images"):
        evaluate.main(["--image_dir", str(tmp_path), "--checkpoint", ckpt, "--device", "cpu"])
    with pytest.raises(SystemExit, match="not found"):
        evaluate.main(["--image_dir", img_dir, "--checkpoint", str(tmp_path / "x.npz"),
                       "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        evaluate.main(["--image_dir", img_dir, "--checkpoint", ckpt])
