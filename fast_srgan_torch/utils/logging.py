"""TensorBoard logging with the reference's exact tag schema: a copy of
``fast_srgan_tpu/utils/logging.py``.

Tag schema parity (SURVEY.md §5; reference trainer.py):
  scalars: Pretrain/Generator/Loss, Loss/Discriminator/Real,
           Loss/Discriminator/Fake, Loss/Generator/Adversarial,
           Loss/Generator/Content, {phase}/SSIM, {phase}/PSNR
  images : {phase}/HighRes, {phase}/Bicubic (step 0),
           Pretrain/Generated, GAN/Generated

Backed by torch's SummaryWriter where the tensorboard package is installed;
every scalar also goes to a JSONL metric log (``metrics.jsonl``), and every
panel to a PNG grid, so training never depends on TensorBoard.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    """SummaryWriter facade taking NHWC float [0,1] images and scalars."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._log_dir = log_dir
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), global_step=step)
        self._jsonl.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}
            )
            + "\n"
        )

    def images(self, tag: str, images01: np.ndarray, step: int) -> None:
        """images01: [N, H, W, C] float in [0, 1]. Logged to TensorBoard and
        also written as a PNG grid under <log_dir>/panels/ (viewable without
        TensorBoard)."""
        arr = np.clip(np.asarray(images01, dtype=np.float32), 0.0, 1.0)
        if self._tb is not None:
            self._tb.add_images(tag, arr, global_step=step, dataformats="NHWC")
        try:
            from PIL import Image

            n, h, w, c = arr.shape
            cols = min(n, 8)
            rows = (n + cols - 1) // cols
            grid = np.zeros((rows * h, cols * w, c), np.uint8)
            for k in range(n):
                r, col = divmod(k, cols)
                grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = (
                    arr[k] * 255
                ).astype(np.uint8)
            panel_dir = os.path.join(self._log_dir, "panels")
            os.makedirs(panel_dir, exist_ok=True)
            safe_tag = tag.replace("/", "_")
            Image.fromarray(grid.squeeze()).save(
                os.path.join(panel_dir, f"{safe_tag}_{step:08d}.png")
            )
        except Exception:
            pass  # panels are best-effort

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
