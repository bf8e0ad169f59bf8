"""PSNR / SSIM matching the reference's torchmetrics protocol: the port of
``fast_srgan_tpu/metrics/psnr_ssim.py`` on NCHW tensors.

The reference validates with torchmetrics
``PeakSignalNoiseRatio(data_range=1.0)`` and
``StructuralSimilarityIndexMeasure(data_range=1.0)`` over [0,1]-mapped images
(the reference's trainer.py:46-51,53-69). Semantics reproduced here:

  * PSNR, dim=None: torchmetrics accumulates sum-of-squared-error and element
    count across ``update`` calls and computes one aggregate
    ``10*log10(data_range^2 / (sse/n))`` over the whole dataset.
  * SSIM: per-image gaussian SSIM — 11x11 kernel, sigma 1.5, k1=0.01,
    k2=0.03, channel-averaged, mean over the *valid* (unpadded) response map
    — then the dataset mean of per-image values
    (reference: reduction="none" then ``.compute().mean()``).

Everything runs on the tensors' device; the host only accumulates scalars.
The separable gaussian filter is two depthwise ``F.conv2d`` (``groups=C``)
in fp32 with autocast and TF32 off whatever the global flags say: an fp32
cuDNN conv on an H100 runs in TF32 by default, and the E[x^2] - E[x]^2
variance terms would amplify its ~1e-3 errors in the means to the order of
c2 (the JAX package runs its filter at HIGHEST precision for the same
reason on the TPU).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _exact_fp32(device: torch.device):
    """No autocast, and no TF32 in cuDNN or matmuls, inside the block."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.autocast(device.type, enabled=False))
    if device.type == "cuda":
        cudnn = torch.backends.cudnn
        stack.enter_context(cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False,
        ))
        matmul = torch.backends.cuda.matmul
        saved = matmul.allow_tf32
        matmul.allow_tf32 = False
        stack.callback(setattr, matmul, "allow_tf32", saved)
    return stack


def _filter2d_valid(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' gaussian filter on fp32 [B, C, H, W]: depthwise
    along H, then along W."""
    c, n = x.shape[1], k1d.numel()
    x = F.conv2d(x, k1d.view(1, 1, n, 1).expand(c, 1, n, 1), groups=c)
    return F.conv2d(x, k1d.view(1, 1, 1, n).expand(c, 1, 1, n), groups=c)


def ssim_per_image(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-image SSIM of [B, C, H, W] pairs -> fp32 [B]."""
    if pred.shape[2] < 11 or pred.shape[3] < 11:
        raise ValueError(
            f"SSIM needs images >= 11x11 (gaussian kernel size); got "
            f"{pred.shape[2]}x{pred.shape[3]}"
        )
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    with _exact_fp32(pred.device):
        kernel = torch.from_numpy(_gaussian_kernel1d()).to(pred.device)
        x = pred.float()
        y = target.float()
        mu_x = _filter2d_valid(x, kernel)
        mu_y = _filter2d_valid(y, kernel)
        mu_xx = _filter2d_valid(x * x, kernel)
        mu_yy = _filter2d_valid(y * y, kernel)
        mu_xy = _filter2d_valid(x * y, kernel)

        # E[x^2] - E[x]^2 cancels catastrophically in fp32 once sr ~= hr (a
        # well-trained model!): variances go slightly negative and SSIM
        # leaves [-1, 1]. Clamp the variances at 0 and cap the covariance by
        # Cauchy-Schwarz, which restores the mathematical SSIM <= 1 bound.
        sigma_x = torch.clamp(mu_xx - mu_x * mu_x, min=0.0)
        sigma_y = torch.clamp(mu_yy - mu_y * mu_y, min=0.0)
        sigma_xy = mu_xy - mu_x * mu_y
        cs_bound = torch.sqrt(sigma_x * sigma_y)
        sigma_xy = torch.minimum(torch.maximum(sigma_xy, -cs_bound), cs_bound)

        num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
        den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
        return (num / den).mean(dim=(1, 2, 3))


def luma_bt601(x01: torch.Tensor) -> torch.Tensor:
    """Matlab-convention luma of [B, 3, H, W] RGB in [0, 1] -> [B, 1, H, W].

    The SR literature's benchmark protocol reports PSNR/SSIM on the Y
    channel of matlab ``rgb2ycbcr`` — ITU-R BT.601 studio swing:

        Y = (16 + 65.481 R + 128.553 G + 24.966 B) / 255,  RGB in [0, 1]
    """
    if x01.shape[1] != 3:
        raise ValueError(f"expected RGB channel dim 3, got {tuple(x01.shape)}")
    w = torch.tensor([65.481, 128.553, 24.966], dtype=x01.dtype, device=x01.device) / 255.0
    y = torch.tensordot(x01.movedim(1, -1), w, dims=([-1], [0])) + 16.0 / 255.0
    return y.unsqueeze(1)


def psnr_accumulate(pred: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch (sum_squared_error, element_count) for aggregate PSNR, fp32
    tensors on pred's device."""
    diff = pred.float() - target.float()
    return (diff * diff).sum(), torch.tensor(float(diff.numel()), device=diff.device)


def psnr_from_accumulator(sse: float, n: float, data_range: float = 1.0) -> float:
    """Aggregate PSNR (torchmetrics dim=None semantics)."""
    if n <= 0:
        # an empty pass must not report PSNR=inf as if it were a perfect
        # score (torchmetrics likewise errors on compute-without-update)
        raise ValueError("empty PSNR accumulator: no pixels were measured")
    mse = sse / n
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


class MetricAggregator:
    """Accumulates PSNR sse/count and per-image SSIM over a dataset pass
    (the reference's `_calculate_metrics_over_dataset`, trainer.py:53-69).
    The sums stay on the device until ``compute``."""

    def __init__(self, data_range: float = 1.0):
        self.data_range = data_range
        self.reset()

    def reset(self) -> None:
        self._sums = None  # fp64 [sse, n, ssim_sum, images]

    def update(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        sse, n = psnr_accumulate(pred, target)
        ssim = ssim_per_image(pred, target, data_range=self.data_range)
        batch = torch.stack([sse, n, ssim.sum(), torch.tensor(
            float(ssim.shape[0]), device=ssim.device)]).double()
        self._sums = batch if self._sums is None else self._sums + batch

    def compute(self) -> Tuple[float, float]:
        sse, n, ssim_sum, images = (
            self._sums.tolist() if self._sums is not None else (0.0, 0.0, 0.0, 0.0)
        )
        psnr = psnr_from_accumulator(sse, n, self.data_range)
        return psnr, ssim_sum / max(images, 1)
