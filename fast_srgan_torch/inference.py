"""Batched super-resolution inference engine on PyTorch (CUDA or CPU).

The port of ``fast_srgan_tpu/inference.py``: uint8 frames in, uint8 frames
out, with the reference normalization (in: x/127.5 - 1; out: (y+1)*127.5
clamped to [0, 255], truncated to uint8). Images are grouped by shape and
batched under a per-batch LR-pixel budget.

``quantize=`` selects the int8 PTQ tier (``quant.py``; True is the ``ups``
mode, the JAX package's production policy): the upsampling convs run int8
on the card's tensor cores (``kernels/int8_conv.py``) at activation scales
calibrated on sample inputs, the trunk and head stay float.

What the JAX engine does only for XLA's compiled shapes on the TPU is not
here: eager PyTorch compiles nothing per shape, so batches are never padded
to a compiled size and there is no "never batch 2..7" rule. Bucketing (and
so the masked int8 forward), multi-device and video streaming are not
ported yet.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, prepare_lr_tail
from fast_srgan_torch.ops.precision import cudnn_without_tf32


def sr_forward_u8(
    apply: Callable[[torch.Tensor], torch.Tensor], x_u8: torch.Tensor
) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8: THE serving normalization.

    ``apply`` maps a [B, 3, H, W] fp32 batch in [-1, 1] to the generator's
    [B, 3, sH, sW] output. The NHWC uint8 input viewed as NCHW is already
    channels_last memory, so no copy is made on the way in.
    """
    x = x_u8.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
    y = apply(x)
    out = ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1)


def arch_from_params(params: Dict[str, Any]) -> Dict[str, int]:
    """Read n_filters, n_layers and scale_factor off a generator param tree
    (the neck conv's output features, the ``stem_i`` count, and 2 to the
    number of ``upsampling_i`` stages)."""
    p = params["params"] if "params" in params else params
    if "neck_conv" not in p:
        raise ValueError(
            "not a generator param tree (no 'neck_conv'); got keys "
            f"{sorted(p)[:8]}"
        )
    return {
        "n_filters": int(np.shape(p["neck_conv"]["kernel"])[-1]),
        "n_layers": sum(1 for k in p if str(k).startswith("stem_")),
        "scale_factor": 2
        ** sum(1 for k in p if str(k).startswith("upsampling_")),
    }


def load_image(path: str) -> np.ndarray:
    """An image file decoded to uint8 RGB [H, W, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class SRInferenceEngine:
    """Eager SR engine (scale 2/4/8) over a fixed parameter set.

    Args:
      params: generator param tree with numpy leaves (``load_npz_params``).
      dtype: compute dtype, ``torch.bfloat16`` or ``torch.float32``.
      scale_factor: the expected upscale; None takes it from ``params``.
      device: where the model runs. ``"cuda"`` without CUDA raises: the
        engine never falls back to the CPU.
      pixel_budget: most LR pixels per batch (see :meth:`effective_batch_size`).
      lr_tail: run the upsampling tail at LR resolution (``ops/lr_tail.py``);
        False runs the canonical tail. The int8 tier always runs it.
      quantize: False, or the int8 mode: True (= ``"ups"``), ``"tail"``,
        ``"full"`` or ``"trunk"`` (``quant.MODES``). ``dtype`` is then the
        glue dtype between the int8 convs.
      act_scales: int8 activation scales (``quant.calibrate_scales``'s
        dict); None calibrates on ``calib_batches``, or else on
        ``quant.default_calibration_batch()``.
      calib_batches: sample batches ([-1, 1] float NHWC or uint8) to
        calibrate on.

    ``default_calibration`` is True when the scales came from the synthetic
    batch (neither ``act_scales`` nor ``calib_batches`` given): the signal
    for a caller to recalibrate on real inputs without overwriting scales
    that were chosen on purpose. :meth:`recalibrate` clears it.
    """

    #: Default LR-pixel budget per batch: 16 frames of 180x320. Not an H100
    #: measurement; a conservative bound (the widest bf16 intermediates are a
    #: few KiB per LR pixel) until a batch/memory sweep on the card sets it.
    PIXEL_BUDGET = 16 * 180 * 320

    def __init__(
        self,
        params: Dict[str, Any],
        *,
        dtype: torch.dtype = torch.bfloat16,
        scale_factor: Optional[int] = None,
        device: Any = "cuda",
        pixel_budget: Optional[int] = None,
        lr_tail: bool = True,
        quantize: bool | str = False,
        act_scales: Optional[Dict[str, Any]] = None,
        calib_batches: Optional[Iterable[Any]] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU"
            )
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
        arch = arch_from_params(params)
        if scale_factor is not None and scale_factor != arch["scale_factor"]:
            raise ValueError(
                f"scale_factor={scale_factor} but the params are a "
                f"{arch['scale_factor']}x generator"
            )
        self.SCALE = arch["scale_factor"]
        self.dtype = dtype
        self.pixel_budget = pixel_budget or self.PIXEL_BUDGET
        mode = "ups" if quantize is True else (quantize or None)
        if mode is not None and mode not in quant.MODES:
            raise ValueError(f"quantize must be True/'tail'/'ups'/'full'/'trunk': {mode!r}")
        self.quantize = mode is not None
        self.quantize_mode = mode
        model = Generator(**arch)
        model.load_state_dict(state_dict_from_jax_params(params))
        use_lr_tail = lr_tail and not self.quantize
        self._tail = prepare_lr_tail(model, dtype, self.device) if use_lr_tail else None
        self.model = model.to(
            device=self.device, dtype=dtype, memory_format=torch.channels_last
        ).eval()
        #: Generator forwards run so far (one per batch).
        self.forward_calls = 0
        if self.quantize:
            # the fp32 float form, kept for recalibrate()
            self._calib_plan = quant.prepare_generator(params, None, torch.float32, self.device)
            self.default_calibration = act_scales is None and calib_batches is None
            if act_scales is None:
                act_scales = quant.calibrate_scales(
                    self._calib_plan, calib_batches or [quant.default_calibration_batch()]
                )
            self.act_scales = {
                k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                for k, v in act_scales.items()
            }
            self._plan = quant.prepare_generator(
                params, mode, dtype, self.device, model=self.model
            )

    def recalibrate(self, batches: Iterable[Any]) -> None:
        """Recompute the int8 activation scales from sample inputs and swap
        them in on the device; nothing else is rebuilt. Clears
        ``default_calibration``: the scales are now the caller's choice."""
        if not self.quantize:
            raise ValueError("recalibrate() requires quantize=True")
        self.default_calibration = False
        self.act_scales = quant.calibrate_scales(self._calib_plan, batches)

    def _precision(self):
        if self.dtype == torch.float32 and self.device.type == "cuda":
            return cudnn_without_tf32()
        return contextlib.nullcontext()

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantize:
            return quant.sr_quant_forward(self._plan, self.act_scales, x)
        if self._tail is None:
            return self.model(x)
        return generator_apply_lr_tail(self.model, self._tail, x)

    def forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """Device-resident [B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8; one
        generator forward, enqueued on the current stream."""
        with torch.inference_mode(), self._precision():
            out = sr_forward_u8(self._apply, x_u8)
        self.forward_calls += 1
        return out

    def _to_device(self, batch_u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)

    # -- batch-size policy ----------------------------------------------------

    def effective_batch_size(self, h: int, w: int, requested: int = 8) -> int:
        """The batch the engine runs for HxW LR frames: ``requested``, capped
        so a batch holds at most ``pixel_budget`` LR pixels (at least 1)."""
        return max(1, min(requested, self.pixel_budget // max(1, h * w)))

    # -- core -------------------------------------------------------------------

    def upscale_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8 (s = SCALE), in chunks
        of :meth:`effective_batch_size`."""
        b, h, w, _ = batch_u8.shape
        if b == 0:
            return np.empty((0, h * self.SCALE, w * self.SCALE, 3), np.uint8)
        eff = self.effective_batch_size(h, w, b)
        return np.concatenate([
            self.forward_u8(self._to_device(batch_u8[i:i + eff])).cpu().numpy()
            for i in range(0, b, eff)
        ])

    def upscale_float(self, batch: Any) -> torch.Tensor:
        """[-1, 1] float NHWC in -> [-1, 1] fp32 NHWC out, on the device."""
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        with torch.inference_mode(), self._precision():
            y = self._apply(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)

    # -- directory / serving APIs ---------------------------------------------

    def upscale_images(
        self,
        images: Sequence[np.ndarray],
        batch_size: int = 8,
        pad_singletons: bool = False,
    ) -> List[np.ndarray]:
        """Upscale a list of uint8 HWC images, batching same-shape groups.

        ``pad_singletons`` is accepted so callers of the JAX engine's
        signature (its ``serving.MicroBatcher``) can drive this engine; it
        has no effect, because no batch size costs a compile here.
        """
        del pad_singletons
        images = list(images)
        outputs: List[np.ndarray] = [None] * len(images)  # type: ignore
        sizes = [im.shape[:2] for im in images]
        for i, out in self._grouped_upscale(sizes, lambda i: images[i], batch_size):
            outputs[i] = out
        return outputs

    def upscale_files(
        self, paths: Sequence[str], batch_size: int = 8
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Group files by header-declared size and decode at most one batch
        ahead. Yields (original_index, output)."""
        from PIL import Image

        sizes = []
        for path in paths:
            with Image.open(path) as im:  # header only, no decode
                w, h = im.size
            sizes.append((h, w))

        yield from self._grouped_upscale(sizes, lambda i: load_image(paths[i]), batch_size)

    def _grouped_upscale(
        self, sizes, take: Callable[[int], np.ndarray], batch_size: int
    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Group by exact shape, chunk by :meth:`effective_batch_size`, and
        yield (original_index, output) as each chunk completes.

        One chunk stays in flight: the host decodes and stacks chunk t+1
        while the device runs chunk t. If taking chunk t+1 fails, chunk t's
        outputs are yielded before the error propagates."""
        pending: Optional[Tuple[torch.Tensor, List[int]]] = None

        def fetch(entry):
            dev, chunk = entry
            host = dev.cpu().numpy()
            return [(i, host[j]) for j, i in enumerate(chunk)]

        order: Dict[Tuple[int, int], List[int]] = {}
        for i, hw in enumerate(sizes):
            order.setdefault(tuple(hw), []).append(i)
        for (h, w), idxs in order.items():
            eff = self.effective_batch_size(h, w, batch_size)
            for start in range(0, len(idxs), eff):
                chunk = idxs[start:start + eff]
                try:
                    batch = np.stack([take(i) for i in chunk])
                except Exception:
                    if pending is not None:
                        yield from fetch(pending)
                    raise
                if pending is not None:
                    yield from fetch(pending)
                pending = (self.forward_u8(self._to_device(batch)), chunk)
        if pending is not None:
            yield from fetch(pending)
