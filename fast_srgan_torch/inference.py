"""Batched super-resolution inference engine on PyTorch (CUDA or CPU).

The port of ``fast_srgan_tpu/inference.py``: uint8 frames in, uint8 frames
out, with the reference normalization (in: x/127.5 - 1; out: (y+1)*127.5
clamped to [0, 255], truncated to uint8). Images are grouped by shape and
batched under a per-batch LR-pixel budget.

``quantize=`` selects the int8 PTQ tier (``quant.py``; True is the ``ups``
mode, the JAX package's production policy): the upsampling convs run int8
on the card's tensor cores (``kernels/int8_conv.py``) at activation scales
calibrated on sample inputs, the trunk and head stay float.

``bucket=`` zero-pads each image to a multiple of ``bucket`` LR pixels and
crops the output, so mixed sizes share one batch; it is exact: the masked
forward (``Generator(valid_hw=)``, ``quant.sr_quant_forward_masked``) takes
each sample's norm statistics over its valid region and re-zeroes the
padding after every bias. :meth:`SRInferenceEngine.stream` pipelines a
sequence of same-size frames (video) through pinned host buffers and copy
streams; on one card each full batch is a replay of a CUDA graph of the
whole forward, captured once per batch shape (``graphs_apply``).

``mesh=`` serves data-parallel across a 1-D mesh of devices
(``parallel/mesh.py``): one replica of the weights (LR-tail preparation,
int8 plan and scales) on each distinct device; each batch splits into
contiguous slices, one per mesh device, launched back to back so the
devices overlap, and the outputs are gathered in order on the first. One
frame too large for a card is ``parallel/spatial.py``'s (width tiling).

Each batch holds at most ``pixel_budget`` LR pixels, resolved per tier and
scale in the JAX engine's order (:meth:`SRInferenceEngine.
resolve_pixel_budget`), each value set by a sweep on the card. The JAX
engine's other batch rule is not here: it never runs a batch of 2..7 but
pads one up to 8, because its compiled programs of 2..7 cost 2-4x as much
an LR pixel. On the card a batch always takes longer than any smaller one,
so padding never pays: 180x320 at 4x, three processes (``eval_int8 --batch
1,2,3,4,5,6,7,8 --iters 20``; NVIDIA H100 80GB HBM3, 700 W; PERF.md section
6, the batch table), bf16 2.023-2.740 ms a batch of 1, 3.020-3.594 of 2,
10.491-10.575 of 8; int8 ``ups`` 2.072-2.833, 2.420-3.069 and 7.626-8.477.
The engine runs the batch it is given.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import (Any, Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, prepare_lr_tail
from fast_srgan_torch.ops.norm import valid_mask, zero_outside
from fast_srgan_torch.ops.precision import fp32_precision
from fast_srgan_torch.parallel.mesh import Mesh, gather_batch, split_batch
from fast_srgan_torch.utils.spans import span

#: Batches a stream keeps in flight on the card (the JAX engine's window).
STREAM_IN_FLIGHT = 2


def graphs_apply(device: torch.device, mesh: Optional[Mesh]) -> bool:
    """Whether :meth:`SRInferenceEngine.stream` replays captured forwards:
    on one card. A stream fixes one batch shape for thousands of batches,
    so its capture pays; the CPU and a mesh's slices run eagerly, as do the
    engine's other entry points, whose shapes change from call to call."""
    return device.type == "cuda" and mesh is None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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


@dataclasses.dataclass
class _Replica:
    """The engine's weights on one device."""

    device: torch.device
    model: Generator
    tail: Optional[Dict[str, Any]] = None
    plan: Optional[quant.PreparedGenerator] = None
    act_scales: Optional[Dict[str, torch.Tensor]] = None


class _Captured(NamedTuple):
    """One slot's captured forward: each replay of ``graph`` reads the
    slot's device input and writes ``out``, which belongs to the slot."""

    graph: Any
    out: torch.Tensor


@dataclasses.dataclass
class _Ring:
    """``stream``'s buffers on one card for one batch shape, one slot a
    batch in flight plus one: (pinned input, device input, pinned output),
    and each slot's captured forward of its whole device input. ``held``
    while a stream runs on it."""

    slots: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    graphs: List[_Captured]
    held: bool = False


def _slots(bs: int, shape: Tuple[int, ...], scale: int, device: torch.device
           ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``STREAM_IN_FLIGHT + 1`` slots of (pinned input, device input,
    pinned output) for batches of ``bs`` HWC frames of ``shape``."""
    h, w, c = shape
    return [
        (torch.empty((bs, h, w, c), dtype=torch.uint8, pin_memory=True),
         torch.empty((bs, h, w, c), dtype=torch.uint8, device=device),
         torch.empty((bs, scale * h, scale * w, c), dtype=torch.uint8, pin_memory=True))
        for _ in range(STREAM_IN_FLIGHT + 1)
    ]


def _capture(forward: Callable[[torch.Tensor], torch.Tensor],
             inputs: Sequence[torch.Tensor]) -> List[_Captured]:
    """A CUDA graph of ``forward`` of each input, each in a memory pool of
    its own. Graphs that shared one pool could not be kept apart: a later
    capture may place its output in memory an earlier graph's replay uses
    for its intermediates, which that replay then overwrites while the
    output's download still reads it. One eager forward on a side stream
    first makes what a first call chooses (cuDNN's algorithms, the IN
    kernels' plan); capturing synchronizes the card, so nothing is in
    flight."""
    device = inputs[0].device
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            forward(inputs[0])
        torch.cuda.current_stream(device).wait_stream(side)
        captured = []
        for x in inputs:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = forward(x)
            captured.append(_Captured(graph, out))
    return captured


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
      bucket: zero-pad inputs to multiples of ``bucket`` LR pixels and crop
        the output (the masked forward, exact); 0 runs each shape as it is.
      lr_tail: run the upsampling tail at LR resolution (``ops/lr_tail.py``);
        False runs the canonical tail. The int8 tier always runs it.
      quantize: False, or the int8 mode: True (= ``"ups"``), ``"tail"``,
        ``"full"`` or ``"trunk"`` (``quant.MODES``). ``dtype`` is then the
        glue dtype between the int8 convs. With ``bucket``, ``full`` and
        ``trunk`` raise: the masked norms run on the float trunk only.
      act_scales: int8 activation scales (``quant.calibrate_scales``'s
        dict); None calibrates on ``calib_batches``, or else on
        ``quant.default_calibration_batch()``.
      calib_batches: sample batches ([-1, 1] float NHWC or uint8) to
        calibrate on.
      mesh: None (one device, ``device``), or a 1-D :class:`Mesh` or a
        sequence of devices (a device may repeat) to serve data-parallel
        across; ``device`` is then the mesh's first device, where inputs
        arrive and outputs are gathered.

    ``default_calibration`` is True when the scales came from the synthetic
    batch (neither ``act_scales`` nor ``calib_batches`` given): the signal
    for a caller to recalibrate on real inputs without overwriting scales
    that were chosen on purpose. :meth:`recalibrate` clears it.
    """

    #: LR pixels a batch, per scale, of the float tiers, of every int8 mode
    #: but an unbucketed ``ups`` and of every bucketed engine. Each is the
    #: frames/s optimum of a sweep of 180x320 batches from 1 frame to out of
    #: memory, or the smallest batch whose best run is no slower a frame than
    #: the optimum's slowest run (``python -m fast_srgan_torch.scripts.
    #: eval_int8 --arms bf16,int8_ups_only --scale S --iters 5``; NVIDIA H100
    #: 80GB HBM3, 700 W; PERF.md section 6, the budget table): 2x 64 frames,
    #: 1963.2 frames/s (the optimum 96, 1964.5; 16 frames 1896.3); 4x 64,
    #: 786.5 (the optimum 96, 786.9; 16: 773.4); 8x 24, 230.4, the optimum
    #: (16: 229.6). bf16 runs out of memory at 384 frames at 4x, 96 at 8x.
    PIXEL_BUDGETS = {2: 64 * 180 * 320, 4: 64 * 180 * 320, 8: 24 * 180 * 320}
    #: LR pixels a batch, per scale, of the unbucketed int8 ``ups`` tier, by
    #: the same rule and sweep: 2x 64 frames, 2231.8 frames/s (the optimum
    #: 256, 2233.8; 16: 2148.9); 4x 64, 1107.7, the optimum (16: 1080.6); 8x
    #: 32, 360.9, the optimum (16: 357.8). It runs out of memory at 512
    #: frames at 4x, 128 at 8x.
    INT8_UPS_PIXEL_BUDGETS = {2: 64 * 180 * 320, 4: 64 * 180 * 320, 8: 32 * 180 * 320}

    def __init__(
        self,
        params: Dict[str, Any],
        *,
        dtype: torch.dtype = torch.bfloat16,
        scale_factor: Optional[int] = None,
        device: Any = "cuda",
        pixel_budget: Optional[int] = None,
        bucket: int = 0,
        lr_tail: bool = True,
        quantize: bool | str = False,
        act_scales: Optional[Dict[str, Any]] = None,
        calib_batches: Optional[Iterable[Any]] = None,
        mesh: Any = None,
    ):
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                mesh = Mesh(list(mesh), ("data",))
            if len(mesh.axis_names) != 1:
                raise ValueError(f"the engine's mesh is 1-D, got axes {mesh.axis_names}")
            device = mesh.devices[0]
        self.mesh = mesh
        #: the device of each batch slice, in order (one without a mesh)
        self.devices = [torch.device(device)] if mesh is None else list(mesh.devices)
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
        mode = "ups" if quantize is True else (quantize or None)
        if mode is not None and mode not in quant.MODES:
            raise ValueError(f"quantize must be True/'tail'/'ups'/'full'/'trunk': {mode!r}")
        self.pixel_budget = self.resolve_pixel_budget(self.SCALE, mode, bucket, pixel_budget)
        self.quantize = mode is not None
        self.quantize_mode = mode
        if bucket < 0:
            raise ValueError(f"bucket must be >= 0, got {bucket}")
        if bucket and mode in ("full", "trunk"):
            raise ValueError(
                "bucketed (masked) int8 requires a float trunk (the ups/tail modes):"
                " per-sample masked instance-norm statistics are float-path only."
                " Use quantize=True/'tail'/'ups', or bucket=0."
            )
        self.bucket = bucket
        use_lr_tail = lr_tail and not self.quantize
        self._replicas: Dict[torch.device, _Replica] = {}
        for dev in self.devices:
            if dev in self._replicas:
                continue
            model = Generator(**arch)
            model.load_state_dict(state_dict_from_jax_params(params))
            rep = _Replica(dev, model)
            rep.tail = prepare_lr_tail(model, dtype, dev) if use_lr_tail else None
            rep.model = model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()
            if self.quantize:
                rep.plan = quant.prepare_generator(params, mode, dtype, dev, model=rep.model)
            self._replicas[dev] = rep
        first = self._replicas[self.device]
        self.model, self._tail = first.model, first.tail
        #: Generator forwards run so far (one per batch, eager or replayed).
        self.forward_calls = 0
        #: (batch, height, width) of each input batch shape run so far (the
        #: padded shape when bucketed): the first use of one pays cuDNN's
        #: choice of algorithms and the IN kernels' plan.
        self.batch_shapes: set = set()
        #: CUDA graphs ``stream`` captured (one a ring slot, once per batch
        #: shape) and replayed (one a full batch). The kernels' own
        #: ``.launches`` counters count a capture once and no replay.
        self.graph_captures = 0
        self.graph_replays = 0
        #: ``stream``'s captured rings by (batch, height, width); the
        #: engine's tier is fixed
        self._rings: Dict[Tuple[int, int, int], _Ring] = {}
        if self.quantize:
            self._plan = first.plan
            # the fp32 float form, kept for recalibrate()
            self._calib_plan = quant.prepare_generator(params, None, torch.float32, self.device)
            self.default_calibration = act_scales is None and calib_batches is None
            if act_scales is None:
                act_scales = quant.calibrate_scales(
                    self._calib_plan, calib_batches or [quant.default_calibration_batch()]
                )
            self._set_scales(act_scales)

    @classmethod
    def resolve_pixel_budget(cls, scale: int, mode: Optional[str], bucket: int,
                             pixel_budget: Optional[int] = None) -> int:
        """LR pixels a batch, in the JAX engine's order: an explicit
        ``pixel_budget``; else the unbucketed int8 ``ups`` tier's own budget
        for ``scale`` (``mode`` is the int8 mode or None); else the float
        budget for ``scale``, which every other mode and every bucketed
        engine takes."""
        if pixel_budget is not None:
            return pixel_budget
        if mode == "ups" and not bucket and scale in cls.INT8_UPS_PIXEL_BUDGETS:
            return cls.INT8_UPS_PIXEL_BUDGETS[scale]
        return cls.PIXEL_BUDGETS[scale]

    def recalibrate(self, batches: Iterable[Any]) -> None:
        """Recompute the int8 activation scales from sample inputs and write
        them into the engine's scale tensors on the device, which the
        captured forwards read; nothing else is rebuilt. Clears
        ``default_calibration``: the scales are now the caller's choice."""
        if not self.quantize:
            raise ValueError("recalibrate() requires quantize=True")
        self.default_calibration = False
        self._set_scales(quant.calibrate_scales(self._calib_plan, batches))

    def _set_scales(self, act_scales: Dict[str, Any]) -> None:
        """The int8 activation scales on every replica's device, in tensors
        of the engine's own: copies made at the first call, written in
        place at every later one (in stream order), so that a forward
        ``stream`` captured reads the new values."""
        for rep in self._replicas.values():
            new = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in act_scales.items()}
            if rep.act_scales is None:
                rep.act_scales = {k: v.to(rep.device, copy=True) for k, v in new.items()}
            else:
                for k, v in new.items():
                    rep.act_scales[k].copy_(v)
        self.act_scales = self._replicas[self.device].act_scales

    def _precision(self):
        return fp32_precision(self.dtype == torch.float32, self.device)

    def _apply(self, x: torch.Tensor, valid_hw=None, rep: Optional[_Replica] = None
               ) -> torch.Tensor:
        """One replica's forward (default: the first device's) on its slice."""
        rep = rep or self._replicas[self.device]
        if self.quantize:
            if valid_hw is None:
                return quant.sr_quant_forward(rep.plan, rep.act_scales, x)
            return quant.sr_quant_forward_masked(rep.plan, rep.act_scales, x, valid_hw)
        if rep.tail is None:
            return rep.model(x, valid_hw=valid_hw)
        return generator_apply_lr_tail(rep.model, rep.tail, x, valid_hw)

    def _data_parallel(self, run: Callable, *batched: torch.Tensor) -> torch.Tensor:
        """``run(rep, *slices)`` of each mesh device's contiguous slice of the
        batched tensors, launched back to back, gathered in order on the
        engine's device; without a mesh, ``run`` of the whole batch."""
        if self.mesh is None:
            return run(self._replicas[self.device], *batched)
        slices = [split_batch(t, self.devices) for t in batched]
        outs = [run(self._replicas[dev], *parts)
                for dev, *parts in zip(self.devices, *slices) if parts[0].shape[0]]
        return gather_batch(outs, self.device)

    def forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """Device-resident [B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8; one
        generator forward (one a mesh device), enqueued on the current
        stream."""
        with span("engine.forward"):
            out = self._forward_u8(x_u8)
        self._counted(x_u8)
        return out

    def _forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """:meth:`forward_u8`'s work, uncounted: what ``stream`` captures."""
        with torch.inference_mode(), self._precision():
            return self._data_parallel(
                lambda rep, x: sr_forward_u8(lambda t: self._apply(t, rep=rep), x), x_u8)

    def _counted(self, x_u8: torch.Tensor) -> None:
        self.forward_calls += 1
        self.batch_shapes.add(tuple(x_u8.shape[:3]))

    def forward_u8_masked(
        self, x_u8: torch.Tensor, valid_h: torch.Tensor, valid_w: torch.Tensor
    ) -> torch.Tensor:
        """:meth:`forward_u8` of a zero-padded batch: sample b's image fills
        its top-left ``valid_h[b]`` x ``valid_w[b]`` (int32 [B] on the
        device). Normalizes, then re-zeroes the padding (uint8 zeros map to
        -1), then runs the masked forward. Only the valid region of each
        output, s * valid_h x s * valid_w, is the image's upscale."""

        def run(rep: _Replica, x_u8, vh, vw) -> torch.Tensor:
            def apply(x: torch.Tensor) -> torch.Tensor:
                mask = valid_mask(x.shape[2], x.shape[3], vh, vw)[0]
                return self._apply(zero_outside(x, mask), (vh, vw), rep)

            return sr_forward_u8(apply, x_u8)

        with span("engine.forward"), torch.inference_mode(), self._precision():
            out = self._data_parallel(run, x_u8, valid_h, valid_w)
        self._counted(x_u8)
        return out

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _bucket_shape(self, h: int, w: int) -> Tuple[int, int]:
        if not self.bucket:
            return h, w
        return _round_up(h, self.bucket), _round_up(w, self.bucket)

    def _forward_padded(self, images: Sequence[np.ndarray], ph: int, pw: int) -> torch.Tensor:
        """Zero-pad uint8 HWC images to ph x pw and run the masked forward;
        returns the device output [B, s * ph, s * pw, 3]."""
        batch = np.zeros((len(images), ph, pw, 3), np.uint8)
        for k, im in enumerate(images):
            batch[k, :im.shape[0], :im.shape[1]] = im
        vh = np.array([im.shape[0] for im in images], np.int32)
        vw = np.array([im.shape[1] for im in images], np.int32)
        return self.forward_u8_masked(
            self._to_device(batch), self._to_device(vh), self._to_device(vw)
        )

    def _forward_host(self, images: Sequence[np.ndarray], ph: int, pw: int) -> torch.Tensor:
        """One forward of same-bucket images (masked where bucketing)."""
        if self.bucket:
            return self._forward_padded(images, ph, pw)
        return self.forward_u8(self._to_device(np.stack(images)))

    # -- batch-size policy ----------------------------------------------------

    def effective_batch_size(self, h: int, w: int, requested: int = 8) -> int:
        """The batch the engine runs for HxW LR frames: ``requested``, capped
        so a batch holds at most ``pixel_budget`` LR pixels (at least 1).
        With a mesh the policy applies to each device's slice, and the
        result is the whole batch, a multiple of the mesh size."""
        n = len(self.devices)
        per = max(1, min(max(1, requested // n), self.pixel_budget // max(1, h * w)))
        return per * n

    # -- core -------------------------------------------------------------------

    def upscale_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] uint8 -> [B, sH, sW, 3] uint8 (s = SCALE), in chunks
        of :meth:`effective_batch_size` at the bucket-padded size (the size
        the forward runs at). With ``bucket``, always the masked forward,
        also for a shape already on the grid."""
        b, h, w, _ = batch_u8.shape
        s = self.SCALE
        if b == 0:
            return np.empty((0, h * s, w * s, 3), np.uint8)
        ph, pw = self._bucket_shape(h, w)
        eff = self.effective_batch_size(ph, pw, b)
        return np.concatenate([
            self._forward_host(batch_u8[i:i + eff], ph, pw).cpu().numpy()[:, :h * s, :w * s]
            for i in range(0, b, eff)
        ])

    def upscale_float(self, batch: Any) -> torch.Tensor:
        """[-1, 1] float NHWC in -> [-1, 1] fp32 NHWC out, on the device."""
        x = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        with torch.inference_mode(), self._precision():
            y = self._data_parallel(lambda rep, t: self._apply(t, rep=rep), x.permute(0, 3, 1, 2))
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
        """Group by shape (by bucket shape with ``bucket``: mixed sizes then
        share a batch, each image zero-padded and run through the masked
        forward), chunk by :meth:`effective_batch_size` at that shape, and
        yield (original_index, output) as each chunk completes.

        One chunk stays in flight: the host decodes and stacks chunk t+1
        while the device runs chunk t. If taking chunk t+1 fails, chunk t's
        outputs are yielded before the error propagates."""
        pending: Optional[Tuple[torch.Tensor, List[int]]] = None
        s = self.SCALE

        def fetch(entry):
            dev, chunk = entry
            host = dev.cpu().numpy()
            return [
                (i, host[j, :sizes[i][0] * s, :sizes[i][1] * s])
                for j, i in enumerate(chunk)
            ]

        order: Dict[Tuple[int, int], List[int]] = {}
        for i, (h, w) in enumerate(sizes):
            order.setdefault(self._bucket_shape(h, w), []).append(i)
        for (ph, pw), idxs in order.items():
            eff = self.effective_batch_size(ph, pw, batch_size)
            for start in range(0, len(idxs), eff):
                chunk = idxs[start:start + eff]
                try:
                    images = [take(i) for i in chunk]
                except Exception:
                    if pending is not None:
                        yield from fetch(pending)
                    raise
                if pending is not None:
                    yield from fetch(pending)
                pending = (self._forward_host(images, ph, pw), chunk)
        if pending is not None:
            yield from fetch(pending)

    def stream(
        self, frames: Iterable[np.ndarray], batch_size: int = 8
    ) -> Iterator[np.ndarray]:
        """Upscale a sequence of uint8 HWC frames of one shape (video),
        yielding outputs in input order.

        The first frame fixes the batch (:meth:`effective_batch_size`); a
        trailing partial batch runs at its own size. On the card, frames
        go up through pinned host buffers on an upload stream and come down
        on a download stream, ordered by events, with at most
        ``STREAM_IN_FLIGHT`` batches in flight; the host fills batch t+1
        while the card runs batch t. On one card (``graphs_apply``) each
        full batch is one replay of a CUDA graph of the whole forward: the
        engine captures one per ring slot at the first stream of a batch
        shape and keeps the ring for the next; a stream that finds the
        ring held by another live one, and every partial batch, run the
        eager forward. Each yielded frame is the caller's own array.
        Unbucketed: one frame shape needs no padding."""
        it = iter(frames)
        first = next(it, None)
        if first is None:
            return
        shape = np.shape(first)
        if len(shape) != 3 or np.asarray(first).dtype != np.uint8:
            raise ValueError(f"stream takes uint8 HWC frames, got {np.asarray(first).dtype} {shape}")
        bs = self.effective_batch_size(shape[0], shape[1], batch_size)

        def batches() -> Iterator[List[np.ndarray]]:
            buf = [first]
            for frame in it:
                if np.shape(frame) != shape:
                    raise ValueError(
                        f"stream frames must share one shape: {shape}, then {np.shape(frame)}"
                    )
                buf.append(frame)
                if len(buf) == bs:
                    yield buf
                    buf = []
            if buf:
                yield buf

        if self.device.type != "cuda":
            for t, batch in _gathered(batches()):
                with span("stream.stage", t):
                    x = self._to_device(np.stack(batch))
                with span("stream.enqueue", t):
                    out = self.forward_u8(x).numpy()
                with span("stream.caller", t):
                    yield from out
            return
        yield from self._stream_on_card(batches(), bs, shape)

    def _hold_ring(self, bs: int, shape: Tuple[int, ...]) -> Optional[_Ring]:
        """The captured ring for batches of ``bs`` frames of ``shape``,
        captured at its first use, now held for one stream; None where
        graphs do not apply (``graphs_apply``) or another live stream holds
        it."""
        if not graphs_apply(self.device, self.mesh):
            return None
        key = (bs,) + tuple(shape[:2])
        ring = self._rings.get(key)
        if ring is None:
            slots = _slots(bs, shape, self.SCALE, self.device)
            ring = _Ring(slots, _capture(self._forward_u8, [x for _, x, _ in slots]))
            self._rings[key] = ring
            self.graph_captures += len(slots)
        elif ring.held:
            return None
        ring.held = True
        return ring

    def _forward_slot(self, graphs: Sequence[_Captured], k: int, x_u8: torch.Tensor,
                      n: int) -> torch.Tensor:
        """The forward of slot k's first n frames ``x_u8[:n]``: a replay of
        the slot's graph where it has one and the batch is full, else the
        eager forward. A replay counts as a forward."""
        if not graphs or n < x_u8.shape[0]:
            return self.forward_u8(x_u8[:n])
        with span("engine.forward"), span("engine.replay"):
            graphs[k].graph.replay()
        self._counted(x_u8)
        self.graph_replays += 1
        return graphs[k].out

    def _stream_on_card(
        self, batches: Iterator[List[np.ndarray]], bs: int, shape: Tuple[int, ...]
    ) -> Iterator[np.ndarray]:
        """:meth:`stream`'s pipeline. Batch t uses slot t mod
        (STREAM_IN_FLIGHT + 1): pinned input, device input, pinned output,
        and on the graphed path the slot's captured forward. A slot comes
        round again only after its batch was fetched, which waits for its
        download, which follows its forward and its upload, so every buffer
        of the slot, the graph's output too, is free. The device output is
        held until its download completes. Each batch's host steps are
        spans (``utils/spans.py``): gather, stage, enqueue (the forward's
        ``engine.forward`` inside, and ``engine.replay`` inside that on the
        graphed path), wait, copy, and the caller's time between the
        batch's first frame and the return after its last."""
        dev = self.device
        ring = self._hold_ring(bs, shape)
        slots = ring.slots if ring is not None else _slots(bs, shape, self.SCALE, dev)
        graphs = ring.graphs if ring is not None else ()
        compute = torch.cuda.current_stream(dev)
        up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        # (pinned output, frames, device output, download-done event, batch)
        pending: collections.deque = collections.deque()

        def hand_over() -> Iterator[np.ndarray]:
            host_out, n, _, done, t = pending.popleft()
            with span("stream.wait", t):
                done.synchronize()
            with span("stream.copy", t):
                frames = host_out[:n].numpy().copy()
            with span("stream.caller", t):
                yield from frames

        try:
            for t, batch in _gathered(batches):
                host_in, dev_in, host_out = slots[t % len(slots)]
                n = len(batch)
                with span("stream.stage", t):
                    staged = host_in[:n].numpy()
                    for k, frame in enumerate(batch):
                        staged[k] = frame
                with span("stream.enqueue", t):
                    with torch.cuda.stream(up):
                        dev_in[:n].copy_(host_in[:n], non_blocking=True)
                    compute.wait_event(up.record_event())
                    out = self._forward_slot(graphs, t % len(slots), dev_in, n)
                    down.wait_event(compute.record_event())
                    with torch.cuda.stream(down):
                        host_out[:n].copy_(out, non_blocking=True)
                    pending.append((host_out, n, out, down.record_event(), t))
                while len(pending) > STREAM_IN_FLIGHT:
                    yield from hand_over()
            while pending:
                yield from hand_over()
        finally:  # an abandoned stream: nothing in flight may outlive its buffers
            for entry in pending:
                entry[3].synchronize()
            if ring is not None:
                ring.held = False


def _gathered(batches: Iterator[List[np.ndarray]]) -> Iterator[Tuple[int, List[np.ndarray]]]:
    """(t, batch t) of ``stream``'s batches, each ``next`` on the caller's
    frames in a ``stream.gather`` span."""
    for t in itertools.count():
        with span("stream.gather", t):
            batch = next(batches, None)
        if batch is None:
            return
        yield t, batch
