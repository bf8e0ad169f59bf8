"""Serialized deployment artifacts: the uint8 SR forward as ``torch.export``
programs, one per input shape.

The counterpart of ``fast_srgan_tpu/export.py``, which lowers the jitted
forward to serialized StableHLO. Here an artifact is a directory holding
``manifest.json`` (format, architecture, precision, tail, int8 tier, the
device it was exported for, one entry per shape with its bytes) and one
``b{B}_{H}x{W}.pt2`` per shape: ``torch.export.save`` of the engine's
uint8 -> uint8 forward at that static NHWC shape, the weights (and the int8
tier's calibrated activation scales) held as the program's state.

The program calls the port's hand-written kernels as ``fast_srgan::*``
nodes: opaque ``torch.library`` ops (``kernels/``) that the export records
and does not trace into. So the artifact's one dependency is those ops'
registration (importing ``fast_srgan_torch.kernels``, which
:func:`load_exported_dir` does first), in place of the JAX artifact's
"no model code, no checkpoint". An artifact exported for the card runs the
kernels there (and counts their launches); the same graph on the CPU runs
their plain versions. A program is exported where it runs: the device is in
the manifest, and a ``cuda`` artifact refuses to load without a card.

What a kernel decides by shape stays inside its op (the instance-norm
family's ``plan``). A context manager is not captured in a graph, so
:func:`load_exported_dir` runs an fp32 artifact inside
``ops/precision.py``'s ``cudnn_without_tf32()``, as the engine does.

Drive: ``python -m fast_srgan_torch.scripts.export_model`` (export and
check), :func:`load_exported_dir` on the serving side.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fast_srgan_torch import quant
from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.inference import arch_from_params, sr_forward_u8
from fast_srgan_torch.models.generator import Generator
from fast_srgan_torch.models.swinir import FAMILY_NAMES
from fast_srgan_torch.ops.lr_tail import generator_apply_lr_tail, prepare_lr_tail
from fast_srgan_torch.ops.precision import fp32_precision

MANIFEST = "manifest.json"
FORMAT = "fast-srgan-torch/export-v1"


class _Slot(str):
    """Where a buffer sits in a :class:`TensorTree`'s structure."""


class TensorTree(nn.Module):
    """A nested structure of tensors (dicts, lists, tuples, NamedTuples; ints,
    dtypes and None beside them) whose tensors are this module's buffers,
    each registered once, so ``torch.export`` lifts them as the program's
    state. :meth:`tree` rebuilds the structure from the current buffers."""

    def __init__(self, tree: Any):
        super().__init__()
        seen: Dict[int, _Slot] = {}
        self._spec = self._hold(tree, "w", seen)

    def _hold(self, node: Any, name: str, seen: Dict[int, _Slot]) -> Any:
        if isinstance(node, torch.Tensor):
            if id(node) not in seen:
                self.register_buffer(name, node)
                seen[id(node)] = _Slot(name)
            return seen[id(node)]
        if isinstance(node, dict):
            return {k: self._hold(v, f"{name}_{k}", seen) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
            return type(node)(*(self._hold(v, f"{name}_{f}", seen)
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(self._hold(v, f"{name}_{i}", seen) for i, v in enumerate(node))
        return node

    def tree(self) -> Any:
        return self._build(self._spec)

    def _build(self, spec: Any) -> Any:
        if isinstance(spec, _Slot):
            return getattr(self, spec)
        if isinstance(spec, dict):
            return {k: self._build(v) for k, v in spec.items()}
        if isinstance(spec, tuple) and hasattr(spec, "_fields"):
            return type(spec)(*(self._build(v) for v in spec))
        if isinstance(spec, (list, tuple)):
            return type(spec)(self._build(v) for v in spec)
        return spec


class SRForwardU8(nn.Module):
    """The engine's uint8 -> uint8 forward over one weight set held as module
    state: ``inference.sr_forward_u8`` around the generator with the LR tail
    (``form == "lr_tail"``), the canonical tail (``"canonical"``), or the
    int8 ``ups`` tier with its activation scales (``"int8"``). The same
    functions as :class:`~fast_srgan_torch.inference.SRInferenceEngine`, on
    the same prepared weights, so an fp32 program equals the engine bitwise.
    Build it with :func:`build_forward_u8`."""

    def __init__(self, params: Dict[str, Any], *, dtype: torch.dtype, lr_tail: bool,
                 quantize: bool, calib_batches: Optional[Sequence[Any]], device: torch.device):
        super().__init__()
        self.arch = arch_from_params(params)
        if "family" in self.arch:
            raise ValueError("export takes the Fast-SRGAN generator;"
                             f" {FAMILY_NAMES[self.arch['family']]} is served by SRInferenceEngine")
        self.dtype = dtype
        self.device = device
        self.form = "int8" if quantize else ("lr_tail" if lr_tail else "canonical")
        model = Generator(**self.arch)
        model.load_state_dict(state_dict_from_jax_params(params))
        tail = prepare_lr_tail(model, dtype, device) if self.form == "lr_tail" else None
        self.model = model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()
        if self.form == "int8":
            calib_plan = quant.prepare_generator(params, None, torch.float32, device)
            scales = quant.calibrate_scales(
                calib_plan, calib_batches or [quant.default_calibration_batch()]
            )
            plan = quant.prepare_generator(params, "ups", dtype, device, model=self.model)
            tail = plan.tail
            int8 = [n for n, e in tail.items()
                    if isinstance(e, dict) and ("q" in e or "phases_q" in e)]
            self.scales = TensorTree({n: scales[n].to(torch.float32) for n in int8})
            # the plan's ints and dtypes; its tensors are ``tail`` (the
            # ups tier's trunk is the Generator's)
            self.plan = dataclasses.replace(plan, tail={}, trunk=None)
        if self.form != "canonical":
            # these forms run the Generator's trunk and the one LR tail,
            # whose prepared weights are the module's one tree
            self.tail = TensorTree(tail)
            self.model.upsampling = nn.ModuleList()
            self.model.head = nn.Sequential()

    @property
    def act_scales(self) -> Dict[str, torch.Tensor]:
        """The int8 tier's activation scales (one-value fp32 tensors)."""
        return self.scales.tree()

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.form == "canonical":
            return self.model(x)
        if self.form == "lr_tail":
            return generator_apply_lr_tail(self.model, self.tail.tree(), x)
        plan = dataclasses.replace(self.plan, tail=self.tail.tree(), trunk=self.model.trunk)
        return quant.sr_quant_forward(plan, self.act_scales, x)

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        return sr_forward_u8(self._apply, x_u8)


def build_forward_u8(
    params: Dict[str, Any],
    *,
    bf16: bool = True,
    lr_tail: bool = True,
    quantize: bool = False,
    calib_batches: Optional[Sequence[Any]] = None,
    device: Any = "cuda",
) -> SRForwardU8:
    """The engine's uint8 -> uint8 forward as an ``nn.Module`` on ``device``
    (the card unless ``"cpu"`` is asked for; raises without one).

    ``quantize`` holds the int8 ``ups`` tier instead (the engine's
    ``quantize=True``): int8 weights, dequant scales and activation scales,
    calibrated here on ``calib_batches`` (sample inputs as the engine takes
    them; default: the synthetic batch), so the artifact needs no
    calibration when it loads. ``bf16`` is then the glue dtype."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass device='cpu'"
            " to export for the CPU"
        )
    dtype = torch.bfloat16 if bf16 else torch.float32
    return SRForwardU8(params, dtype=dtype, lr_tail=lr_tail, quantize=quantize,
                       calib_batches=calib_batches, device=dev)


def export_shape(module: SRForwardU8, batch: int, height: int, width: int):
    """``torch.export`` of the forward for one static NHWC uint8 input shape,
    under ``torch.no_grad()`` (an inference-mode tensor cannot be traced),
    without the example input (zeros) that a saved program would keep."""
    x = torch.zeros((batch, height, width, 3), dtype=torch.uint8, device=module.device)
    with torch.no_grad():
        program = torch.export.export(module, (x,))
    program.example_inputs = None  # else the saved artifact carries x's bytes
    return program


def save_exported_dir(
    out_dir: str,
    entries: List[Tuple[Tuple[int, int, int], Any]],
    *,
    arch: Dict[str, int],
    bf16: bool,
    lr_tail: bool,
    quantize: bool = False,
    device: str = "cuda",
) -> str:
    """Write ``manifest.json`` and one ``.pt2`` per ((b, h, w), exported
    program); each entry records its file's bytes. Duplicate shapes are
    rejected: they would overwrite each other's file. Returns the manifest's
    path."""
    shapes = [s for s, _ in entries]
    dupes = {s for s in shapes if shapes.count(s) > 1}
    if dupes:
        raise ValueError(f"duplicate export shapes (b, h, w): {sorted(dupes)}")
    os.makedirs(out_dir, exist_ok=True)
    table = []
    for (b, h, w), program in entries:
        name = f"b{b}_{h}x{w}.pt2"
        path = os.path.join(out_dir, name)
        with warnings.catch_warnings():
            # the archive calls a channels_last weight incomplete (it is not
            # NCHW-contiguous) and saves its whole storage with its strides,
            # which is right for these dense tensors
            warnings.filterwarnings("ignore", message="No complete tensor found")
            torch.export.save(program, path)
        table.append({"file": name, "batch": b, "height": h, "width": w,
                      "bytes": os.path.getsize(path)})
    manifest = {"format": FORMAT, "arch": arch, "bf16": bf16, "lr_tail": lr_tail,
                "quantize": quantize, "device": str(device), "entries": table}
    path = os.path.join(out_dir, MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return path


class ExportedForward:
    """One loaded artifact: a uint8 [B, H, W, 3] tensor or array of its
    shape in, the uint8 [B, sH, sW, 3] output tensor on the artifact's
    device out."""

    def __init__(self, program, shape: Tuple[int, int, int, int], device: torch.device,
                 fp32: bool):
        self.module = program.module()
        self.shape = shape
        self.device = device
        self.fp32 = fp32

    def __call__(self, x: Any) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if tuple(x.shape) != self.shape or x.dtype != torch.uint8:
            raise ValueError(
                f"this artifact takes uint8 {self.shape}, got {x.dtype} {tuple(x.shape)}"
            )
        with torch.inference_mode(), fp32_precision(self.fp32, self.device):
            return self.module(x.to(self.device))


def load_exported_dir(out_dir: str) -> Dict[str, Any]:
    """Load an artifact directory -> ``{"manifest": ..., "forwards": {(b, h,
    w): ExportedForward}}``. Registers the port's kernel ops first (the
    programs' one dependency); raises for another format, and for a
    ``cuda`` artifact where no card is present."""
    import fast_srgan_torch.kernels  # noqa: F401  (registers the fast_srgan ops)

    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{out_dir}: format {manifest.get('format')!r}, not {FORMAT!r}")
    device = torch.device(manifest["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{out_dir} was exported for cuda, and no card is present")
    forwards = {}
    for e in manifest["entries"]:
        program = torch.export.load(os.path.join(out_dir, e["file"]))
        shape = (e["batch"], e["height"], e["width"])
        forwards[shape] = ExportedForward(program, (*shape, 3), device, not manifest["bf16"])
    return {"manifest": manifest, "forwards": forwards}
