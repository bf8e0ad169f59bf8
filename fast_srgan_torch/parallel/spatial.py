"""Exact width-sharded generator inference: halo exchange and split norms.

The port of ``fast_srgan_tpu/parallel/spatial.py``. A large frame (540x960
LR in, 4K out) is cut into contiguous width shards across a mesh's devices,
and the forward stays exact:

  * every 3x3 conv needs one column from each neighbour: each shard is
    extended by its neighbours' edge columns (zeros at the frame's edges,
    which is the one-device conv's padding) and convolved with no width
    padding (cuDNN ``padding=(1, 0)``; the s8 kernel's halo form);
  * instance norm is global over the frame: each shard's statistics op
    writes its sums, every shard gathers all of them in shard order, and
    each normalizes with their sum over the whole frame's pixel count
    (``kernels/instance_norm.py``'s split form), so every shard computes
    bitwise the same statistics;
  * pixel shuffle, PReLU and tanh act within a shard;
  * the LR-domain tail (``ops/lr_tail.py``) runs per shard
    (:func:`lr_tail_shards`: the one tail's skeleton over shard lists, on
    its prepared form, its conv dispatch and its head rule, with halo convs
    where the one-device tail pads): phase (p, q) of stage 2 reads LR
    columns {w+q-1, w+q}, a window of the halo-extended shard, and each
    head conv is a halo conv. 8x runs stage 0 canonically (a shard's
    column i gives output columns 2i and 2i+1 in the same shard).

The mesh (``parallel/mesh.py``) is a grid of ``torch.device``s in this
process. Halo columns and statistics move by ``Tensor.to``, which orders the
copy on the consumer's current stream; on a repeated device a halo is a
slice, by the same code. Shards are launched one after another, so shards
on different cards overlap. Each device holds one copy of the weights,
prepared once per (mesh, dtype) for the params object last given.

In fp32 the sharded output differs from the one-device forward by fp32
reassociation only (conv tilings and the statistics' summation order);
in bf16 cuDNN picks other algorithms for a shard than for a frame, so the
two are not bitwise equal. The int8 forward (:func:`build_tiled_quant_forward`)
quantizes with static scales, so quantizing a halo-extended shard is
quantizing the frame's columns; an fp32 difference that lands a value on
a rounding boundary flips one int8 step (the bounded-flip contract).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fast_srgan_torch import quant
from fast_srgan_torch.kernels.instance_norm import (
    instance_norm_add_from_stats,
    instance_norm_prelu_from_stats,
    instance_norm_stats,
)
from fast_srgan_torch.kernels.int8_conv import int8_conv_phases
from fast_srgan_torch.kernels.pixel_shuffle import phase_major_index, pixel_shuffle_phase_major
from fast_srgan_torch.models.generator import prelu
from fast_srgan_torch.models.swinir import FAMILY_NAMES, family_of
from fast_srgan_torch.ops.lr_tail import (
    _out,
    _phase_outputs,
    concat_head,
    head_form,
    prepare_lr_tail,
    stage_names,
    tail_conv,
)
from fast_srgan_torch.ops.precision import fp32_precision
from fast_srgan_torch.parallel.mesh import Mesh, mesh_axes

#: A frame's (or a batch's) width shards in order, each on its device.
Shards = List[torch.Tensor]
_CL = torch.channels_last

# -- halo exchange and the sharded ops ----------------------------------------


def _extend(x: torch.Tensor, left: Optional[torch.Tensor],
            right: Optional[torch.Tensor]) -> torch.Tensor:
    """x with one column on each side: the neighbours' (None: zeros)."""
    b, c, h, w = x.shape
    out = torch.empty((b, c, h, w + 2), dtype=x.dtype, device=x.device, memory_format=_CL)
    out[..., 1:w + 1].copy_(x)
    for col, v in ((slice(0, 1), left), (slice(w + 1, w + 2), right)):
        if v is None:
            out[..., col].zero_()
        else:
            out[..., col].copy_(v)
    return out


def halo_extended(xs: Shards) -> Iterator[torch.Tensor]:
    """Each shard extended by its neighbours' edge columns (zeros at the
    frame's edges), on its own device; made one at a time, so a caller
    that consumes each before the next holds one extended shard."""
    n = len(xs)
    for i, x in enumerate(xs):
        left = xs[i - 1][..., -1:].to(x.device) if i > 0 else None
        right = xs[i + 1][..., :1].to(x.device) if i < n - 1 else None
        yield _extend(x, left, right)


def halo_conv(xs: Shards, weights: Sequence[torch.Tensor],
              biases: Optional[Sequence[Optional[torch.Tensor]]] = None) -> Shards:
    """A 3x3 stride-1 conv of the sharded frame: each halo-extended shard
    through cuDNN with no width padding (``padding=(1, 0)``)."""
    biases = biases or [None] * len(xs)
    return [F.conv2d(e, w, b, padding=(1, 0))
            for e, w, b in zip(halo_extended(xs), weights, biases)]


def _joined_partials(xs: Shards):
    """Every shard's statistics ([B, 1, 2C] each) joined in shard order,
    [B, shards, 2C] on each shard's device (one copy a device), and the
    frame's pixel count."""
    parts = [instance_norm_stats(x) for x in xs]
    joined: Dict[torch.device, torch.Tensor] = {}
    for x in xs:
        if x.device not in joined:
            joined[x.device] = torch.cat([p.to(x.device) for p in parts], dim=1)
    count = xs[0].shape[2] * sum(x.shape[3] for x in xs)
    return [joined[x.device] for x in xs], count


def dist_norm_prelu(xs: Shards, alphas: Sequence[torch.Tensor]) -> Shards:
    """IN + PReLU of the sharded frame with the whole frame's statistics.
    The shards normalize last first: on one card the last shard's x is what
    the statistics read last, still in L2."""
    partials, count = _joined_partials(xs)
    return [instance_norm_prelu_from_stats(x, a, p, count)
            for x, a, p in reversed(list(zip(xs, alphas, partials)))][::-1]


def dist_norm_add(xs: Shards, skips: Shards) -> Shards:
    """IN + residual add of the sharded frame with the whole frame's
    statistics, the shards last first (as :func:`dist_norm_prelu`)."""
    partials, count = _joined_partials(xs)
    return [instance_norm_add_from_stats(x, s, p, count)
            for x, s, p in reversed(list(zip(xs, skips, partials)))][::-1]


# -- the generator over pluggable ops -----------------------------------------


def generator_forward(
    models: Sequence[Any], xs: Shards, conv: Callable, norm_prelu: Callable,
    norm_add: Callable, tail: Callable[[Shards], Shards],
) -> Shards:
    """The generator graph (``models/generator.py``) on width shards: each
    shard's weights are ``models[i]`` (a ``Generator`` on its device).
    ``conv(xs, weights, biases=None)`` is a 3x3 conv, ``norm_prelu(xs,
    alphas)`` and ``norm_add(xs, skips)`` the two IN epilogues, ``tail(y)``
    the upsampling tail and head on the trunk's output."""
    r = conv(xs, [m.neck[0].weight for m in models], [m.neck[0].bias for m in models])
    r = [prelu(v, m.neck[1].weight) for v, m in zip(r, models)]
    y = r
    for i in range(models[0].n_layers):
        blocks = [m.stem[i] for m in models]
        t = norm_prelu(conv(y, [b.conv1.weight for b in blocks]),
                       [b.relu1.weight for b in blocks])
        y = norm_add(conv(t, [b.conv2.weight for b in blocks]), y)
    y = norm_add(conv(y, [m.bottleneck[0].weight for m in models]), r)
    return tail(y)


def lr_tail_shards(tails: Sequence[Dict[str, Any]], ys: Shards,
                   exs: Optional[Sequence[Any]] = None) -> Shards:
    """``ops/lr_tail.lr_tail`` on width shards: ``tails`` is each shard's
    copy of the prepared tail, ``exs`` each shard's int8 executor context
    (None: a float tail). Each conv is ``tail_conv`` of the halo-extended
    shard; the four stage-2 phases are those of the shard padded by a zero
    row above and below; a summed head takes one halo exchange a phase, a
    concat one the shard's [B, 16F, H, w] phase concat."""
    exs = exs or [None] * len(ys)
    names = stage_names(tails[0])

    def conv(xs: Shards, name: str, heads=None, quantize_for=None) -> Shards:
        heads = heads or [t[name] for t in tails]
        return [tail_conv(e, name, st, ex, quantize_for, halo=True)
                for e, st, ex in zip(halo_extended(xs), heads, exs)]

    if len(names) == 1:
        z = conv(conv(ys, "up0"), "head")
        return [F.pixel_shuffle(_out(v.float(), t), 2) for v, t in zip(z, tails)]
    if len(names) == 3:
        ys = [F.pixel_shuffle(v, 2).contiguous(memory_format=_CL) for v in conv(ys, "up0")]
    n0, n1 = names[-2:]
    stage2 = [t[n1] for t in tails]
    if "phases_q" in stage2[0]:
        phases = [int8_conv_phases(e, s2["phases_q"], s2["ws"], ex.scales[n1], s2["b"], s2["a"],
                                   ex.glue, padding=(0, 0))
                  for e, s2, ex in zip(halo_extended(conv(ys, n0, quantize_for=n1)), stage2, exs)]
    else:
        phases = [_phase_outputs(F.pad(e, (0, 0, 1, 1)), s2["phases"], s2["b"], s2["a"])
                  for e, s2 in zip(halo_extended(conv(ys, n0)), stage2)]
    heads = [t["head"] for t in tails]
    if head_form(heads[0], exs[0]) == "summed":
        z = None
        for i in range(4):
            part = halo_conv([ph[i] for ph in phases], [h["parts"][i] for h in heads])
            z = [v.float() for v in part] if z is None else [a + v.float()
                                                             for a, v in zip(z, part)]
    else:
        a2 = [torch.cat(ph, dim=1).contiguous(memory_format=_CL) for ph in phases]
        del phases
        z = [v.float() for v in conv(a2, "head", [concat_head(h) for h in heads])]
    return [F.pixel_shuffle(_out(v + h["b32"].view(1, -1, 1, 1), t), 4)
            for v, h, t in zip(z, heads, tails)]


def _canonical_tail(models, stages, ys: Shards) -> Shards:
    """conv -> PixelShuffle(2) -> PReLU per stage, the conv's channels in
    phase-major order so the shuffle is the copy kernel, then the head."""
    y = ys
    for j in range(len(stages[0])):
        z = halo_conv(y, [s[j][0] for s in stages], [s[j][1] for s in stages])
        y = [prelu(pixel_shuffle_phase_major(v.contiguous(memory_format=_CL)), s[j][2])
             for v, s in zip(z, stages)]
    z = halo_conv(y, [m.head[0].weight for m in models], [m.head[0].bias for m in models])
    return [torch.tanh(v.float()) for v in z]


# -- prepared weights and the mesh --------------------------------------------


def _float_model(params, dtype: torch.dtype, device: torch.device):
    return quant._float_generator(params, dtype, device).requires_grad_(False)


class _Tiled:
    """What the float and int8 sharded forwards share: the mesh's rows (the
    sp devices of each batch group), checks, and one prepared replica a
    device for the params object last given."""

    def __init__(self, mesh: Mesh, axis_name: str):
        sp, batch = mesh_axes(mesh, axis_name)
        grid = mesh.devices
        if batch is None:
            grid = grid.reshape(1, -1)
        elif mesh.axis_names.index(sp) == 0:
            grid = grid.T
        self.rows = [list(r) for r in grid]
        self.batch_axis = batch
        self.out_device = self.rows[0][0]
        self._params = None
        self._replicas: Dict[torch.device, Any] = {}

    def replicas(self, params) -> Dict[torch.device, Any]:
        if params is not self._params:
            family = family_of(params)
            if family is not None:
                why = ("scans run the whole row and column, which no halo bounds"
                       if family == "mambair" else
                       "shifted windows would need halos of whole windows")
                raise ValueError(
                    "the width-tiled forward serves the Fast-SRGAN generator only:"
                    f" {FAMILY_NAMES[family]}'s {why}; run it through SRInferenceEngine")
            self._replicas = {}
            self._params = params
            for d in (d for row in self.rows for d in row):
                if d not in self._replicas:
                    self._replicas[d] = self._prepare(params, d)
        return self._replicas

    def _prepare(self, params, device):
        raise NotImplementedError

    def _groups(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x's batch groups, one per row, after the divisibility checks."""
        n_sp = len(self.rows[0])
        if x.shape[3] % n_sp:
            raise ValueError(f"width {x.shape[3]} not divisible by spatial axis size {n_sp}")
        if x.shape[0] % len(self.rows):
            raise ValueError(f"batch {x.shape[0]} not divisible by {self.batch_axis!r} axis "
                             f"size {len(self.rows)}")
        return list(torch.chunk(x, len(self.rows), dim=0))

    def _shards(self, x: torch.Tensor, row, dtype) -> Shards:
        return [part.to(device=d, dtype=dtype).contiguous(memory_format=_CL)
                for part, d in zip(torch.chunk(x, len(row), dim=3), row)]

    def _gather(self, outs: List[Shards]) -> torch.Tensor:
        return torch.cat([torch.cat([s.to(self.out_device) for s in row], dim=3)
                          for row in outs])


class TiledForward(_Tiled):
    """:func:`build_tiled_forward`'s function: ``forward(params, x)``."""

    def __init__(self, mesh: Mesh, axis_name: str, dtype: torch.dtype, lr_tail: bool):
        super().__init__(mesh, axis_name)
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be bfloat16 or float32, got {dtype}")
        self.dtype, self.lr_tail = dtype, lr_tail

    def _prepare(self, params, device):
        model = _float_model(params, self.dtype, device)
        if self.lr_tail:
            return model, prepare_lr_tail(model, self.dtype, device)
        stages = []
        for st in model.upsampling:
            perm = phase_major_index(st.conv.weight.shape[0], device)
            stages.append((st.conv.weight[perm].contiguous(memory_format=_CL),
                           st.conv.bias[perm], st.relu.weight))
        return model, stages

    def _row(self, row, reps, x: torch.Tensor) -> Shards:
        models = [reps[d][0] for d in row]
        extras = [reps[d][1] for d in row]
        if self.lr_tail:
            tail = functools.partial(lr_tail_shards, extras)
        else:
            tail = functools.partial(_canonical_tail, models, extras)
        return generator_forward(models, self._shards(x, row, self.dtype), halo_conv,
                                 dist_norm_prelu, dist_norm_add, tail)

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] fp32, on the mesh's
        first device. W must divide by the sp axis size, B by the batch
        axis size."""
        reps = self.replicas(params)
        groups = self._groups(x)
        outs = []
        with torch.inference_mode(), fp32_precision(self.dtype == torch.float32,
                                                    self.out_device):
            for row, g in zip(self.rows, groups):
                outs.append(self._row(row, reps, g))
            return self._gather(outs)


@functools.lru_cache(maxsize=8)
def build_tiled_forward(
    mesh: Mesh, axis_name: str = "sp", dtype: torch.dtype = torch.bfloat16,
    lr_tail: bool = True,
) -> TiledForward:
    """The exact width-sharded generator forward over ``mesh``:
    ``forward(params, x)``, x [B, 3, H, W] in [-1, 1] (any device; shards
    move to theirs), W divisible by the spatial axis size, the output
    [B, 3, sH, sW] fp32 on the mesh's first device. ``params`` is a
    generator param tree with numpy leaves (``load_npz_params``); each
    device's copy of the weights is prepared at the first call with that
    object. ``lr_tail`` runs the LR-domain tail (2x: one stage; 4x; 8x:
    hierarchical), else the canonical tail through the shuffle kernel.

    ``mesh`` is 1-D (every device holds a width slice of every frame) or
    2-D with a batch axis beside ``axis_name`` (e.g. ``("data", "sp")``):
    batch groups over the batch axis, each frame's width over the sp axis
    within its group; B must divide by the batch axis size. fp32 runs
    with TF32 off."""
    return TiledForward(mesh, axis_name, dtype, lr_tail)


def _to_u8(y: torch.Tensor) -> np.ndarray:
    """The engine's output mapping of one frame, as a host HWC array."""
    out = ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return out[0].permute(1, 2, 0).cpu().numpy()


def _frame_in(frame_u8: np.ndarray, mesh: Mesh) -> torch.Tensor:
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"a tiled upscale shards ONE frame and needs a 1-D mesh, got axes"
            f" {mesh.axis_names}; use build_tiled_forward / build_tiled_quant_forward for"
            " batched 2-D ('data', 'sp') meshes"
        )
    x = torch.from_numpy(np.array(frame_u8[None])).to(mesh.devices.reshape(-1)[0])
    return x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0


def tiled_upscale_u8(params, frame_u8: np.ndarray, mesh: Mesh,
                     dtype: torch.dtype = torch.bfloat16) -> np.ndarray:
    """uint8 HWC frame -> uint8 upscaled frame, width-tiled across a 1-D
    ``mesh`` (the engine's normalization in and out)."""
    x = _frame_in(frame_u8, mesh)
    return _to_u8(build_tiled_forward(mesh, dtype=dtype)(params, x))


# -- the int8 tier under width tiling -----------------------------------------


def _q_conv(exs, lays, xs: Shards, name: str) -> Shards:
    """``quant._Exec.conv`` of each halo-extended shard (float or int8 by
    the leaf's form; the int8 one quantizes the extended shard, which with
    static scales is the frame's columns quantized)."""
    return [ex.conv(e, name, lay[name], halo=True)
            for ex, lay, e in zip(exs, lays, halo_extended(xs))]


def _q_trunk(exs, lays, xs: Shards, n_layers: int) -> Shards:
    """``quant._trunk`` with halo convs and the split norms."""
    r = _q_conv(exs, lays, xs, "neck")
    y = r
    for i in range(n_layers):
        t = dist_norm_prelu(_q_conv(exs, lays, y, f"stem_{i}_c1"),
                            [lay[f"stem_{i}_c1"]["norm_a"] for lay in lays])
        y = dist_norm_add(_q_conv(exs, lays, t, f"stem_{i}_c2"), y)
    return dist_norm_add(_q_conv(exs, lays, y, "bottleneck"), r)


class TiledQuantForward(_Tiled):
    """:func:`build_tiled_quant_forward`'s function:
    ``forward(params, act_scales, x)``."""

    def __init__(self, mesh: Mesh, axis_name: str, glue_dtype: torch.dtype,
                 mode: Optional[str]):
        super().__init__(mesh, axis_name)
        if mode is not None and mode not in quant.MODES:
            raise ValueError(f"mode must be None or one of {sorted(quant.MODES)}: {mode!r}")
        if glue_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"glue_dtype must be bfloat16 or float32, got {glue_dtype}")
        self.glue, self.mode = glue_dtype, mode

    def _prepare(self, params, device):
        model = _float_model(params, self.glue, device) if self.mode in ("ups", "tail") else None
        return model, quant.prepare_generator(params, self.mode, self.glue, device, model=model)

    def __call__(self, params, act_scales: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] fp32 on the mesh's
        first device; ``act_scales`` as ``quant.calibrate_scales`` gives
        them (copied to each device at each call: recalibration swaps them
        in)."""
        reps = self.replicas(params)
        groups = self._groups(x)
        scales = {d: {k: torch.as_tensor(v, dtype=torch.float32).to(d)
                      for k, v in act_scales.items()} for d in reps}
        outs = []
        with torch.inference_mode(), fp32_precision(self.glue == torch.float32,
                                                    self.out_device):
            for row, g in zip(self.rows, groups):
                models = [reps[d][0] for d in row]
                plans = [reps[d][1] for d in row]
                lays = [p.layers for p in plans]
                exs = [quant._Exec(scales[d], None, self.glue) for d in row]
                xs = self._shards(g, row, self.glue)
                if plans[0].trunk is not None:  # ups / tail: the float trunk
                    y = generator_forward(models, xs, halo_conv, dist_norm_prelu,
                                          dist_norm_add, lambda v: v)
                else:
                    y = _q_trunk(exs, lays, xs, plans[0].n_layers)
                outs.append(lr_tail_shards([p.tail for p in plans], y, exs))
            return self._gather(outs)


@functools.lru_cache(maxsize=8)
def build_tiled_quant_forward(
    mesh: Mesh, axis_name: str = "sp", glue_dtype: torch.dtype = torch.bfloat16,
    mode: Optional[str] = "ups",
) -> TiledQuantForward:
    """The exact width-sharded int8 forward over ``mesh``:
    ``forward(params, act_scales, x)``. ``params`` is the float param tree,
    quantized by ``mode`` as ``quant.prepare_generator`` does (``ups``,
    ``tail``, ``full``, ``trunk``; None keeps every conv float): per-leaf
    dispatch, as ``quant.sr_quant_forward``. Mesh, shapes and output as
    :func:`build_tiled_forward`; fp32 glue runs with TF32 off."""
    return TiledQuantForward(mesh, axis_name, glue_dtype, mode)


def tiled_quant_upscale_u8(params, act_scales, frame_u8: np.ndarray, mesh: Mesh,
                           glue_dtype: torch.dtype = torch.bfloat16,
                           mode: Optional[str] = "ups") -> np.ndarray:
    """uint8 HWC frame -> uint8 upscaled frame through the int8 tier,
    width-tiled across a 1-D ``mesh`` (``infer --int8 --tile``)."""
    x = _frame_in(frame_u8, mesh)
    forward = build_tiled_quant_forward(mesh, glue_dtype=glue_dtype, mode=mode)
    return _to_u8(forward(params, act_scales, x))
