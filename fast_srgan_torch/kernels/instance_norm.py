"""Instance norm + PReLU, and instance norm + residual add: the CUDA kernel
family and its plain versions.

The port of ``fast_srgan_tpu/kernels/instance_norm.py``. The residual stem
runs ``conv1 -> InstanceNorm -> PReLU -> conv2 -> InstanceNorm -> + x`` in
each of its blocks, and the bottleneck ``conv -> InstanceNorm -> + long
skip``. :func:`instance_norm_prelu` serves the 8 norms that feed a PReLU,
:func:`instance_norm_add` the other 9 (the JAX package computes those as
``instance_norm_nhwc(y) + x``). Both are one kernel family
(``csrc/instance_norm.cu``) with two epilogues, in two forms chosen by shape
(:func:`plan`):

* resident: one cooperative launch, each block keeping its tile on chip
  from the statistics to the store, so x is read from HBM once;
* two launches, where a sample's tiles do not fit in the SMs' shared
  memory: statistics (each sample's totals summed once, by the last of its
  blocks to finish), then normalize sweeping the sample back, on a grid
  sized from the SM count (:func:`two_launch_tiles`).

Both epilogues also take ``valid_hw``, the valid (height, width) of each
sample of a zero-padded batch (the bucketed forward): the masked form sums
the statistics over the valid pixels only, divides by their count, and
stores 0 (PReLU) or skip (residual add) at the padding. It is the
counterpart of the JAX package's ``instance_norm_masked_nhwc``
(``ops/norm.py:43``), which XLA lowered on the TPU; its launches are counted
in ``masked_launches``, apart from the unmasked ones.

Both are ``torch.library`` ops, ``fast_srgan::instance_norm_prelu`` and
``fast_srgan::instance_norm_add`` (``valid_h``/``valid_w`` an optional
pair): opaque to ``torch.export``, which records the op and not what it
does. Dispatch follows the tensor: the op's CPU implementation is the plain
version (the numerical contract); its CUDA implementation launches the
kernel or raises ``ValueError`` for what the kernel does not take, and
counts the launch; its fake implementation gives the output's shape, dtype
and strides. There is no fallback between the two.

The split form (:func:`instance_norm_stats`, then
:func:`instance_norm_prelu_from_stats` / :func:`instance_norm_add_from_stats`)
runs the two launches as separate ops, so the width-sharded forward
(``parallel/spatial.py``) can join every shard's totals before any shard
normalizes.

Every form takes any batch: the two launches and the split form hold the
sample on the grid's y axis, so a call of more than 65535 samples runs
over batch chunks (:func:`launch_plan`), each planned as that chunk, and
counts one launch. The kernels form their offsets in 64 bits, so neither
the batch nor a sample is limited in elements; a sample's pixel index is
32-bit (:data:`MAX_SAMPLE_PX`).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch

from fast_srgan_torch.kernels.batching import GRID_YZ_MAX, batch_chunks, over_chunks, rows
from fast_srgan_torch.ops.norm import EPS, instance_norm, instance_norm_masked, valid_mask

#: (valid_h, valid_w): int32 [B] tensors, the valid region of each sample.
ValidHW = Optional[Tuple[torch.Tensor, torch.Tensor]]

#: The two-launch form's blocks an SM, threads a block and 16-byte vectors a
#: thread loads at once (csrc ``kTwoLaunchBlocks``, ``kThreads``, ``kBatch``).
TWO_LAUNCH_BLOCKS = 2
TWO_LAUNCH_THREADS = 256
TWO_LAUNCH_BATCH = 8
#: Threads of a resident block, at most (a multiple of C / vector width).
RESIDENT_THREADS = 512
#: 16-byte vectors a resident thread holds in registers, at most.
HELD = 8
#: Fewest pixels a resident tile is cut to (smaller samples take fewer blocks).
MIN_TILE_PX = 32
#: Shared memory one block may opt in to on Hopper (227 KB; the kernels are
#: built for sm_90a only).
SMEM_LIMIT = 232448
# 16-byte vectors: values per load, and the most channel groups a block takes.
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_MAX_GROUPS = 256
#: Pixels a sample may hold. The kernels index a sample's pixels with 32-bit
#: ints, which run up to one grid stride past its last pixel (at most two
#: blocks an SM of 2048 pixels each: under 2^22 for up to 1024 SMs); every
#: offset into a tensor is 64-bit. Memory runs out first from C = 16 on
#: (such a bf16 sample is 68 GB).
MAX_SAMPLE_PX = 2**31 - 2**22


def _norm(x: torch.Tensor, valid_hw: ValidHW) -> torch.Tensor:
    if valid_hw is None:
        return instance_norm(x, eps=EPS)
    mask, count = valid_mask(x.shape[2], x.shape[3], *valid_hw)
    return instance_norm_masked(x, mask, count, eps=EPS)


def instance_norm_prelu_reference(
    x: torch.Tensor, alpha: torch.Tensor, valid_hw: ValidHW = None
) -> torch.Tensor:
    """Plain composition: ``ops.norm.instance_norm`` (``instance_norm_masked``
    with ``valid_hw``) then a PReLU whose slope is cast to the activation
    dtype (the JAX ``_reference_impl``)."""
    y = _norm(x, valid_hw)
    a = alpha.to(y.dtype)
    return torch.where(y >= 0, y, a * y)


def instance_norm_add_reference(
    x: torch.Tensor, skip: torch.Tensor, valid_hw: ValidHW = None
) -> torch.Tensor:
    """Plain composition: ``ops.norm.instance_norm(x) + skip`` (JAX's
    ``instance_norm_nhwc(y) + x``; ``instance_norm_masked`` with
    ``valid_hw``): the normalized value is rounded to x's dtype, then the
    sum is taken in fp32 and rounded again."""
    return _norm(x, valid_hw) + skip


def check_kernel_inputs(x: torch.Tensor, alpha: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes (x, alpha) as they are."""
    _check_activation(x, "instance_norm_prelu")
    if alpha.numel() != 1 or alpha.device != x.device:
        raise ValueError("alpha must be one value on x's device")


def check_add_inputs(x: torch.Tensor, skip: torch.Tensor) -> None:
    """Raise ValueError unless the CUDA kernel takes (x, skip) as they are."""
    _check_activation(x, "instance_norm_add")
    if skip.dtype != x.dtype:
        raise ValueError(f"skip must have x's dtype {x.dtype}, got {skip.dtype}")
    if skip.shape != x.shape:
        raise ValueError(
            f"skip must have x's shape {tuple(x.shape)}, got {tuple(skip.shape)}"
        )
    if skip.device != x.device:
        raise ValueError(f"skip must be on x's device {x.device}, got {skip.device}")
    if not skip.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("skip must be contiguous in torch.channels_last")
    if skip.data_ptr() % 16:
        raise ValueError("skip must be 16-byte aligned")


def check_valid_hw(x: torch.Tensor, valid_hw: ValidHW) -> None:
    """Raise ValueError unless ``valid_hw`` is None or two contiguous int32
    [B] tensors on x's device. Their values are not read on the host (that
    would wait for the card): each must lie in [1, H] and [1, W]."""
    if valid_hw is None:
        return
    if len(valid_hw) != 2:
        raise ValueError("valid_hw must be a pair (valid_h, valid_w)")
    for t in valid_hw:
        if t.dtype != torch.int32 or t.shape != (x.shape[0],) or not t.is_contiguous():
            raise ValueError(
                f"valid_hw must hold contiguous int32 [{x.shape[0]}] tensors, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"valid_hw must be on x's device {x.device}, got {t.device}")


def _check_activation(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _VEC:
        raise ValueError(f"{name} takes bf16 or fp32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    vec = _VEC[x.dtype]
    if c % vec or c // vec > _MAX_GROUPS:
        raise ValueError(
            f"C={c} unsupported for {x.dtype}: need C % {vec} == 0 and "
            f"C <= {vec * _MAX_GROUPS}"
        )
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be contiguous in torch.channels_last")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    check_size(x.shape)


def check_size(shape: Tuple[int, int, int, int]) -> None:
    """Raise ValueError unless a call takes a [B, C, H, W] activation of
    this size: any B, and each sample 1 to MAX_SAMPLE_PX pixels."""
    b, _, h, w = shape
    if b * h * w == 0 or h * w > MAX_SAMPLE_PX:
        raise ValueError(f"unsupported size {tuple(shape)}")


def check_launch(shape: Tuple[int, int, int, int]) -> None:
    """Raise ValueError unless one launch takes this size: as
    :func:`check_size`, and at most GRID_YZ_MAX samples (the two launches'
    and the split form's ``dim3(tiles, B)`` grid)."""
    check_size(shape)
    if shape[0] > GRID_YZ_MAX:
        raise ValueError(f"unsupported size {tuple(shape)}: more than {GRID_YZ_MAX} samples")


def launch_plan(shape: Tuple[int, int, int, int], most: int = GRID_YZ_MAX
                ) -> List[Tuple[int, int]]:
    """The batch chunks a call of any form launches over, [start, stop)
    spans covering the batch in order (``batching.batch_chunks``), each
    checked against one launch's limits: one span for a batch of at most
    ``most`` samples, which launches as it would unchunked."""
    spans = batch_chunks(shape[0], most)
    for start, stop in spans:
        check_launch((stop - start, *shape[1:]))
    return spans


def resident_smem(c: int, itemsize: int, tile_px: int, waves: int) -> int:
    """Shared memory of a resident block (csrc/instance_norm.cu
    ``launch_resident``): a ring of min(waves, 3) tiles of x, and the fp32
    sums."""
    groups = c // (16 // itemsize)
    threads = (RESIDENT_THREADS // groups) * groups
    rows = threads // groups
    sums = 2 * c * (rows + 1) + max(4 * threads, 2 * c) + 4 * c
    return min(waves, 3) * tile_px * c * itemsize + 4 * sums + 16


def plan(shape: Tuple[int, int, int, int], itemsize: int, n_sms: int
         ) -> Optional[Tuple[int, int, int]]:
    """The resident form's (grid, samples a wave, tile pixels) for a
    [B, C, H, W] activation, or None where it does not fit: then the two
    launches run. Both epilogues take the same plan.

    A tile is at most HELD vectors a thread and what shared memory holds.
    All samples in one wave where their tiles fit (one buffer); else waves
    of as many samples as the SMs hold with a ring of three tile buffers,
    each sample cut into the most tiles the SMs allow (at least MIN_TILE_PX
    pixels each)."""
    b, c, h, w = shape
    hw = h * w
    groups = c // (16 // itemsize)
    held_px = HELD * (RESIDENT_THREADS // groups)
    max_tiles = math.ceil(hw / MIN_TILE_PX)
    if b <= n_sms:
        tiles = min(n_sms // b, max_tiles)
        tile_px = math.ceil(hw / tiles)
        if tile_px <= held_px and resident_smem(c, itemsize, tile_px, 1) <= SMEM_LIMIT:
            return b * tiles, b, tile_px
    cap_px = (SMEM_LIMIT - resident_smem(c, itemsize, 0, 3)) // (3 * c * itemsize)
    cap_px = min(cap_px, held_px)
    if cap_px < 1 or math.ceil(hw / cap_px) > n_sms:
        return None
    per_wave = min(b, n_sms // math.ceil(hw / cap_px))
    tiles = max(math.ceil(hw / cap_px), min(n_sms // per_wave, max_tiles))
    tile_px = math.ceil(hw / tiles)
    if resident_smem(c, itemsize, tile_px, math.ceil(b / per_wave)) > SMEM_LIMIT:
        return None
    return per_wave * tiles, per_wave, tile_px


def two_launch_chunk(c: int, itemsize: int) -> int:
    """Pixels a two-launch statistics block reads at once: a chunk."""
    groups = c // (16 // itemsize)
    return TWO_LAUNCH_BATCH * max(1, TWO_LAUNCH_THREADS // groups)


@functools.lru_cache(maxsize=64)  # called on the host path of every split op
def two_launch_tiles(shape: Tuple[int, int, int, int], itemsize: int, n_sms: int) -> int:
    """Blocks a sample of the two-launch and split forms' [tiles, B] grid:
    TWO_LAUNCH_BLOCKS an SM, but no more than the sample's chunks (the
    blocks of a sample take its chunks in turn, chunk j block j mod tiles,
    so each has one at least). Not a function of B: a sample's statistics
    come out the same bits alone, in any batch, and as one shard of the
    split form."""
    _, c, h, w = shape
    return max(1, min(TWO_LAUNCH_BLOCKS * n_sms, -(-(h * w) // two_launch_chunk(c, itemsize))))


_SMS = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _launch(
    x: torch.Tensor, other: torch.Tensor, residual: bool, valid_hw: ValidHW = None
) -> torch.Tensor:
    """One call of the kernel family: ``other`` is the slope (PReLU) or
    skip (residual add); ``valid_hw`` selects the masked form. One launch
    (or two) a batch chunk (:func:`launch_plan`), each chunk planned as
    that chunk; one count a call."""
    from fast_srgan_torch.kernels._build import load_library

    lib = load_library()
    b, c, h, w = x.shape
    hw = h * w
    spans = launch_plan(x.shape)
    name = "fsr_instance_norm_" + ("add" if residual else "prelu")
    name += "_masked" if valid_hw is not None else ""
    name += "_bf16" if x.dtype == torch.bfloat16 else "_f32"
    fn = getattr(lib, name)
    with torch.cuda.device(x.device):
        n_sms = _sm_count(x.device)
        out = torch.empty_like(x, memory_format=torch.channels_last)
        second = other if residual else other.detach().reshape(1).to(torch.float32).contiguous()
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def launch(start: int, stop: int, out_part: torch.Tensor) -> None:
            n = stop - start
            found = plan((n, c, h, w), x.element_size(), n_sms)
            if found is None:
                tile = two_launch_tiles((b, c, h, w), x.element_size(), n_sms)
                grid, per_wave = 0, 0
                # each block's partial sums, each sample's totals, its counter
                scratch = n * (tile + 1) * 2 * c + n
            else:
                grid, per_wave, tile = found
                # 64-bit tagged words (zeroed ahead of the kernel): each tile's
                # partial sums, then each sample's totals
                scratch = 2 * n * (grid // per_wave + 1) * 2 * c
            partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
            x_part = rows(x, start, stop)
            other_part = rows(second, start, stop) if residual else second
            if valid_hw is None:
                err = fn(x_part.data_ptr(), other_part.data_ptr(), out_part.data_ptr(),
                         partial.data_ptr(), n, hw, c, grid, per_wave, tile, EPS, stream)
            else:
                vh, vw = rows(valid_hw, start, stop)
                err = fn(x_part.data_ptr(), other_part.data_ptr(), vh.data_ptr(), vw.data_ptr(),
                         out_part.data_ptr(), partial.data_ptr(), n, hw, w, c, grid, per_wave,
                         tile, EPS, stream)
            if err:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")

        over_chunks(spans, out, launch)
    counted = instance_norm_add if residual else instance_norm_prelu
    if valid_hw is None:
        counted.launches += 1
    else:
        counted.masked_launches += 1
    return out


def _check_device(x: torch.Tensor, name: str) -> None:
    """The ops run on the CPU (plain) or the card (kernel), nowhere else."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def _split(valid_hw: ValidHW) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``valid_hw`` as the ops' (valid_h, valid_w) arguments."""
    if valid_hw is None:
        return None, None
    if len(valid_hw) != 2:
        raise ValueError("valid_hw must be a pair (valid_h, valid_w)")
    return valid_hw[0], valid_hw[1]


def _join(valid_h, valid_w) -> ValidHW:
    if (valid_h is None) != (valid_w is None):
        raise ValueError("valid_h and valid_w are given together or not at all")
    return None if valid_h is None else (valid_h, valid_w)


_LIB = torch.library.Library("fast_srgan", "FRAGMENT")
_LIB.define("instance_norm_prelu(Tensor x, Tensor alpha, Tensor? valid_h=None,"
            " Tensor? valid_w=None) -> Tensor")
_LIB.define("instance_norm_add(Tensor x, Tensor skip, Tensor? valid_h=None,"
            " Tensor? valid_w=None) -> Tensor")


def _prelu_cpu(x, alpha, valid_h=None, valid_w=None):
    return instance_norm_prelu_reference(x, alpha, _join(valid_h, valid_w))


def _prelu_cuda(x, alpha, valid_h=None, valid_w=None):
    valid_hw = _join(valid_h, valid_w)
    check_kernel_inputs(x, alpha)
    check_valid_hw(x, valid_hw)
    return _launch(x, alpha, False, valid_hw)


def _add_cpu(x, skip, valid_h=None, valid_w=None):
    return instance_norm_add_reference(x, skip, _join(valid_h, valid_w))


def _add_cuda(x, skip, valid_h=None, valid_w=None):
    valid_hw = _join(valid_h, valid_w)
    check_add_inputs(x, skip)
    check_valid_hw(x, valid_hw)
    return _launch(x, skip, True, valid_hw)


def _fake(x, other, valid_h=None, valid_w=None):
    # the kernel writes x's shape, dtype and (channels_last) layout; the
    # plain version keeps x's layout
    return torch.empty_like(x)


_LIB.impl("instance_norm_prelu", _prelu_cpu, "CPU")
_LIB.impl("instance_norm_prelu", _prelu_cuda, "CUDA")
_LIB.impl("instance_norm_add", _add_cpu, "CPU")
_LIB.impl("instance_norm_add", _add_cuda, "CUDA")
torch.library.register_fake("fast_srgan::instance_norm_prelu", _fake, lib=_LIB)
torch.library.register_fake("fast_srgan::instance_norm_add", _fake, lib=_LIB)
_PRELU_OP = torch.ops.fast_srgan.instance_norm_prelu.default
_ADD_OP = torch.ops.fast_srgan.instance_norm_add.default


class InstanceNormPReLUFunction(torch.autograd.Function):
    """Forward through the op; backward differentiates the plain
    composition (the JAX package's ``_bwd`` does the same)."""

    @staticmethod
    def forward(ctx, x, alpha, valid_hw):
        ctx.save_for_backward(x, alpha)
        ctx.valid_hw = valid_hw
        return _PRELU_OP(x, alpha, *_split(valid_hw))

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            ad = alpha.detach().requires_grad_(True)
            y = instance_norm_prelu_reference(xd, ad, ctx.valid_hw)
        gx, ga = torch.autograd.grad(y, (xd, ad), grad)
        return gx, ga, None


class InstanceNormAddFunction(torch.autograd.Function):
    """Forward through the op; backward differentiates the plain
    composition ``instance_norm(x) + skip`` (the JAX package has no
    backward kernel for it either)."""

    @staticmethod
    def forward(ctx, x, skip, valid_hw):
        ctx.save_for_backward(x)
        ctx.valid_hw = valid_hw
        return _ADD_OP(x, skip, *_split(valid_hw))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        gx = None
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                xd = x.detach().requires_grad_(True)
                y = _norm(xd, ctx.valid_hw)
            (gx,) = torch.autograd.grad(y, xd, grad)
        return gx, grad, None


def instance_norm_prelu(
    x: torch.Tensor, alpha: torch.Tensor, valid_hw: ValidHW = None
) -> torch.Tensor:
    """Fused IN + PReLU of [B, C, H, W] x with a one-value slope; masked to
    each sample's valid region with ``valid_hw`` (int32 [B] tensors on x's
    device), 0 in the padding.

    ``instance_norm_prelu.launches`` counts the unmasked calls that launched
    the CUDA kernel family, ``masked_launches`` the masked ones (one a
    call, whichever form it took; a CUDA graph's capture counts once, its
    replays not). Without a gradient to record, the op is
    called directly: an ``autograd.Function`` adds host time to each call."""
    _check_device(x, "instance_norm_prelu")
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        return InstanceNormPReLUFunction.apply(x, alpha, valid_hw)
    return _PRELU_OP(x, alpha, *_split(valid_hw))


def instance_norm_add(
    x: torch.Tensor, skip: torch.Tensor, valid_hw: ValidHW = None
) -> torch.Tensor:
    """Fused ``instance_norm(x) + skip`` of [B, C, H, W] x and skip (on
    CUDA: the same shape, dtype and channels_last layout); masked to each
    sample's valid region with ``valid_hw``, skip in the padding.

    ``instance_norm_add.launches`` counts the unmasked calls that launched
    the CUDA kernel family, ``masked_launches`` the masked ones (one a
    call, whichever form it took; a CUDA graph's capture counts once, its
    replays not). Without a gradient to record, the op is
    called directly."""
    _check_device(x, "instance_norm_add")
    if torch.is_grad_enabled() and (x.requires_grad or skip.requires_grad):
        return InstanceNormAddFunction.apply(x, skip, valid_hw)
    return _ADD_OP(x, skip, *_split(valid_hw))


instance_norm_prelu.launches = 0
instance_norm_add.launches = 0
instance_norm_prelu.masked_launches = 0
instance_norm_add.masked_launches = 0


# -- the split form: statistics and normalize as two ops ----------------------
#
# The width-sharded forward (parallel/spatial.py) normalizes each shard of a
# frame with the statistics of the whole frame: every shard's statistics op
# writes its fp32 sums and sums of squares, [B, 1, 2C] (the per-shard term
# that ``_dist_instance_norm`` in fast_srgan_tpu/parallel/spatial.py psums,
# which XLA lowered on the TPU); the caller joins every shard's along dim 1,
# in shard order, on every shard; each shard's apply op adds those rows in
# row order and divides by the frame's pixel count (H x the sum of the shard
# widths), so every shard gets bitwise the same statistics.


def instance_norm_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`instance_norm_stats`: the fp32 sums and sums
    of squares of each sample over its pixels, [B, 1, 2C]."""
    b, c, h, w = x.shape
    x32 = x.float().permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
    return torch.cat([x32.sum(2), x32.square().sum(2)], dim=2)


def _norm_from_stats(x: torch.Tensor, partials: torch.Tensor, count: int) -> torch.Tensor:
    """x normalized with the sums of ``partials`` over ``count`` pixels:
    mean = s / count, var = max(ss / count - mean^2, 0) (``ops.norm``'s
    numerics), in x's dtype."""
    b, c = x.shape[:2]
    tot = partials.sum(dim=1)
    mean = (tot[:, :c] / count).view(b, c, 1, 1)
    var = (tot[:, c:].view(b, c, 1, 1) / count - mean.square()).clamp_min(0.0)
    return ((x.float() - mean) * torch.rsqrt(var + EPS)).to(x.dtype)


def instance_norm_prelu_from_stats_reference(
    x: torch.Tensor, alpha: torch.Tensor, partials: torch.Tensor, count: int
) -> torch.Tensor:
    """Plain version of :func:`instance_norm_prelu_from_stats`."""
    y = _norm_from_stats(x, partials, count)
    return torch.where(y >= 0, y, alpha.to(y.dtype) * y)


def instance_norm_add_from_stats_reference(
    x: torch.Tensor, skip: torch.Tensor, partials: torch.Tensor, count: int
) -> torch.Tensor:
    """Plain version of :func:`instance_norm_add_from_stats`."""
    return _norm_from_stats(x, partials, count) + skip


def check_partials(x: torch.Tensor, partials: torch.Tensor, count: int) -> None:
    """Raise ValueError unless the apply kernel takes ``partials`` and
    ``count`` for x."""
    b, c = x.shape[:2]
    if partials.dtype != torch.float32 or partials.dim() != 3 or partials.shape[0] != b \
            or partials.shape[2] != 2 * c or partials.shape[1] < 1:
        raise ValueError(f"partials must be fp32 [{b}, n >= 1, {2 * c}], got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if partials.device != x.device or not partials.is_contiguous():
        raise ValueError("partials must be contiguous on x's device")
    if not 1 <= count < 2**31:
        raise ValueError(f"unsupported count {count}")


def _launch_stats(x: torch.Tensor) -> torch.Tensor:
    from fast_srgan_torch.kernels._build import load_library

    _check_activation(x, "instance_norm_stats")
    lib = load_library()
    b, c, h, w = x.shape
    spans = launch_plan(x.shape)
    with torch.cuda.device(x.device):
        tiles = two_launch_tiles((b, c, h, w), x.element_size(), _sm_count(x.device))
        # one allocation (this op's host time is the tiled frame's): each
        # sample's totals, returned as a view, then the scratch of the
        # first (largest) chunk, each block's partial sums and each sample's
        # counter, which the chunks take in turn on the stream
        most = spans[0][1]
        buf = torch.empty(b * 2 * c + most * (tiles * 2 * c + 1), dtype=torch.float32,
                          device=x.device)
        fn = (lib.fsr_instance_norm_stats_bf16 if x.dtype == torch.bfloat16
              else lib.fsr_instance_norm_stats_f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for start, stop in spans:
            err = fn(rows(x, start, stop).data_ptr(), buf.data_ptr() + 4 * start * 2 * c,
                     buf.data_ptr() + 4 * b * 2 * c, stop - start, h * w, c, tiles, stream)
            if err:
                raise RuntimeError(f"instance_norm_stats launch failed: cudaError {err}")
    instance_norm_stats.launches += 1
    return buf.as_strided((b, 1, 2 * c), (2 * c, 2 * c, 1))


def _launch_from_stats(x, other, partials, count, residual: bool) -> torch.Tensor:
    from fast_srgan_torch.kernels._build import load_library

    if residual:
        check_add_inputs(x, other)
    else:
        check_kernel_inputs(x, other)
    check_partials(x, partials, count)
    lib = load_library()
    b, c, h, w = x.shape
    spans = launch_plan(x.shape)
    name = f"fsr_instance_norm_{'add' if residual else 'prelu'}_from_stats_"
    name += "bf16" if x.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, name)
    with torch.cuda.device(x.device):
        tiles = two_launch_tiles((b, c, h, w), x.element_size(), _sm_count(x.device))
        out = torch.empty_like(x, memory_format=torch.channels_last)
        second = other if residual else other.detach().reshape(1).to(torch.float32).contiguous()
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def launch(start: int, stop: int, out_part: torch.Tensor) -> None:
            other_part = rows(second, start, stop) if residual else second
            err = fn(rows(x, start, stop).data_ptr(), other_part.data_ptr(),
                     rows(partials, start, stop).data_ptr(), out_part.data_ptr(), stop - start,
                     h * w, c, partials.shape[1], count, tiles, EPS, stream)
            if err:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")

        over_chunks(spans, out, launch)
    counted = instance_norm_add_from_stats if residual else instance_norm_prelu_from_stats
    counted.launches += 1
    return out


def _stats_fake(x):
    return x.new_empty((x.shape[0], 1, 2 * x.shape[1]), dtype=torch.float32)


def _from_stats_fake(x, other, partials, count):
    return torch.empty_like(x)


_LIB.define("instance_norm_stats(Tensor x) -> Tensor")
_LIB.define("instance_norm_prelu_from_stats(Tensor x, Tensor alpha, Tensor partials,"
            " int count) -> Tensor")
_LIB.define("instance_norm_add_from_stats(Tensor x, Tensor skip, Tensor partials,"
            " int count) -> Tensor")
_LIB.impl("instance_norm_stats", instance_norm_stats_reference, "CPU")
_LIB.impl("instance_norm_stats", _launch_stats, "CUDA")
_LIB.impl("instance_norm_prelu_from_stats", instance_norm_prelu_from_stats_reference, "CPU")
_LIB.impl("instance_norm_prelu_from_stats",
          lambda x, alpha, partials, count: _launch_from_stats(x, alpha, partials, count, False),
          "CUDA")
_LIB.impl("instance_norm_add_from_stats", instance_norm_add_from_stats_reference, "CPU")
_LIB.impl("instance_norm_add_from_stats",
          lambda x, skip, partials, count: _launch_from_stats(x, skip, partials, count, True),
          "CUDA")
torch.library.register_fake("fast_srgan::instance_norm_stats", _stats_fake, lib=_LIB)
torch.library.register_fake("fast_srgan::instance_norm_prelu_from_stats", _from_stats_fake,
                            lib=_LIB)
torch.library.register_fake("fast_srgan::instance_norm_add_from_stats", _from_stats_fake,
                            lib=_LIB)
_STATS_OP = torch.ops.fast_srgan.instance_norm_stats.default
_PRELU_FROM_STATS_OP = torch.ops.fast_srgan.instance_norm_prelu_from_stats.default
_ADD_FROM_STATS_OP = torch.ops.fast_srgan.instance_norm_add_from_stats.default


def instance_norm_stats(x: torch.Tensor) -> torch.Tensor:
    """The split form's statistics of [B, C, H, W] x (on CUDA: bf16 or fp32,
    channels_last, the same C as the fused forms take): each sample's fp32
    sums and sums of squares, [B, 1, 2C] (one shard's term of a frame's
    statistics). Inference only (no gradient). ``instance_norm_stats.launches``
    counts the kernel's launches (a CUDA graph's capture once, its replays
    not)."""
    _check_device(x, "instance_norm_stats")
    return _STATS_OP(x)


def instance_norm_prelu_from_stats(
    x: torch.Tensor, alpha: torch.Tensor, partials: torch.Tensor, count: int
) -> torch.Tensor:
    """IN + PReLU of x with the statistics that ``partials`` ([B, n, 2C]
    fp32: n shards' :func:`instance_norm_stats` joined along dim 1, added in
    row order) sum over ``count`` pixels. ``.launches`` counts the kernel's
    launches (a CUDA graph's capture once, its replays not)."""
    _check_device(x, "instance_norm_prelu_from_stats")
    return _PRELU_FROM_STATS_OP(x, alpha, partials, int(count))


def instance_norm_add_from_stats(
    x: torch.Tensor, skip: torch.Tensor, partials: torch.Tensor, count: int
) -> torch.Tensor:
    """``instance_norm(x) + skip`` with the statistics of ``partials`` over
    ``count`` pixels (as :func:`instance_norm_prelu_from_stats`).
    ``.launches`` counts the kernel's launches (a CUDA graph's capture once,
    its replays not)."""
    _check_device(x, "instance_norm_add_from_stats")
    return _ADD_FROM_STATS_OP(x, skip, partials, int(count))


instance_norm_stats.launches = 0
instance_norm_prelu_from_stats.launches = 0
instance_norm_add_from_stats.launches = 0
