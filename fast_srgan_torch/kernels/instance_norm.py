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
* two launches (statistics, then normalize walking back), where a sample's
  tiles do not fit in the SMs' shared memory.

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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fast_srgan_torch.ops.norm import EPS, instance_norm, instance_norm_masked, valid_mask

#: (valid_h, valid_w): int32 [B] tensors, the valid region of each sample.
ValidHW = Optional[Tuple[torch.Tensor, torch.Tensor]]

#: Pixels per tile of the two-launch form (gridDim.x = ceil(H*W / TILE_PX)).
TILE_PX = 1024
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
    if b > 65535 or b * h * w * c >= 2**31 or b * h * w == 0:
        raise ValueError(f"unsupported size {tuple(x.shape)}")


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
    skip (residual add); ``valid_hw`` selects the masked form."""
    from fast_srgan_torch.kernels._build import load_library

    lib = load_library()
    b, c, h, w = x.shape
    hw = h * w
    with torch.cuda.device(x.device):
        found = plan((b, c, h, w), x.element_size(), _sm_count(x.device))
        if found is None:
            grid, per_wave, tile_px = 0, 0, TILE_PX
            scratch = b * ((hw + TILE_PX - 1) // TILE_PX) * 2 * c
        else:
            grid, per_wave, tile_px = found
            # 64-bit tagged words (zeroed ahead of the kernel): each tile's
            # partial sums, then each sample's totals
            scratch = 2 * b * (grid // per_wave + 1) * 2 * c
        out = torch.empty_like(x, memory_format=torch.channels_last)
        partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
        name = "fsr_instance_norm_" + ("add" if residual else "prelu")
        name += "_masked" if valid_hw is not None else ""
        name += "_bf16" if x.dtype == torch.bfloat16 else "_f32"
        fn = getattr(lib, name)
        second = other if residual else other.detach().reshape(1).to(torch.float32).contiguous()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if valid_hw is None:
            err = fn(x.data_ptr(), second.data_ptr(), out.data_ptr(), partial.data_ptr(),
                     b, hw, c, grid, per_wave, tile_px, EPS, stream)
        else:
            err = fn(x.data_ptr(), second.data_ptr(), valid_hw[0].data_ptr(),
                     valid_hw[1].data_ptr(), out.data_ptr(), partial.data_ptr(),
                     b, hw, w, c, grid, per_wave, tile_px, EPS, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
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
    call, whichever form it took). Without a gradient to record, the op is
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
    call, whichever form it took). Without a gradient to record, the op is
    called directly."""
    _check_device(x, "instance_norm_add")
    if torch.is_grad_enabled() and (x.requires_grad or skip.requires_grad):
        return InstanceNormAddFunction.apply(x, skip, valid_hw)
    return _ADD_OP(x, skip, *_split(valid_hw))


instance_norm_prelu.launches = 0
instance_norm_add.launches = 0
instance_norm_prelu.masked_launches = 0
instance_norm_add.masked_launches = 0
