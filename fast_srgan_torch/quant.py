"""Int8 post-training-quantized inference tier.

The port of ``fast_srgan_tpu/quant.py``. Static PTQ, shaped to this network:

  * weights per-output-channel symmetric int8 (exact zero stays zero, so the
    LR tail's rearranged kernels scatter int8 values into int8 zeros);
  * activations per-tensor int8 at calibrated static scales: the 99.99th
    percentile of each conv input's |x| over sample batches
    (:func:`calibrate_scales`);
  * everything between convs in the glue dtype (bf16 by default): bias,
    PReLU, instance norm, pixel shuffle; tanh in fp32;
  * the upsampling tail in its LR-domain form (``ops/lr_tail.py``), with the
    int8 kernels rearranged by the same dtype-generic functions.

Four modes choose what quantizes (``MODES``): ``ups`` (the upsampling
stages; the JAX package's production tier, ``SRInferenceEngine(quantize=
True)``), ``tail`` (stages and head), ``full`` and ``trunk``. Which mode is
fastest was measured on a TPU; on the H100 it is an open measurement.

On the card each int8 conv is ``kernels/int8_conv.py`` (CUDA C++,
s8 x s8 -> s32 on the tensor cores) and each activation quantization
``kernels/quantize.py``; on the CPU their plain versions run, which are
bitwise the same function. The float trunk of the ``ups``/``tail`` modes is
the port's ``Generator.trunk`` (with the IN+PReLU kernel).

Weights are prepared once, when they load (:func:`prepare_generator`): int8
kernels packed in the layout the conv kernel reads, the four int8 phase
kernels of stage 2, the dense head kernel, the per-channel dequant scales
mapped through the same channel packing. The JAX package rebuilds these in
every call only because its params are jit inputs. Activations are NCHW
tensors in channels_last memory, as everywhere in the port.

The masked int8 forward of a zero-padded (bucketed) batch
(:func:`sr_quant_forward_masked`) runs the masked float trunk
(``Generator.trunk(x, valid_hw)``), so it takes the ``ups`` and ``tail``
modes only, then the int8 tail with its padding re-zeroed after each stage:
a masked zero quantizes to int8 zero, so the int8 convs see the zeros the
unpadded forward's conv padding gives.

The float form of the same executor (:func:`sr_float_forward`) is the
calibration instrument and the topology oracle: tests hold it to the JAX
function and to ``generator_apply_lr_tail``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fast_srgan_torch.kernels.instance_norm import instance_norm_add, instance_norm_prelu
from fast_srgan_torch.kernels.int8_conv import (
    bias_prelu,
    int8_conv,
    int8_conv_phases,
    pack_int8_phases,
    pack_int8_weight,
)
from fast_srgan_torch.kernels.quantize import quantize_act
from fast_srgan_torch.ops.lr_tail import (
    _head_kernel_2x,
    _head_kernel_4x,
    _masked,
    _phase_kernels_2x,
    _phase_outputs,
    _prepared,
    _summed_head,
    mask_2x,
)
from fast_srgan_torch.ops.norm import valid_mask
from fast_srgan_torch.ops.precision import cudnn_without_tf32

# -- weight quantization ------------------------------------------------------

_TRUNK_MODULES = ("neck_conv", "bottleneck_conv")


def is_trunk_module(name: str) -> bool:
    """Trunk = neck + residual stems + bottleneck (the IN-glued body)."""
    return name in _TRUNK_MODULES or name.startswith("stem_")


def is_tail_module(name: str) -> bool:
    """Tail = the LR-domain upsampling stages + head (wide, no IN)."""
    return name.startswith("upsampling_") or name == "head_conv"


def is_ups_module(name: str) -> bool:
    """Upsampling stages only (the tail minus the head conv)."""
    return name.startswith("upsampling_")


#: ``SRInferenceEngine(quantize=...)`` modes -> the modules each quantizes
#: (None: all of them).
MODES: Dict[str, Optional[Callable[[str], bool]]] = {
    "ups": is_ups_module,
    "tail": is_tail_module,
    "full": None,
    "trunk": is_trunk_module,
}


def _quantize_kernel(k: Any) -> Tuple[np.ndarray, np.ndarray]:
    """[kh,kw,ci,co] fp32 -> (int8 kernel, fp32 dequant scale [co]).

    Symmetric per-output-channel: q = round(k / s), s = max|k|_co / 127,
    computed in fp32."""
    k = torch.from_numpy(np.array(k, dtype=np.float32))
    amax = k.abs().amax(dim=(0, 1, 2))
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(k / scale).clamp_(-127, 127).to(torch.int8)
    return q.numpy(), scale.numpy()


def _quantize_leaf(leaf: Dict[str, Any]) -> Dict[str, Any]:
    q, s = _quantize_kernel(leaf["kernel"])
    out = {"qkernel": q, "wscale": s}
    if "bias" in leaf:
        out["bias"] = np.asarray(leaf["bias"], np.float32)
    return out


def quantize_generator_params(params: Dict[str, Any], only=None) -> Dict[str, Any]:
    """Generator param tree (numpy leaves) -> quantized tree, same topology.

    Each conv leaf ``{"kernel", ["bias"]}`` becomes ``{"qkernel": int8,
    "wscale": f32[co], ["bias"]}``; PReLU alphas pass through. Accepts the
    tree with or without the ``{"params": ...}`` wrapper and returns the bare
    tree. ``only`` (a predicate on the top-level module name) selects which
    modules quantize; the rest keep their float leaves."""
    p = params["params"] if "params" in params else params
    out: Dict[str, Any] = {}
    for name, sub in p.items():
        if (only is not None and not only(str(name))) or str(name).endswith("relu"):
            out[name] = sub
        elif "kernel" in sub:  # neck_conv, bottleneck_conv, head_conv
            out[name] = _quantize_leaf(sub)
        else:  # stem_i / upsampling_i: nested convs + relu alphas
            out[name] = {
                k: _quantize_leaf(leaf) if "kernel" in leaf else leaf
                for k, leaf in sub.items()
            }
    return out


# -- weights prepared once ----------------------------------------------------


@dataclasses.dataclass
class PreparedGenerator:
    """A generator param tree prepared for the executor on one device.

    ``layers`` maps the executor's conv names (``neck``, ``stem_{i}_c1``,
    ``stem_{i}_c2``, ``bottleneck``, ``up{j}``, ``head``) to a float conv
    (``w``: OIHW channels_last in the glue dtype) or an int8 one (``q``:
    :class:`~fast_srgan_torch.kernels.int8_conv.Int8Weight`, ``ws``: fp32
    dequant scales), with ``b``/``a`` (bias, PReLU slope in the glue dtype)
    where the conv's epilogue applies them. The stage-2 entry holds the four
    phase kernels (``phases`` float, ``phases_q`` an
    :class:`~fast_srgan_torch.kernels.int8_conv.Int8Phases`); a float 4x head
    also holds its four per-phase ``parts``; ``b32`` is the 4x head's fp32
    bias. ``trunk`` is the float ``Generator.trunk`` of the ``ups``/``tail``
    modes, whose plans then hold no trunk layers."""

    mode: Optional[str]
    scale_factor: int
    n_layers: int
    glue: torch.dtype
    device: torch.device
    layers: Dict[str, Dict[str, Any]]
    trunk: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def prepare_generator(
    params: Dict[str, Any],
    mode: Optional[str] = None,
    glue_dtype: torch.dtype = torch.float32,
    device: Any = "cuda",
    model=None,
) -> PreparedGenerator:
    """Prepare a float generator param tree (numpy leaves) for the executor.

    ``mode`` None keeps every conv float (the form :func:`sr_float_forward`
    and :func:`calibrate_scales` take); otherwise one of :data:`MODES`,
    quantized by :func:`quantize_generator_params`. ``model`` is the float
    ``Generator`` (in ``glue_dtype`` on ``device``) whose trunk the ``ups``
    and ``tail`` modes run; it is built from ``params`` when not given.
    ``device`` is the card unless the caller asks for ``"cpu"``."""
    if mode is not None and mode not in MODES:
        raise ValueError(f"quantize must be True/'tail'/'ups'/'full'/'trunk': {mode!r}")
    p = params["params"] if "params" in params else params
    if mode is not None:
        p = quantize_generator_params(p, only=MODES[mode])
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    glue = glue_dtype
    n_layers = sum(1 for k in p if str(k).startswith("stem_"))
    n_up = sum(1 for k in p if str(k).startswith("upsampling_"))
    scale = 2**n_up
    if scale not in (2, 4, 8):
        raise ValueError(f"scale_factor must be 2, 4, or 8: {scale}")

    def vec(v, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(device=dev, dtype=dtype)

    def kernel(leaf) -> torch.Tensor:
        """The leaf's HWIO kernel: int8 where quantized, else fp32."""
        if "qkernel" in leaf:
            return torch.from_numpy(np.array(leaf["qkernel"], dtype=np.int8))
        return torch.from_numpy(np.array(leaf["kernel"], dtype=np.float32))

    def weight(k: torch.Tensor):
        return pack_int8_weight(k, dev) if k.dtype == torch.int8 else _prepared(k, glue, dev)

    def conv(leaf, k=None, ws_repeat=1) -> Dict[str, Any]:
        """A conv entry; ``k`` is the leaf's kernel rearranged, if it is."""
        k = kernel(leaf) if k is None else k
        if k.dtype != torch.int8:
            return {"w": weight(k)}
        ws = vec(leaf["wscale"], torch.float32).repeat_interleave(ws_repeat)
        return {"q": weight(k), "ws": ws}

    def epilogue(leaf, relu) -> Dict[str, torch.Tensor]:
        return {"b": vec(leaf["bias"], glue), "a": vec(relu["alpha"], glue)}

    lay: Dict[str, Dict[str, Any]] = {}
    trunk = None
    if mode in ("ups", "tail"):
        if model is None:
            model = _float_generator(params, glue, dev)
        trunk = model.trunk
    else:
        lay["neck"] = {**conv(p["neck_conv"]), **epilogue(p["neck_conv"], p["neck_relu"])}
        lay["bottleneck"] = conv(p["bottleneck_conv"])
        for i in range(n_layers):
            blk = p[f"stem_{i}"]
            lay[f"stem_{i}_c1"] = {
                **conv(blk["conv1"]), "norm_a": vec(blk["relu1"]["alpha"], glue)
            }
            lay[f"stem_{i}_c2"] = conv(blk["conv2"])
    for j in range(n_up):
        up = p[f"upsampling_{j}"]
        entry = epilogue(up["conv"], up["relu"])
        if scale > 2 and j == n_up - 1:  # stage 2 of the 4x transform: phases
            phases = _phase_kernels_2x(kernel(up["conv"])).items()
            if "qkernel" in up["conv"]:
                entry["phases_q"] = pack_int8_phases([(pq, weight(kp)) for pq, kp in phases])
                entry["ws"] = vec(up["conv"]["wscale"], torch.float32)
            else:
                entry["phases"] = [(pq, weight(kp)) for pq, kp in phases]
        else:
            entry.update(conv(up["conv"]))
        lay[f"up{j}"] = entry
    head = p["head_conv"]
    if scale == 2:
        lay["head"] = {
            **conv(head, _head_kernel_2x(kernel(head)), 4),
            "b": vec(head["bias"], torch.float32).repeat_interleave(4).to(glue),
        }
    else:
        kd = _head_kernel_4x(kernel(head))
        entry = conv(head, kd, 16)
        entry["b32"] = vec(head["bias"], torch.float32).repeat_interleave(16)
        if "w" in entry:  # a float head also runs phase-summed
            f4 = kd.shape[2] // 4
            entry["parts"] = [weight(kd[:, :, i * f4:(i + 1) * f4, :]) for i in range(4)]
        lay["head"] = entry
    return PreparedGenerator(mode, scale, n_layers, glue, dev, lay, trunk)


def _float_generator(params, dtype, device):
    from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
    from fast_srgan_torch.inference import arch_from_params
    from fast_srgan_torch.models.generator import Generator

    model = Generator(**arch_from_params(params))
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


# -- the executor -------------------------------------------------------------
#
# One topology, three uses: float calibration (records a statistic of each
# conv input), float oracle (must equal the canonical generator + LR tail),
# and the int8 serving path. Each conv dispatches on its prepared leaf.


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` of all elements of x (linear interpolation),
    on x's device, as a 0-d fp32 tensor.

    The position ``q/100 * (n-1)`` is formed in fp32, as JAX forms it; the
    two order statistics around it come from one ``torch.topk`` of the
    nearer tail (``torch.quantile`` refuses more than 2^24 elements, and a
    full sort is not needed)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    pos = (np.float32(q) / np.float32(100)) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = np.float32(1) - hw
    low = int(min(max(low, np.float32(0)), np.float32(n - 1)))
    high = int(min(max(high, np.float32(0)), np.float32(n - 1)))
    if n - low <= high + 1:  # the upper tail is the smaller
        top = torch.topk(flat, n - low, largest=True, sorted=True).values
        v_low, v_high = top[n - 1 - low], top[n - 1 - high]
    else:
        bottom = torch.topk(flat, high + 1, largest=False, sorted=True).values
        v_low, v_high = bottom[low], bottom[high]
    return v_low * float(lw) + v_high * float(hw)


class _Exec:
    """Conv executor: float (optionally collecting calibration statistics)
    or int8, chosen by the prepared leaf's form."""

    def __init__(self, scales, collect, glue, collect_q=None):
        self.scales = scales
        self.collect = collect
        self.glue = glue
        self.collect_q = collect_q  # None = max-abs; else |x| percentile

    def observe(self, name: str, x: torch.Tensor) -> None:
        if self.collect is None:
            return
        ax = x.to(torch.float32).abs()
        m = ax.amax() if self.collect_q is None else percentile(ax, self.collect_q)
        prev = self.collect.get(name)
        self.collect[name] = m if prev is None else torch.maximum(prev, m)

    def qin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Quantize a conv input once (the four phases share it)."""
        self.observe(name, x)
        return quantize_act(x.contiguous(memory_format=torch.channels_last), self.scales[name])

    def conv(
        self, x: torch.Tensor, name: str, leaf: Dict[str, Any], quantize_for=None,
        halo: bool = False,
    ) -> torch.Tensor:
        """3x3 pad-1 conv of a prepared leaf, then its bias and PReLU where
        it has them, each rounded to the glue dtype (quant.py's order).
        ``quantize_for`` (an int8 conv's name) returns that conv's int8
        input instead, quantized in an int8 conv's epilogue. ``halo``: x is
        a width shard extended by its neighbours' columns
        (``parallel/spatial.py``), so no zero column pads it left or right
        and the output is two columns narrower."""
        bias, alpha = leaf.get("b"), leaf.get("a")
        out_scale = None if quantize_for is None else self.scales[quantize_for]
        if "q" in leaf:
            return int8_conv(self.qin(name, x), leaf["q"], leaf["ws"], self.scales[name],
                             (1, 0, 0) if halo else (1, 1), bias, alpha, self.glue, out_scale)
        self.observe(name, x)
        y = bias_prelu(F.conv2d(x, leaf["w"], padding=(1, 0) if halo else 1), bias, alpha)
        return y if quantize_for is None else self.qin(quantize_for, y)


def _trunk(lay, ex: _Exec, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    r = ex.conv(x, "neck", lay["neck"])
    y = r
    for i in range(n_layers):
        c1 = lay[f"stem_{i}_c1"]
        h = instance_norm_prelu(ex.conv(y, f"stem_{i}_c1", c1), c1["norm_a"])
        y = instance_norm_add(ex.conv(h, f"stem_{i}_c2", lay[f"stem_{i}_c2"]), y)
    return instance_norm_add(ex.conv(y, "bottleneck", lay["bottleneck"]), r)


def _tail_4x(lay, ex: _Exec, y: torch.Tensor, n0: str = "up0", n1: str = "up1",
             mask: Optional[torch.Tensor] = None):
    """The 4x LR-domain tail. An int8 stage 2 takes its input quantized in
    stage 1's epilogue and runs its four phases in one launch. The head is
    phase-summed with fp32 partials when it is float and nothing is
    collecting; calibration and an int8 head take the 16F phase concat
    (per-conv-input statistics are defined on it). ``mask`` re-zeroes the
    padding of stage 1's output (in int8, after its epilogue's quantize)
    and of each phase."""
    st = lay[n1]
    if "phases_q" in st:  # a quantized plan: nothing collects
        a1q = _masked(ex.conv(y, n0, lay[n0], quantize_for=n1), mask)  # [B, 4F, H, W] int8
        phases = int8_conv_phases(
            a1q, st["phases_q"], st["ws"], ex.scales[n1], st["b"], st["a"], ex.glue
        )
    else:
        a1 = _masked(ex.conv(y, n0, lay[n0]), mask)  # [B, 4F, H, W], bias and PReLU applied
        ex.observe(n1, a1)
        phases = _phase_outputs(a1, st["phases"], st["b"], st["a"])
    phases = [_masked(ph, mask) for ph in phases]
    head = lay["head"]
    if "parts" in head and ex.collect is None:
        z = _summed_head(phases, head["parts"], head["b32"])
    else:
        a2 = torch.cat(phases, dim=1).contiguous(memory_format=torch.channels_last)
        z = ex.conv(a2, "head", head).float() + head["b32"].view(1, -1, 1, 1)
    return F.pixel_shuffle(torch.tanh(z), 4)


def _tail_2x(lay, ex: _Exec, y: torch.Tensor, mask=None) -> torch.Tensor:
    a1 = _masked(ex.conv(y, "up0", lay["up0"]), mask)
    z = ex.conv(a1, "head", lay["head"])  # + the repeated bias, in glue
    return F.pixel_shuffle(torch.tanh(z.float()), 2)


def _tail_8x(lay, ex: _Exec, y: torch.Tensor, mask=None) -> torch.Tensor:
    """Stage 0 canonical (the one-slope PReLU commutes with the shuffle),
    then the 4x transform at 2x resolution with the stage names shifted
    (masked: the LR mask before the shuffle, then the 2x mask)."""
    y2 = F.pixel_shuffle(_masked(ex.conv(y, "up0", lay["up0"]), mask), 2)
    return _tail_4x(lay, ex, y2.contiguous(memory_format=torch.channels_last), "up1", "up2",
                    None if mask is None else mask_2x(mask))


_TAILS = {2: _tail_2x, 4: _tail_4x, 8: _tail_8x}


def _forward(plan: PreparedGenerator, ex: _Exec, x: torch.Tensor) -> torch.Tensor:
    if plan.trunk is not None:
        y = plan.trunk(x)
    else:
        y = _trunk(plan.layers, ex, x, plan.n_layers)
    return _TAILS[plan.scale_factor](plan.layers, ex, y)


# -- public entry points ------------------------------------------------------


def sr_float_forward(
    plan: PreparedGenerator,
    x: torch.Tensor,
    collect: Optional[Dict[str, torch.Tensor]] = None,
    collect_q: Optional[float] = None,
) -> torch.Tensor:
    """Float forward of the quantized tier's topology (fp32 glue): [B, 3, H,
    W] in [-1, 1] -> [B, 3, sH, sW] fp32. ``plan`` is ``prepare_generator(
    params)`` (mode None, fp32). ``collect`` (a mutable dict) receives each
    conv input's max |x|, or its ``collect_q``-th percentile when given."""
    if plan.mode is not None or plan.glue != torch.float32:
        raise ValueError("sr_float_forward takes prepare_generator(params) in fp32")
    ex = _Exec(None, collect, torch.float32, collect_q)
    return _forward(plan, ex, x.to(torch.float32))


def sr_quant_forward(
    plan: PreparedGenerator, act_scales: Dict[str, torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """Int8 forward: [B, 3, H, W] in [-1, 1] -> [B, 3, sH, sW] fp32 in
    [-1, 1]. ``plan`` is ``prepare_generator(params, mode, glue_dtype)``;
    ``act_scales`` are :func:`calibrate_scales`' (one-value fp32 tensors on
    the plan's device)."""
    if plan.mode is None:
        raise ValueError("sr_quant_forward takes a plan prepared with a mode")
    ex = _Exec(act_scales, None, plan.glue)
    return _forward(plan, ex, x.to(plan.glue))


def sr_quant_forward_masked(
    plan: PreparedGenerator,
    act_scales: Dict[str, torch.Tensor],
    x: torch.Tensor,
    valid_hw: Tuple[torch.Tensor, torch.Tensor],
) -> torch.Tensor:
    """Masked (bucketed-exact) int8 forward of a zero-padded batch: the
    masked float trunk, then the int8 tail with the padding re-zeroed.
    ``valid_hw`` is (valid_h, valid_w), int32 [B] tensors on the plan's
    device. Raises for the ``full`` and ``trunk`` modes: the masked norms'
    per-sample statistics run on the float trunk only."""
    if plan.mode is None:
        raise ValueError("sr_quant_forward_masked takes a plan prepared with a mode")
    if plan.trunk is None:
        raise ValueError(
            f"masked int8 requires a float trunk (the ups/tail modes), not {plan.mode!r}:"
            " the per-sample masked instance-norm statistics are float-path only"
        )
    y = plan.trunk(x.to(plan.glue), valid_hw)
    mask = valid_mask(y.shape[2], y.shape[3], *valid_hw)[0]
    ex = _Exec(act_scales, None, plan.glue)
    return _TAILS[plan.scale_factor](plan.layers, ex, y, mask=mask)


def default_calibration_batch(
    h: int = 180, w: int = 320, n: int = 4, seed: int = 0
) -> np.ndarray:
    """Synthetic natural-image-statistics calibration batch ([-1, 1] NHWC
    fp32): smooth gradients, hard edges and texture noise, for a caller with
    no sample inputs. The same arrays as the JAX package's function."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for i in range(n):
        grad = np.sin(yy / (8 + 13 * i) + i) * np.cos(xx / (11 + 7 * i))
        edges = np.sign(np.sin(yy / (3 + 2 * i)) * np.sin(xx / (5 + 3 * i)))
        noise = rng.standard_normal((h, w)).astype(np.float32)
        base = 0.55 * grad + 0.3 * edges + 0.15 * noise
        chans = [
            np.clip(base + 0.1 * rng.standard_normal((h, w)), -1, 1)
            for _ in range(3)
        ]
        imgs.append(np.stack(chans, -1).astype(np.float32))
    return np.stack(imgs)


def calibration_batch_from_images(
    images: Iterable[Any], k: int = 8, max_h: int = 180, max_w: int = 320
) -> Optional[np.ndarray]:
    """ONE calibration batch from sample uint8 HWC images: center crops of up
    to ``k`` of them at one common shape (the smallest, capped at max_h x
    max_w), mapped to [-1, 1]. Images under 32x32 or with fewer than 3
    channels are skipped (RGBA is sliced to RGB); None if none is usable."""
    picked: List[np.ndarray] = []
    for im in images:
        im = np.asarray(im)
        if im.ndim != 3 or im.shape[0] < 32 or im.shape[1] < 32 or im.shape[2] < 3:
            continue
        picked.append(im)
        if len(picked) == k:
            break
    if not picked:
        return None
    ch = min(max_h, min(im.shape[0] for im in picked))
    cw = min(max_w, min(im.shape[1] for im in picked))
    crops = []
    for im in picked:
        y0 = (im.shape[0] - ch) // 2
        x0 = (im.shape[1] - cw) // 2
        crop = im[y0:y0 + ch, x0:x0 + cw, :3].astype(np.float32)
        crops.append(crop / 127.5 - 1.0)
    return np.stack(crops)


DEFAULT_PERCENTILE = 99.99
"""Production activation-calibration percentile (the JAX package's measured
optimum: clipping the top 0.01% of |activation| buys finer int8 resolution
below the clip)."""


def calibrate_scales(
    plan: PreparedGenerator,
    batches: Iterable[Any],
    margin: float = 1.0,
    percentile: Optional[float] = DEFAULT_PERCENTILE,
) -> Dict[str, torch.Tensor]:
    """Per-conv-input activation scales: the ``percentile``-th percentile of
    |x| (None: the max) over the float forward of each batch ([-1, 1] float
    NHWC, or uint8 HWC/NHWC), the max across batches, times ``margin``, at
    least 1e-6. ``plan`` is ``prepare_generator(params)`` (fp32) on the
    device to calibrate on; the forward runs with TF32 off."""
    agg: Dict[str, torch.Tensor] = {}
    n = 0
    with torch.no_grad(), cudnn_without_tf32():
        for b in batches:
            t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(b))
            t = t.to(plan.device)
            if t.dtype == torch.uint8:
                t = t.to(torch.float32) / 127.5 - 1.0
            if t.dim() == 3:
                t = t[None]
            stats: Dict[str, torch.Tensor] = {}
            sr_float_forward(plan, t.permute(0, 3, 1, 2), stats, percentile)
            for k, v in stats.items():
                agg[k] = v if k not in agg else torch.maximum(agg[k], v)
            n += 1
    if n == 0:
        raise ValueError("calibrate_scales needs at least one batch")
    return {k: torch.clamp_min(v.to(torch.float32) * margin, 1e-6) for k, v in agg.items()}
