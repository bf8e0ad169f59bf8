"""Readings the HAT cell's limit of ``correct`` is set from, on the card at the
cell's own size (the benchmark's own runs never run this): the SwinIR
cell's machinery (``control_swinir``: each arm run through the harness's
``run_cell``, its window, its driver and its comparison against the cell's
limits) with HAT's arms in place of SwinIR's.

    python3 benchmark/control_hat.py --workload hat-x4-video-bf16 \\
        --seeds 1,2,3 --seconds 3 [--arm program|control:fp8|fault:<name>|all] [--out FILE]

  * ``program``: the cell's runs as they are: the lower readings;
  * ``control:fp8``: the program with each HAB's and OCAB's output, the
    residual stream, rounded to ``float8_e4m3fn`` and back: the precision
    below the configuration's bf16;
  * ``fault:<name>``: the timed path broken underneath (the workload's
    ``faults``): ``no_shift_mask`` (the shifted HABs' masks built without
    the shift mask), ``no_rel_bias`` (every HAB's and OCAB's
    relative-position bias zero), ``no_cab`` (the CAB branch dropped),
    ``oca_pad_masked`` (the OCAs' zero keys outside the map masked out
    instead of attended) and ``altered`` (one frame of each batch inverted
    where the engine produces it, in the forward that ``stream`` captures).

Prints one JSON line a seed and arm: ``correct``, each check's reading,
and the output's spread in counts and share clipped.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
from typing import Dict

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import control_swinir  # noqa: E402
from benchmark.control import patched  # noqa: E402


def _zero_bias(old):
    def bias(*args, **kwargs):
        return torch.zeros_like(old(*args, **kwargs))
    return bias


def _fp8_blocks(old):
    """Each block's output rounded to float8_e4m3fn and back."""
    def forward(self, x, *args):
        return old(self, x, *args).to(torch.float8_e4m3fn).to(x.dtype)
    return forward


def _pad_masked(old):
    """SDPA (which only the OCAs call) with the keys that are zero in every
    value of a head, the padding outside the map, masked out."""
    def sdpa(q, k, v, attn_mask=None, **kwargs):
        pad = (k == 0).all(-1)[:, :, None, :]
        mask = torch.zeros(pad.shape, dtype=q.dtype, device=q.device).masked_fill(pad, -math.inf)
        return old(q, k, v, attn_mask=attn_mask + mask, **kwargs)
    return sdpa


def arm_patches(arm: str) -> list:
    """(object, attribute, make) of each patch that puts ``arm`` in the
    program's place."""
    import torch.nn.functional as F

    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.models import hat, swinir

    return {
        "program": [],
        "control:fp8": [(hat.HAB, "forward", _fp8_blocks), (hat.OCAB, "forward", _fp8_blocks)],
        "fault:no_shift_mask": [(swinir, "shift_mask", control_swinir._no_shift_mask)],
        "fault:no_rel_bias": [(swinir, "relative_position_bias", _zero_bias),
                              (hat, "oca_bias", _zero_bias)],
        "fault:no_cab": [(hat, "CONV_SCALE", lambda old: 0.0)],
        "fault:oca_pad_masked": [(F, "scaled_dot_product_attention", _pad_masked)],
        "fault:altered": [(SRInferenceEngine, "_forward_u8", control_swinir._altered)],
    }[arm]


@contextlib.contextmanager
def _hat_arms():
    with patched(control_swinir, "arm_patches", lambda old: arm_patches):
        yield


def reading(name: str, seed: int, seconds: float, arm: str, device: str = "cuda",
            overrides=None) -> Dict:
    """``control_swinir.reading`` with HAT's arms."""
    with _hat_arms():
        return control_swinir.reading(name, seed, seconds, arm, device, overrides)


def main(argv=None) -> int:
    with _hat_arms():
        return control_swinir.main(argv)


if __name__ == "__main__":
    sys.exit(main())
