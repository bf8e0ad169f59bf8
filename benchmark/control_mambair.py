"""Readings the MambaIR cell's limit of ``correct`` is set from, on the card at
the cell's own size (the benchmark's own runs never run this): the SwinIR
cell's machinery (``control_swinir``: each arm run through the harness's
``run_cell``, its window, its driver and its comparison against the cell's
limits) with MambaIR's arms in place of SwinIR's.

    python3 benchmark/control_mambair.py --workload mambair-x4-video-bf16 \\
        --seeds 1,2,3 --seconds 3 [--arm program|control:<kind>|fault:<name>|all] [--out FILE]

  * ``program``: the cell's runs as they are: the lower readings;
  * ``control:fp8``: the program with each VSSBlock's output, the residual
    stream, rounded to ``float8_e4m3fn`` and back: the precision below the
    configuration's bf16;
  * ``control:bf16_state``: the program with the scan's state rounded to
    bf16 after each update (the kernel's planted flag): what an fp32 state
    buys;
  * ``fault:<name>``: the timed path broken underneath (the workload's
    ``faults``): ``one_direction`` (order 0 alone: the other orders' C rows
    of the x projection and their D zero), ``no_carry`` (the state reset at
    each of the kernel's 32-step chunks), ``no_D`` (the D u skip of every
    scan zero), ``no_cab`` (the CAB branch dropped) and ``altered`` (one
    frame of each batch inverted where the engine produces it, in the
    forward that ``stream`` captures).

Prints one JSON line a seed and arm: ``correct``, each check's reading,
and the output's spread in counts and share clipped.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
from typing import Dict

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import control_swinir  # noqa: E402
from benchmark.control import patched  # noqa: E402


def _fp8_blocks(old):
    """Each block's output rounded to float8_e4m3fn and back."""
    def forward(self, x, *args):
        return old(self, x, *args).to(torch.float8_e4m3fn).to(x.dtype)
    return forward


def _prepared(change):
    """SS2D.prepare with ``change`` applied to what it prepares."""
    def make(old):
        def prepare(self):
            return change(self, *old(self))
        return prepare
    return make


def _order_0_alone(self, wx, dt_w, dt_b, a, ds):
    wx = wx.clone().view(4, -1, wx.shape[-1])
    wx[1:, self.dt_rank + self.d_state:] = 0
    ds = ds.clone()
    ds[1:] = 0
    return wx.view(-1, wx.shape[-1]), dt_w, dt_b, a, ds


def _no_d(self, wx, dt_w, dt_b, a, ds):
    return wx, dt_w, dt_b, a, torch.zeros_like(ds)


def _zero_cab(old):
    def forward(self, y):
        return torch.zeros_like(y)
    return forward


def arm_patches(arm: str) -> list:
    """(object, attribute, make) of each patch that puts ``arm`` in the
    program's place."""
    from fast_srgan_torch.inference import SRInferenceEngine
    from fast_srgan_torch.models import hat, mambair

    scan = importlib.import_module("fast_srgan_torch.kernels.selective_scan")
    return {
        "program": [],
        "control:fp8": [(mambair.VSSBlock, "forward", _fp8_blocks)],
        "control:bf16_state": [(scan, "STATE_BF16", lambda old: True)],
        "fault:one_direction": [(mambair.SS2D, "prepare", _prepared(_order_0_alone))],
        "fault:no_carry": [(scan, "CARRY", lambda old: False)],
        "fault:no_D": [(mambair.SS2D, "prepare", _prepared(_no_d))],
        "fault:no_cab": [(hat.CAB, "forward", _zero_cab)],
        "fault:altered": [(SRInferenceEngine, "_forward_u8", control_swinir._altered)],
    }[arm]


@contextlib.contextmanager
def _mambair_arms():
    with patched(control_swinir, "arm_patches", lambda old: arm_patches):
        yield


def reading(name: str, seed: int, seconds: float, arm: str, device: str = "cuda",
            overrides=None) -> Dict:
    """``control_swinir.reading`` with MambaIR's arms."""
    with _mambair_arms():
        return control_swinir.reading(name, seed, seconds, arm, device, overrides)


def main(argv=None) -> int:
    with _mambair_arms():
        return control_swinir.main(argv)


if __name__ == "__main__":
    sys.exit(main())
