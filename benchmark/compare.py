"""Helpers the drivers share around the measured window: the device's memory
peak, freeing the program's state before the reference runs, and the
count-domain error of uint8 images against the reference's."""

from __future__ import annotations

import gc
import math
import re

import numpy as np
import torch

#: what a check reads when an answer is missing or of the wrong shape
MISSING = 1e30


def memory_peak(device: str) -> int:
    return int(torch.cuda.max_memory_allocated(torch.device(device))) if device != "cpu" else 0


def free(device: str) -> None:
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class CountError:
    """The error, in uint8 counts, of served images against the reference's,
    pooled over every pixel and channel added: ``rmse_counts``, and
    ``off<k>_pct``, the percentage of values k or more counts off (rounding
    in the compute type moves a truncated value by one or two counts; a
    coarser type spreads its noise past that)."""

    OFF = re.compile(r"^off(\d+)_pct$")

    def __init__(self):
        self.hist = np.zeros(256, np.int64)  # values by |served - reference|
        self.missing = 0

    def add(self, served, reference: torch.Tensor) -> None:
        ref = reference.cpu().numpy()
        if served is None or tuple(np.shape(served)) != ref.shape:
            self.missing += 1
            return
        diff = np.abs(np.asarray(served, np.int16) - ref.astype(np.int16))
        self.hist += np.bincount(diff.ravel(), minlength=256)

    def value(self, name: str) -> float:
        n = int(self.hist.sum())
        if self.missing or not n:
            return MISSING
        if name == "rmse_counts":
            return math.sqrt(float((self.hist * np.arange(256.0) ** 2).sum()) / n)
        k = int(self.OFF.match(name).group(1))
        return 100.0 * float(self.hist[k:].sum()) / n

    def readings(self, limits) -> dict:
        """(value, limit) of each number the cell's ``limits`` name."""
        return {k: (self.value(k), limit) for k, limit in limits.items()}
