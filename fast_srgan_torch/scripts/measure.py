"""What the measurement scripts share: the device a script runs on, the
card's name and power limit, a device timer and the closing JSON line.

A script runs on the card unless its caller asks for the CPU
(``--device cpu``); asked for the card where there is none, it exits with
an error and never moves to the CPU by itself. Times on the card come from
CUDA events (device time) or from the host clock around work that ends in
``torch.cuda.synchronize()`` (a request's or a step's time); on the CPU
both are the host clock, and the JSON line names the device it ran on.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Optional

import torch


def script_device(name: str) -> torch.device:
    """``torch.device(name)``; SystemExit for ``cuda`` without a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: torch.cuda.is_available() is False (no CUDA card);"
            " pass --device cpu to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device takes cuda or cpu, got {name!r}")
    return device


def card(device: torch.device) -> Optional[str]:
    """nvidia-smi's ``name, power.limit`` of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]


def device_kind(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` of the card, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ms_per_call(fn: Callable[[], object], iters: int, device: torch.device,
                warmup: int = 3) -> float:
    """Mean ms a call of ``fn()`` over ``iters`` back-to-back calls after
    ``warmup`` calls: CUDA events around them on the card (device time;
    the host runs ahead), the host clock to a synchronize on the CPU."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1000 * (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def runs_ms(fn: Callable[[], object], iters: int, device: torch.device,
            repeats: int = 3) -> list:
    """ms a call in each of ``repeats`` runs of ``iters`` back-to-back calls
    (one warm-up call before the first): their minimum is the best of
    ``repeats``, their range the run-to-run spread."""
    return [ms_per_call(fn, iters, device, warmup=1 if r == 0 else 0) for r in range(repeats)]


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory(device: torch.device) -> Optional[int]:
    """Bytes ``max_memory_allocated`` since the last reset on the card,
    None on the CPU."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def emit(result: dict, device: torch.device) -> dict:
    """Print ``result`` with the device's kind and the card's name and power
    limit as one JSON line, the script's last; returns it."""
    result = {**result, "device": device_kind(device), "card": card(device)}
    print(json.dumps(result), flush=True)
    return result
