"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over the
window's first ``trace_seconds`` (device activity only, so the host runs as
it does untraced), reduced to what the per-layer readers and the result's
``breakdown`` read.

The device's clock is tied to the host's by a marker: the profiler starts
on an idle device, a short spin kernel is launched at a host time taken
just before, and it is the slice's first device event. Idle gaps are then
labelled by the benchmark's host span that covers most of each.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

#: (name, start, end) of a device event, in seconds on the device's clock
Event = Tuple[str, float, float]


def _device_events(prof) -> List[Event]:
    from torch.autograd import DeviceType

    out: List[Event] = []
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is not None and hasattr(results, "events"):
        for e in results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() / 1e9, e.duration_ns() / 1e9
            else:
                s, d = e.start_us() / 1e6, e.duration_us() / 1e6
            out.append((e.name(), s, s + d))
        return out
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Tracer:
    def __init__(self, spans, slice_seconds: float):
        self.spans = spans
        self.slice_seconds = float(slice_seconds)
        self.prof = None
        self.t_mark: Optional[float] = None
        self.t_stop: Optional[float] = None
        #: host seconds the window stood still while the profiler stopped
        #: inside it (its records are collected on the host)
        self.paused_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(1000)

    def tick(self) -> None:
        if self.t_stop is None and self.t_mark is not None \
                and time.perf_counter() - self.t_mark >= self.slice_seconds:
            t = time.perf_counter()
            self.stop()
            self.paused_s = time.perf_counter() - t

    def stop(self) -> None:
        if self.prof is None or self.t_stop is not None:
            return
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def summary(self, top: int = 10) -> Optional[Dict[str, Any]]:
        """busy_s, window_s, the slice's device events (name, seconds), and
        the breakdown: the device operations with the most time and the
        longest idle gaps, each labelled by the host span open across it."""
        if self.prof is None:
            return None
        self.stop()
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        if not events:
            return None
        marker = events[0]
        window_s = self.t_stop - self.t_mark
        d0, d1 = marker[1], marker[1] + window_s
        offset = d0 - self.t_mark  # device clock minus host clock
        inside = [(n, max(s, d0), min(e, d1)) for n, s, e in events[1:] if e > d0 and s < d1]
        busy = union([(s, e) for _, s, e in inside])
        busy_s = sum(e - s for s, e in busy)
        by_name: Dict[str, float] = {}
        for n, s, e in inside:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        gaps, at = [], d0 + (marker[2] - marker[1])
        for s, e in busy + [(d1, d1)]:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "busy_s": busy_s,
            "window_s": window_s,
            "events": [(n, e - s) for n, s, e in inside],
            "breakdown": {
                "device_ops": [[n[:160], t] for n, t in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[self._label(s - offset, e - offset), e - s] for s, e in longest],
            },
        }

    def _label(self, h0: float, h1: float) -> str:
        best, best_overlap = "no span", 0.0
        for name, s, e in self.spans.items:
            overlap = min(e, h1) - max(s, h0)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        return best
