"""The per-layer metrics read from the program's own host spans
(``fast_srgan_torch.utils.spans``), which record while the traced slice's
profiler runs. Each ``metrics/<name>.py`` binds one of the readers below.

The spans are on the host's ``time.perf_counter``. The slice's marker ties
that clock to the device's as ``trace.Tracer.summary`` does: the slice is
[t_mark, t_stop] on the host and [d0, d0 + (t_stop - t_mark)] on the
device, d0 being the marker's start, so a host time h is device time
h + (d0 - t_mark). The device's idle time is the slice less the union of
its events after the marker, as ``device_idle_share`` reads it.

A span is read where it starts in the slice, and up to the slice's end
(the caller's span that holds the profiler's stop runs on past it).

- ``engine_host_ms``: the host's own ms a batch inside ``stream``: the
  ``stream.stage``, ``stream.enqueue`` and ``stream.copy`` spans ÷ the
  ``stream.enqueue`` spans. Waiting on the device and the caller's time are
  left out.
- ``forward_enqueue_ms``: the ``engine.forward`` spans' mean ms (the host's
  dispatch of one generator forward).
- ``engine_idle_share``: the share of the slice, in percent, in which the
  device was idle and the host inside ``stream.gather``, ``stream.stage``,
  ``stream.enqueue`` or ``stream.copy``. At most ``device_idle_share``.

Each traced run prints one table on stderr: for each span name its count,
mean and p90 ms, and the device's idle ms under it (the innermost span
open over each idle instant takes it), then the idle under no span and the
share of the slice's host time under some span. A program without the
spans module, or with no span in the slice, reads None.
"""

from __future__ import annotations

import heapq
import statistics
import sys
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark.trace import _device_events, union

HOST_STEPS = ("stream.stage", "stream.enqueue", "stream.copy")
PIPELINE = ("stream.gather",) + HOST_STEPS
FORWARD = "engine.forward"

Interval = Tuple[float, float]
#: (name, start, end) of a span on the device's clock
Mapped = Tuple[str, float, float]

_ANALYSES: "weakref.WeakKeyDictionary[Any, Optional[Dict[str, Any]]]" = weakref.WeakKeyDictionary()


def gaps(busy: Sequence[Interval], d0: float, d1: float) -> List[Interval]:
    """[d0, d1] less the sorted disjoint ``busy`` intervals."""
    out, at = [], d0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, d1)))
        at = max(at, e)
        if at >= d1:
            break
    if d1 > at:
        out.append((at, d1))
    return out


def innermost(spans: Iterable[Mapped]) -> List[Tuple[float, float, str]]:
    """The union of the spans as disjoint sorted pieces (start, end, name),
    each named by the innermost span open over it: the one that started
    last, and of two that started together the shorter."""
    order = sorted(spans, key=lambda sp: sp[1])
    points = sorted({p for _, s, e in order for p in (s, e)})
    heap: list = []
    out: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in zip(points, points[1:]):
        while i < len(order) and order[i][1] <= a:
            name, s, e = order[i]
            heapq.heappush(heap, (-s, e, i, name))
            i += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        if heap:
            out.append((a, b, heap[0][3]))
    return out


def overlap(xs: Sequence[Interval], pieces: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of the sorted disjoint ``xs`` under each name of the sorted
    disjoint named ``pieces``."""
    out: Dict[str, float] = {}
    i = j = 0
    while i < len(xs) and j < len(pieces):
        s, e = max(xs[i][0], pieces[j][0]), min(xs[i][1], pieces[j][1])
        if e > s:
            out[pieces[j][2]] = out.get(pieces[j][2], 0.0) + (e - s)
        if xs[i][1] < pieces[j][1]:
            i += 1
        else:
            j += 1
    return out


def analyse(records: Iterable[Any], busy: Sequence[Interval], d0: float, d1: float,
            offset: float) -> Optional[Dict[str, Any]]:
    """The readings of spans ``records`` (``.name``, ``.t0``, ``.t1`` on the
    host's clock) against the device's sorted disjoint ``busy`` intervals
    in the slice [d0, d1] of the device's clock, host time h being device
    time h + offset. None where no span starts in the slice."""
    window = d1 - d0
    started: Dict[str, List[float]] = {}
    clipped: List[Mapped] = []
    for r in records:
        s, e = r.t0 + offset, r.t1 + offset
        if d0 <= s < d1:
            started.setdefault(r.name, []).append(min(e, d1) - s)
        if e > d0 and s < d1:
            clipped.append((r.name, max(s, d0), min(e, d1)))
    if not started or window <= 0:
        return None
    idle = gaps(busy, d0, d1)
    idle_s = sum(e - s for s, e in idle)
    pieces = innermost(clipped)
    under = overlap(idle, pieces)
    in_pipeline = union([(s, e) for n, s, e in clipped if n in PIPELINE])
    pipeline_idle = sum(overlap(idle, [(s, e, "") for s, e in in_pipeline]).values())
    enqueued = len(started.get("stream.enqueue", ()))
    forwards = started.get(FORWARD, ())
    return {
        "window_s": window,
        "idle_s": idle_s,
        "names": {n: {"count": len(d), "mean_ms": 1e3 * statistics.fmean(d), "p90_ms": 1e3 * _p90(d),
                      "idle_ms": 1e3 * under.get(n, 0.0)} for n, d in sorted(started.items())},
        "idle_no_span_ms": 1e3 * (idle_s - sum(under.values())),
        "covered": sum(e - s for s, e, _ in pieces) / window,
        "engine_host_ms": (1e3 * sum(sum(started.get(n, ())) for n in HOST_STEPS) / enqueued
                           if enqueued else None),
        "forward_enqueue_ms": 1e3 * statistics.fmean(forwards) if forwards else None,
        "engine_idle_share": (100.0 * pipeline_idle / window
                              if any(n in started for n in PIPELINE) else None),
    }


def _p90(values: Sequence[float]) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1] if len(values) > 1 else values[0]


def table(a: Dict[str, Any], dropped: int) -> str:
    lines = [f"program spans in the traced slice ({1e3 * a['window_s']:.3f} ms; device idle "
             f"{1e3 * a['idle_s']:.3f} ms, {100 * a['idle_s'] / a['window_s']:.2f}%):",
             f"{'span':<16} {'count':>6} {'mean ms':>9} {'p90 ms':>9} {'idle ms':>9}"]
    for name, v in a["names"].items():
        lines.append(f"{name:<16} {v['count']:>6} {v['mean_ms']:>9.4f} {v['p90_ms']:>9.4f} "
                     f"{v['idle_ms']:>9.3f}")
    lines.append(f"{'(no span)':<16} {'':>6} {'':>9} {'':>9} {a['idle_no_span_ms']:>9.3f}")
    lines.append(f"host time under a span: {100 * a['covered']:.2f}% of the slice; "
                 f"spans dropped: {dropped}")
    return "\n".join(lines)


def _read(run) -> Optional[Dict[str, Any]]:
    tracer = getattr(run.cell, "tracer", None)
    if tracer is None or tracer.prof is None or tracer.t_mark is None or tracer.t_stop is None:
        return None
    try:
        from fast_srgan_torch.utils import spans
    except ImportError:  # a program without spans
        return None
    events = sorted(_device_events(tracer.prof), key=lambda e: e[1])
    if not events:
        return None
    marker = events[0]
    d0 = marker[1]
    d1 = d0 + (tracer.t_stop - tracer.t_mark)
    busy = union([(max(s, d0), min(e, d1)) for _, s, e in events[1:] if e > d0 and s < d1])
    a = analyse(spans.spans(), busy, d0, d1, d0 - tracer.t_mark)
    if a is not None:
        print(table(a, spans.dropped()), file=sys.stderr)
    return a


def analysis(run) -> Optional[Dict[str, Any]]:
    """``analyse`` of the run's traced slice, once a run (the table printed then)."""
    if run not in _ANALYSES:
        _ANALYSES[run] = _read(run)
    return _ANALYSES[run]


def _metric(key: str):
    def read(run):
        a = analysis(run)
        return None if a is None else a[key]

    read.__name__ = key
    return read


engine_host_ms = _metric("engine_host_ms")
forward_enqueue_ms = _metric("forward_enqueue_ms")
engine_idle_share = _metric("engine_idle_share")
