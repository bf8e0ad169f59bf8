"""Host spans at the program's layer boundaries, kept in memory while a
``torch.profiler`` runs.

    with span("stream.enqueue", t):
        ...

A span records its name, batch id, parent and its start and end in
``time.perf_counter`` seconds, the clock a profiler's marker can tie to the
device's. It records only when the profiler was on in the calling thread
at its start (``torch.autograd._profiler_enabled()``, ~60 ns a check;
under ``torch.profiler.profile`` with any activity); otherwise ``span``
returns one shared no-op context, which allocates nothing and reads no
clock. There is no other switch. A span started while the profiler ran is
kept when it ends after the profiler stopped.

The parent is the innermost span open in the same thread at the start; a
span given no batch takes its parent's. ``spans()`` returns the records in
the order they ended, at most ``LIMIT``; later ones are counted in
``dropped()``. ``clear()`` empties both. Names are ``<layer>.<step>``:
``engine.forward`` (``SRInferenceEngine.forward_u8`` and
``forward_u8_masked``: the host's enqueue of one generator forward),
``engine.replay`` (inside ``engine.forward`` where ``stream`` replays the
forward's CUDA graph) and ``stream.gather``, ``stream.stage``, ``stream.enqueue``, ``stream.wait``,
``stream.copy`` and ``stream.caller`` (``SRInferenceEngine.stream``, one
each a batch; the CPU path has no wait and no copy).
"""

from __future__ import annotations

import itertools
import threading
from time import perf_counter
from typing import List, NamedTuple, Optional

import torch

LIMIT = 1 << 16


class Span(NamedTuple):
    name: str
    batch: Optional[int]
    id: int
    parent: Optional[int]  # the enclosing span's id
    t0: float
    t1: float


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Recorder:
    """The process's records, its ids and each thread's stack of open spans."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self.records: List[Span] = []
        self.dropped = 0
        self.ids = itertools.count()
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, record: Span) -> None:
        with self.lock:
            if len(self.records) < self.limit:
                self.records.append(record)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class _Open:
    __slots__ = ("name", "batch", "id", "parent", "t0")

    def __init__(self, name: str, batch: Optional[int]):
        self.name, self.batch = name, batch

    def __enter__(self) -> "_Open":
        stack = _RECORDER.stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.batch is None and top is not None:
            self.batch = top.batch
        self.id = next(_RECORDER.ids)
        stack.append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = perf_counter()
        stack = _RECORDER.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # generators of one thread interleaved
            stack.remove(self)
        _RECORDER.add(Span(self.name, self.batch, self.id, self.parent, self.t0, t1))
        return False


def span(name: str, batch: Optional[int] = None):
    """A context that records one span while the profiler runs (see the
    module's docstring), else the shared no-op."""
    if not torch.autograd._profiler_enabled():
        return NO_SPAN
    return _Open(name, batch)


def spans() -> List[Span]:
    with _RECORDER.lock:
        return list(_RECORDER.records)


def dropped() -> int:
    return _RECORDER.dropped


def clear() -> None:
    with _RECORDER.lock:
        _RECORDER.records = []
        _RECORDER.dropped = 0
