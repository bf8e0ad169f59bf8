"""The program's host spans (``fast_srgan_torch/utils/spans.py``) on the CPU.

Off (no profiler in the thread): ``span`` hands back one shared no-op
context, records nothing, allocates nothing and reads no clock. On (under
``torch.profiler.profile`` with the CPU activity): records carry name,
batch, parent and ``t0 <= t1`` on ``time.perf_counter``; a span given no
batch takes its parent's; the buffer's bound counts drops; a span started
while on and ended after the profiler stopped is kept. The engine's CPU
``stream`` yields its frames bitwise as without the profiler (and as
``upscale_batch`` on the same batches) and records each batch's gather,
stage, enqueue (with ``engine.forward`` inside) and caller spans under the
batch's index; two streams consumed in turns leave no span open.
"""

import itertools
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fast_srgan_torch.utils import spans

STREAM_STEPS = ("stream.gather", "stream.stage", "stream.enqueue", "engine.forward",
                "stream.caller")


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def engine():
    from fast_srgan_torch.checkpoints.npz_io import load_npz_params
    from fast_srgan_torch.inference import SRInferenceEngine

    torch.set_num_threads(1)
    return SRInferenceEngine(load_npz_params("models/generator_pretrained.npz"),
                             device="cpu", dtype=torch.float32)


# --- off ----------------------------------------------------------------------

@pytest.mark.parametrize("name,batch", [("stream.stage", 3), ("engine.forward", None)])
def test_off_is_one_shared_noop_and_records_nothing(name, batch):
    assert not torch.autograd._profiler_enabled()
    context = spans.span(name, batch)
    assert context is spans.NO_SPAN and spans.span("other") is context
    with context as inside:
        assert inside is None
    assert spans.spans() == [] and spans.dropped() == 0


def test_off_allocates_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with the profiler off")

    monkeypatch.setattr(spans, "perf_counter", no_clock)
    monkeypatch.setattr(time, "perf_counter", no_clock)
    span = spans.span

    def peak_of(n: int) -> int:
        """Bytes allocated at the peak of n spans (a constant few for the
        first call into a function under tracemalloc, none a span)."""
        tracemalloc.start()
        try:
            before, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            for _ in itertools.repeat(None, n):
                with span("stream.enqueue", 7):
                    pass
            after, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        assert after == before
        return peak - before

    assert peak_of(10) == peak_of(10_000) == peak_of(10)
    assert spans.spans() == []


# --- on -----------------------------------------------------------------------

def test_on_records_name_batch_parent_and_perf_counter_times():
    lo = time.perf_counter()
    with _profiler():
        with spans.span("stream.enqueue", 4):
            with spans.span("engine.forward"):
                pass
            with spans.span("engine.forward", 9):
                pass
        with spans.span("stream.copy", 5):
            pass
    hi = time.perf_counter()
    got = {(r.name, r.batch): r for r in spans.spans()}
    assert set(got) == {("stream.enqueue", 4), ("engine.forward", 4), ("engine.forward", 9),
                        ("stream.copy", 5)}
    outer = got["stream.enqueue", 4]
    assert outer.parent is None and got["stream.copy", 5].parent is None
    for key in (("engine.forward", 4), ("engine.forward", 9)):
        inner = got[key]
        assert inner.parent == outer.id
        assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert all(lo <= r.t0 <= r.t1 <= hi for r in spans.spans())
    assert len({r.id for r in spans.spans()}) == 4


def test_on_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(spans._RECORDER, "limit", 3)
    with _profiler():
        for t in range(5):
            with spans.span("stream.gather", t):
                pass
    assert [r.batch for r in spans.spans()] == [0, 1, 2]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.spans() == [] and spans.dropped() == 0


def test_span_started_on_and_ended_after_stop_is_kept():
    prof = _profiler()
    prof.start()
    try:
        context = spans.span("stream.caller", 1)
        context.__enter__()
    finally:
        prof.stop()
    assert not torch.autograd._profiler_enabled()
    context.__exit__(None, None, None)
    with spans.span("stream.caller", 2):  # started after the stop: not recorded
        pass
    assert [(r.name, r.batch) for r in spans.spans()] == [("stream.caller", 1)]


# --- the engine's CPU stream --------------------------------------------------

@pytest.mark.parametrize("n_frames,batch_size", [(6, 2), (7, 3)])
def test_cpu_stream_is_bitwise_and_records_each_batch(engine, n_frames, batch_size):
    frames = list(np.random.default_rng(5).integers(0, 256, (n_frames, 6, 8, 3), dtype=np.uint8))
    plain = list(engine.stream(iter(frames), batch_size=batch_size))
    assert spans.spans() == []
    with _profiler():
        traced = list(engine.stream(iter(frames), batch_size=batch_size))
    n_batches = -(-n_frames // batch_size)
    assert n_batches == 3
    want = np.concatenate([engine.upscale_batch(np.stack(frames[i:i + batch_size]))
                           for i in range(0, n_frames, batch_size)])
    assert len(plain) == len(traced) == n_frames
    for a, b, w in zip(plain, traced, want):
        assert np.array_equal(a, w) and np.array_equal(b, w)

    records = spans.spans()
    by_id = {r.id: r for r in records}
    for t in range(n_batches):
        mine = {r.name: r for r in records if r.batch == t}
        assert set(mine) == set(STREAM_STEPS)
        assert by_id[mine["engine.forward"].parent] is mine["stream.enqueue"]
        assert all(mine[n].parent is None for n in STREAM_STEPS if n != "engine.forward")
        order = [mine[n] for n in ("stream.gather", "stream.stage", "stream.enqueue",
                                   "stream.caller")]
        assert all(a.t1 <= b.t0 for a, b in zip(order, order[1:]))
    # the last gather finds the frames exhausted
    assert [(r.name, r.batch) for r in records if r.batch == n_batches] == \
        [("stream.gather", n_batches)]


def test_interleaved_streams_leave_no_span_open(engine):
    """Two streams consumed in turns in one thread close their spans out of
    order; each is still recorded once and none stays on the thread's stack."""
    frames = list(np.random.default_rng(8).integers(0, 256, (4, 6, 8, 3), dtype=np.uint8))
    with _profiler():
        pairs = list(zip(engine.stream(iter(frames), batch_size=2),
                         engine.stream(iter(frames[::-1]), batch_size=2)))
    assert len(pairs) == 4
    assert spans._RECORDER.stack() == []
    records = spans.spans()
    assert len({r.id for r in records}) == len(records)
    assert sum(r.name == "stream.caller" for r in records) == 4
