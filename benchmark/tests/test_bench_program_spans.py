"""The readers of the program's spans (``benchmark/program_spans.py``) on
synthetic spans and device intervals with a known clock offset: the
per-batch host ms, the forward's enqueue ms, the idle share under the
pipeline's spans, the innermost-span idle table, and None where there is
nothing to read."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import program_spans
from benchmark.harness import load_module

OFFSET = 100.0  # device clock minus host clock
D0, D1 = 101.0, 102.0  # the slice on the device: host [1.0, 2.0]


def _span(name, t0, t1):
    return SimpleNamespace(name=name, t0=t0, t1=t1)


#: two batches of the card's pipeline on the host's clock; [1.65, 1.70] is
#: under no span; the second copy runs past the slice's end
SPANS = [
    _span("stream.gather", 1.00, 1.05), _span("stream.stage", 1.05, 1.10),
    _span("stream.enqueue", 1.10, 1.30), _span("engine.forward", 1.12, 1.28),
    _span("stream.wait", 1.30, 1.45), _span("stream.copy", 1.45, 1.55),
    _span("stream.caller", 1.55, 1.65),
    _span("stream.gather", 1.70, 1.75), _span("stream.stage", 1.75, 1.80),
    _span("stream.enqueue", 1.80, 1.95), _span("engine.forward", 1.82, 1.90),
    _span("stream.copy", 1.95, 2.10),
    _span("stream.enqueue", 2.20, 2.30),  # after the slice: not read
]
#: device busy: idle [101.2, 101.5] and [101.6, 101.9], 0.6 s of the 1-s slice
BUSY = [(101.0, 101.2), (101.5, 101.6), (101.9, 102.0)]


def test_known_readings():
    a = program_spans.analyse(SPANS, BUSY, D0, D1, OFFSET)
    # stage + enqueue + copy in the slice: 0.35 + 0.25 s (the last copy cut at
    # the slice's end) over 2 enqueues
    assert a["engine_host_ms"] == pytest.approx(300.0)
    assert a["forward_enqueue_ms"] == pytest.approx(120.0)  # (160 + 80) / 2
    # idle under gather, stage, enqueue or copy: 0.1 + 0.05 | 0.05 + 0.05 + 0.1
    assert a["engine_idle_share"] == pytest.approx(35.0)
    assert a["idle_s"] == pytest.approx(0.6)
    idle = {n: v["idle_ms"] for n, v in a["names"].items()}
    assert idle == pytest.approx({"engine.forward": 160.0, "stream.enqueue": 40.0,
                                  "stream.wait": 150.0, "stream.copy": 50.0,
                                  "stream.caller": 50.0, "stream.gather": 50.0,
                                  "stream.stage": 50.0})
    assert a["idle_no_span_ms"] == pytest.approx(50.0)
    assert sum(idle.values()) + a["idle_no_span_ms"] == pytest.approx(1e3 * a["idle_s"])
    assert a["covered"] == pytest.approx(0.95)
    assert a["names"]["stream.enqueue"]["count"] == 2
    assert a["names"]["stream.copy"]["mean_ms"] == pytest.approx(75.0)  # (100 + 50) / 2
    assert a["names"]["engine.forward"]["p90_ms"] >= a["names"]["engine.forward"]["mean_ms"]
    assert 100 * a["idle_s"] / a["window_s"] >= a["engine_idle_share"]
    text = program_spans.table(a, dropped=0)
    assert "stream.wait" in text and "(no span)" in text and "95.00%" in text


@pytest.mark.parametrize("busy", [[(101.0, 102.0)], [(101.0, 101.6), (101.6, 102.0)]])
def test_span_covering_no_idle_reads_zero(busy):
    a = program_spans.analyse(SPANS, busy, D0, D1, OFFSET)
    assert a["engine_idle_share"] == 0.0 and a["idle_s"] == 0.0
    assert all(v["idle_ms"] == 0.0 for v in a["names"].values())
    assert a["engine_host_ms"] == pytest.approx(300.0)


@pytest.mark.parametrize("spans", [[], [_span("stream.enqueue", 2.5, 2.6)],
                                   [_span("stream.enqueue", 0.1, 0.2)]])
def test_no_span_in_the_slice_reads_none(spans):
    assert program_spans.analyse(spans, BUSY, D0, D1, OFFSET) is None


def test_innermost_names_each_piece_by_the_latest_start():
    pieces = program_spans.innermost([("outer", 0.0, 10.0), ("a", 2.0, 4.0),
                                      ("b", 2.0, 3.0), ("c", 6.0, 12.0)])
    assert pieces == [(0.0, 2.0, "outer"), (2.0, 3.0, "b"), (3.0, 4.0, "a"),
                      (4.0, 6.0, "outer"), (6.0, 10.0, "c"), (10.0, 12.0, "c")]
    assert program_spans.gaps([(1.0, 2.0), (3.0, 5.0)], 0.0, 4.0) == [(0.0, 1.0), (2.0, 3.0)]


class _Run:
    """A stand-in for the harness's ``Run`` (readers cache by it, weakly)."""

    def __init__(self, tracer):
        self.cell, self.trace = SimpleNamespace(tracer=tracer), None


def _run(records, events, monkeypatch, t_mark=1.0, t_stop=2.0):
    """A traced run whose profiler gave ``events`` (the marker first) and
    whose program recorded ``records``."""
    monkeypatch.setattr(program_spans, "_device_events", lambda prof: events)
    fake = SimpleNamespace(spans=lambda: records, dropped=lambda: 0)
    monkeypatch.setitem(sys.modules, "fast_srgan_torch.utils.spans", fake)
    import fast_srgan_torch.utils

    monkeypatch.setattr(fast_srgan_torch.utils, "spans", fake, raising=False)
    tracer = SimpleNamespace(prof=object(), t_mark=t_mark, t_stop=t_stop)
    return _Run(tracer)


EVENTS = [("marker", D0, D0 + 1e-6)] + [("kernel", s, e) for s, e in BUSY]


@pytest.mark.parametrize("suffix", ["video", "video.int8ups"])
def test_metric_files_read_the_run(monkeypatch, capsys, suffix):
    run = _run(SPANS, EVENTS, monkeypatch)
    got = {m: load_module("metrics", f"{m}.{suffix}").read(run)
           for m in ("engine_host_ms", "forward_enqueue_ms", "engine_idle_share")}
    assert got == pytest.approx({"engine_host_ms": 300.0, "forward_enqueue_ms": 120.0,
                                 "engine_idle_share": 35.0})
    assert capsys.readouterr().err.count("program spans in the traced slice") == 1


def test_program_without_spans_or_run_without_slice_reads_none(monkeypatch):
    run = _run(SPANS, EVENTS, monkeypatch)
    import fast_srgan_torch.utils

    monkeypatch.delattr(fast_srgan_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "fast_srgan_torch.utils.spans", None)  # import fails
    assert program_spans.engine_host_ms(run) is None
    untraced = _Run(None)
    assert program_spans.engine_idle_share(untraced) is None
