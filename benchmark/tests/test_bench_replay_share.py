"""``graph_replay_share.*`` (``benchmark/replays.py``) over hand-made span
lists read through the harness's metric files: every forward a replay reads
100, forwards without a replay (the eager program) read 0, and a slice
without spans, or a run without a slice, reads None."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import replays
from benchmark.harness import load_module

D0, D1 = 101.0, 102.0  # the slice on the device: host [1.0, 2.0]
EVENTS = [("marker", D0, D0 + 1e-6), ("kernel", 101.0, 101.4), ("kernel", 101.5, 101.9)]


def _span(name, t0, t1):
    return SimpleNamespace(name=name, t0=t0, t1=t1)


def _batches(replayed):
    """Two batches of the card's pipeline; ``engine.replay`` inside each
    forward where ``replayed``."""
    out = []
    for t0 in (1.0, 1.5):
        out += [_span("stream.stage", t0, t0 + 0.05), _span("stream.enqueue", t0 + 0.05, t0 + 0.2),
                _span("engine.forward", t0 + 0.06, t0 + 0.1), _span("stream.copy", t0 + 0.2, t0 + 0.3)]
        if replayed:
            out.append(_span("engine.replay", t0 + 0.07, t0 + 0.09))
    return out


class _Run:
    """A stand-in for the harness's ``Run`` (readers cache by it, weakly)."""

    def __init__(self, tracer):
        self.cell, self.trace = SimpleNamespace(tracer=tracer), None


def _run(records, monkeypatch):
    from benchmark import program_spans

    monkeypatch.setattr(program_spans, "_device_events", lambda prof: EVENTS)
    fake = SimpleNamespace(spans=lambda: records, dropped=lambda: 0)
    monkeypatch.setitem(sys.modules, "fast_srgan_torch.utils.spans", fake)
    import fast_srgan_torch.utils

    monkeypatch.setattr(fast_srgan_torch.utils, "spans", fake, raising=False)
    return _Run(SimpleNamespace(prof=object(), t_mark=1.0, t_stop=2.0))


@pytest.mark.parametrize("suffix", ["video", "video.int8ups"])
@pytest.mark.parametrize("replayed,want", [(True, 100.0), (False, 0.0)])
def test_metric_files_read_the_share(monkeypatch, suffix, replayed, want):
    run = _run(_batches(replayed), monkeypatch)
    assert load_module("metrics", f"graph_replay_share.{suffix}").read(run) == want


def test_half_the_forwards_replayed_reads_50(monkeypatch):
    records = _batches(False) + [_span("engine.replay", 1.07, 1.09)]
    assert replays.graph_replay_share(_run(records, monkeypatch)) == 50.0


@pytest.mark.parametrize("records", [[], [_span("stream.copy", 1.2, 1.3)],
                                     [_span("engine.forward", 2.5, 2.6)]])
def test_no_forward_in_the_slice_reads_none(monkeypatch, records):
    assert replays.graph_replay_share(_run(records, monkeypatch)) is None


def test_run_without_a_slice_reads_none():
    assert replays.graph_replay_share(_Run(None)) is None
