"""The host logic of ``stream``'s CUDA graphs on the CPU, with the capture
stubbed by a fake graph (a replay reruns the captured forward into the
slot's static output).

Where graphs apply (one card, no mesh); the ring cached by (batch, height,
width) and captured once a slot; one live stream holding it at a time;
``recalibrate`` writing the scales the captured forwards read in place; a
full batch replayed (``engine.replay`` inside ``engine.forward``, counted
as a forward) and a partial one run eagerly; and the CPU ``stream``, which
captures nothing, replays nothing and stays bitwise equal to
``upscale_batch``. The capture itself and the replays on the card are
``tests/test_torch_cuda_kernels.py``'s.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fast_srgan_torch import inference
from fast_srgan_torch.checkpoints.npz_io import load_npz_params
from fast_srgan_torch.inference import STREAM_IN_FLIGHT, SRInferenceEngine, graphs_apply
from fast_srgan_torch.parallel.mesh import Mesh
from fast_srgan_torch.utils import spans

torch.set_num_threads(1)
SLOTS = STREAM_IN_FLIGHT + 1


@pytest.fixture(scope="module")
def params():
    return load_npz_params("models/generator_pretrained.npz")


def _frames(n, h=8, w=12, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


class FakeGraph:
    """A replay reruns the forward of the captured input into ``out``."""

    def __init__(self, forward, x, out):
        self.forward, self.x, self.out = forward, x, out
        self.replays = 0

    def replay(self):
        with torch.inference_mode():  # the captured output is an inference tensor
            self.out.copy_(self.forward(self.x))
        self.replays += 1


@pytest.fixture
def stubbed(monkeypatch):
    """Graphs apply on the CPU: plain slots, a fake capture that records
    each call."""
    calls = []

    def capture(forward, inputs):
        calls.append(len(inputs))
        out = []
        for x in inputs:
            y = forward(x)
            out.append(inference._Captured(FakeGraph(forward, x, y), y))
        return out

    def slots(bs, shape, scale, device):
        h, w, c = shape
        return [(torch.empty((bs, h, w, c), dtype=torch.uint8),
                 torch.empty((bs, h, w, c), dtype=torch.uint8, device=device),
                 torch.empty((bs, scale * h, scale * w, c), dtype=torch.uint8))
                for _ in range(SLOTS)]

    monkeypatch.setattr(inference, "graphs_apply", lambda device, mesh: True)
    monkeypatch.setattr(inference, "_capture", capture)
    monkeypatch.setattr(inference, "_slots", slots)
    return calls


@pytest.mark.parametrize("device,mesh,want", [
    ("cuda", None, True),
    ("cuda:1", None, True),
    ("cpu", None, False),
    ("cuda", Mesh(["cuda:0", "cuda:1"], ("data",)), False),
    ("cuda", Mesh(["cuda", "cuda"], ("data",)), False),
])
def test_graphs_apply_on_one_card_only(device, mesh, want):
    assert graphs_apply(torch.device(device), mesh) is want


def test_ring_is_cached_by_batch_and_shape(params, stubbed):
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    ring = engine._hold_ring(4, (8, 12, 3))
    assert len(ring.slots) == len(ring.graphs) == SLOTS
    assert engine.graph_captures == SLOTS and stubbed == [SLOTS]
    assert set(engine._rings) == {(4, 8, 12)}
    ring.held = False
    assert engine._hold_ring(4, (8, 12, 3)) is ring  # no new capture
    assert engine.graph_captures == SLOTS
    other = [engine._hold_ring(2, (8, 12, 3)), engine._hold_ring(4, (12, 8, 3))]
    assert all(r is not None and r is not ring for r in other)
    assert set(engine._rings) == {(4, 8, 12), (2, 8, 12), (4, 12, 8)}
    assert engine.graph_captures == 3 * SLOTS and stubbed == [SLOTS] * 3
    assert engine.forward_calls == 0 and engine.graph_replays == 0  # captures are no batch


def test_one_live_stream_holds_a_ring(params, stubbed):
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    ring = engine._hold_ring(4, (8, 12, 3))
    assert ring.held
    assert engine._hold_ring(4, (8, 12, 3)) is None  # held: the second runs eagerly
    assert engine.graph_captures == SLOTS
    ring.held = False
    assert engine._hold_ring(4, (8, 12, 3)) is ring


def test_each_slot_graphs_its_own_input_and_output(params, stubbed):
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    ring = engine._hold_ring(4, (8, 12, 3))
    for (_, dev_in, _), captured in zip(ring.slots, ring.graphs):
        assert captured.graph.x is dev_in
    outs = {c.out.data_ptr() for c in ring.graphs}
    assert len(outs) == SLOTS


def test_full_batch_replays_and_partial_batch_runs_eagerly(params, stubbed):
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    ring = engine._hold_ring(4, (8, 12, 3))
    frames = torch.from_numpy(_frames(4))
    _, dev_in, _ = ring.slots[1]
    dev_in.copy_(frames)
    out = engine._forward_slot(ring.graphs, 1, dev_in, 4)
    assert out is ring.graphs[1].out and ring.graphs[1].graph.replays == 1
    assert (engine.forward_calls, engine.graph_replays) == (1, 1)
    assert engine.batch_shapes == {(4, 8, 12)}
    assert torch.equal(out, engine.forward_u8(frames))
    assert (engine.forward_calls, engine.graph_replays) == (2, 1)
    part = engine._forward_slot(ring.graphs, 2, dev_in, 3)
    assert all(c.graph.replays == (k == 1) for k, c in enumerate(ring.graphs))
    assert (engine.forward_calls, engine.graph_replays) == (3, 1)
    assert engine.batch_shapes == {(4, 8, 12), (3, 8, 12)}
    assert torch.equal(part, engine.forward_u8(frames[:3]))
    # no graphs (the eager ring): every batch is eager
    assert torch.equal(engine._forward_slot((), 0, dev_in, 4), out)
    assert engine.graph_replays == 1


def test_replay_records_its_span_inside_the_forward(params, stubbed):
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32)
    ring = engine._hold_ring(4, (8, 12, 3))
    _, dev_in, _ = ring.slots[0]
    dev_in.copy_(torch.from_numpy(_frames(4)))
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        engine._forward_slot(ring.graphs, 0, dev_in, 4)
        engine._forward_slot(ring.graphs, 0, dev_in, 3)
    records = spans.spans()
    spans.clear()
    forwards = [r for r in records if r.name == "engine.forward"]
    replays = [r for r in records if r.name == "engine.replay"]
    assert len(forwards) == 2 and len(replays) == 1
    assert replays[0].parent == forwards[0].id
    assert forwards[0].t0 <= replays[0].t0 <= replays[0].t1 <= forwards[0].t1


def _calib(seed):
    return [_frames(2, 16, 16, seed)]


def test_recalibrate_writes_the_captured_scales_in_place(params, stubbed):
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                               calib_batches=_calib(1))
    ring = engine._hold_ring(2, (8, 12, 3))
    tensors = {k: (v, v.data_ptr()) for k, v in engine.act_scales.items()}
    _, dev_in, _ = ring.slots[0]
    dev_in.copy_(torch.from_numpy(_frames(2, seed=5)))
    before = engine._forward_slot(ring.graphs, 0, dev_in, 2).clone()
    engine.recalibrate(_calib(2))
    assert all(engine.act_scales[k] is t and t.data_ptr() == p for k, (t, p) in tensors.items())
    fresh = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                              calib_batches=_calib(2))
    assert all(torch.equal(engine.act_scales[k], fresh.act_scales[k]) for k in fresh.act_scales)
    ring.held = False
    assert engine._hold_ring(2, (8, 12, 3)) is ring and engine.graph_captures == SLOTS
    after = engine._forward_slot(ring.graphs, 0, dev_in, 2)
    assert torch.equal(after, fresh.forward_u8(dev_in))
    assert not torch.equal(after, before)


def test_given_scales_are_copied_not_shared(params):
    first = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                              calib_batches=_calib(1))
    second = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                               act_scales=first.act_scales)
    second.recalibrate(_calib(2))
    assert all(first.act_scales[k] is not second.act_scales[k] for k in first.act_scales)
    again = SRInferenceEngine(params, device="cpu", dtype=torch.float32, quantize=True,
                              calib_batches=_calib(1))
    assert all(torch.equal(first.act_scales[k], again.act_scales[k]) for k in again.act_scales)


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]])
def test_cpu_stream_captures_and_replays_nothing(params, monkeypatch, mesh):
    def refuse(*args):
        raise AssertionError("stream captured a graph on the CPU")

    monkeypatch.setattr(inference, "_capture", refuse)
    engine = SRInferenceEngine(params, device="cpu", dtype=torch.float32, mesh=mesh)
    frames = list(_frames(11))
    plain = list(engine.stream(iter(frames), batch_size=4))  # 4, 4 and a trailing 3
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = list(engine.stream(iter(frames), batch_size=4))
    names = {r.name for r in spans.spans()}
    spans.clear()
    assert "engine.forward" in names and "engine.replay" not in names
    want = np.concatenate([engine.upscale_batch(np.stack(frames[i:i + 4]))
                           for i in range(0, 11, 4)])
    assert len(plain) == len(traced) == 11
    assert all(np.array_equal(a, w) and np.array_equal(b, w)
               for a, b, w in zip(plain, traced, want))
    assert engine.graph_captures == engine.graph_replays == 0 and engine._rings == {}
    assert engine._hold_ring(4, (8, 12, 3)) is None
