"""The s8 conv's four-phase launch, fused requantize and tiled weights, and
the int8 executor's launch plan, on the CPU.

The CUDA kernel (``fast_srgan_torch/csrc/int8_conv.cu``) is checked on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py phase 10); here the
wrappers take their plain versions, so these tests hold those plain
versions, and the layouts the kernel reads, to:

  * ``int8_conv_phases_reference``: four ``int8_conv_reference`` calls at
    the phases' paddings, and JAX's ``conv_q`` on its own phase kernels;
  * ``int8_conv(out_scale=)``: ``quantize_act_reference`` of the unfused
    conv, and JAX's ``_quantize_act`` at near-ties of planted scales;
  * the tiled weight layouts: a round trip to ``pack_int8_weight``'s;
  * the executor: the unfused call sequence (five convs, two quantizes a
    4x `ups` forward), rebuilt here from the plain functions, at 2x, 4x and
    8x in every mode; and the wrappers it calls a 4x forward.

All bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_srgan_tpu import quant as jq
from fast_srgan_tpu.ops.lr_tail import _phase_kernels_2x as jax_phase_kernels
from fast_srgan_torch import quant
from fast_srgan_torch.kernels.int8_conv import (
    PHASES,
    PHASES_N_TILE,
    Int8Phases,
    int8_conv,
    int8_conv_phases,
    int8_conv_phases_reference,
    int8_conv_reference,
    kernel_n_tile,
    pack_int8_phases,
    pack_int8_weight,
    tile_weights,
)
from fast_srgan_torch.kernels.quantize import quantize_act_reference
from fast_srgan_torch.ops.lr_tail import _phase_kernels_2x, _phase_outputs, _summed_head
from test_torch_generator import random_params

torch.set_num_threads(1)

_GLUES = [torch.float32, torch.bfloat16]


def untile_weights(tiled: torch.Tensor, n_k: int, kh: int, kw: int, cpad: int) -> torch.Tensor:
    """The inverse of ``tile_weights``: [n_k, Npad, KH, KW, Cpad]."""
    n_tiles, chunks, _, _, n_tile, _ = tiled.shape
    w = tiled.reshape(n_tiles, chunks, n_k, kh * kw, 2, n_tile, 16)
    w = w.permute(2, 0, 5, 3, 1, 4, 6)  # [kernel, ntile, n, tap, chunk, kcol, 16]
    w = w.reshape(n_k, n_tiles * n_tile, kh, kw, chunks * 32)
    return w[..., :cpad]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _stage2(seed, cin=8, cout=12, shape=(2, 7, 9)):
    """A canonical 3x3 stage-2 kernel, its four int8 phase kernels, and an
    int8 input with 4 * cin channels."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    xq = rng.integers(-127, 128, shape + (4 * cin,)).astype(np.int8)
    wscale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    bias = rng.normal(0, 0.5, cout).astype(np.float32)
    phases = pack_int8_phases(
        [(pq, pack_int8_weight(kp)) for pq, kp in _phase_kernels_2x(torch.from_numpy(k)).items()]
    )
    return k, xq, wscale, bias, phases


class TestPhases:
    @pytest.mark.parametrize("glue", _GLUES)
    @pytest.mark.parametrize("epilogue", [True, False])
    def test_reference_is_four_single_convs(self, glue, epilogue):
        _, xq, wscale, bias, phases = _stage2(1)
        b = torch.from_numpy(bias).to(glue) if epilogue else None
        a = torch.tensor([0.173]).to(glue) if epilogue else None
        args = (torch.from_numpy(wscale), torch.tensor(2.3))
        got = int8_conv_phases_reference(_nchw(xq), phases, *args, b, a, glue)
        assert len(got) == 4
        for (p, q), wq, y in zip(PHASES, phases.phases, got):
            want = int8_conv_reference(_nchw(xq), wq, *args, (1 - p, 1 - q), b, a, glue)
            assert y.dtype == glue and y.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(y, want)

    def test_matches_jax_conv_q_of_each_phase(self):
        k, xq, wscale, bias, phases = _stage2(2)
        ex = jq._Exec({"c": jnp.float32(2.3)}, None, jnp.float32)
        got = int8_conv_phases(
            _nchw(xq), phases, torch.from_numpy(wscale), torch.tensor(2.3),
            torch.from_numpy(bias), torch.tensor([0.173]), torch.float32,
        )
        for ((p, q), kp), y in zip(jax_phase_kernels(jnp.asarray(k)).items(), got):
            want = ex.conv_q(jnp.asarray(xq), "c", kp, jnp.asarray(wscale),
                             ((1 - p, p), (1 - q, q)))
            want = jq._prelu(want + jnp.asarray(bias), jnp.float32(0.173), jnp.float32)
            np.testing.assert_array_equal(_nhwc(y), np.asarray(want))

    def test_cpu_takes_the_plain_version(self):
        _, xq, wscale, _, phases = _stage2(3)
        before = int8_conv_phases.launches
        got = int8_conv_phases(_nchw(xq), phases, torch.from_numpy(wscale), torch.tensor(1.1))
        want = int8_conv_phases_reference(_nchw(xq), phases, torch.from_numpy(wscale),
                                          torch.tensor(1.1))
        assert int8_conv_phases.launches == before
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def test_pack_takes_the_four_2x2_phases(self):
        k = torch.zeros((3, 3, 4, 2), dtype=torch.int8)
        ws = [(pq, pack_int8_weight(kp)) for pq, kp in _phase_kernels_2x(k).items()]
        with pytest.raises(ValueError, match="phases"):
            pack_int8_phases(ws[:3])
        with pytest.raises(ValueError, match="2x2"):
            pack_int8_phases([(pq, pack_int8_weight(torch.zeros((3, 3, 16, 2), dtype=torch.int8)))
                              for pq in PHASES])
        packed = pack_int8_phases(list(reversed(ws)))  # any order in, PHASES order out
        assert all(torch.equal(a.packed, b.packed) for a, (_, b) in zip(packed.phases, ws))


class TestFusedQuantize:
    @pytest.mark.parametrize("glue", _GLUES)
    @pytest.mark.parametrize("k,cin,pad", [(3, 16, (1, 1)), (3, 3, (1, 1)), (2, 32, (0, 1))])
    def test_is_quantize_of_the_unfused_conv(self, glue, k, cin, pad):
        rng = np.random.default_rng(k + cin)
        q = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, 24)).astype(np.int8))
        xq = _nchw(rng.integers(-127, 128, (2, 6, 7, cin)).astype(np.int8))
        args = (pack_int8_weight(q), torch.from_numpy(rng.uniform(1e-3, 2e-2, 24).astype(np.float32)),
                torch.tensor(1.7), pad, torch.from_numpy(rng.normal(0, 0.5, 24)).to(glue),
                torch.tensor([0.2]).to(glue), glue)
        s_next = torch.tensor(np.float32(rng.uniform(0.5, 8)))
        got = int8_conv(xq, *args, out_scale=s_next)
        assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, quantize_act_reference(int8_conv_reference(xq, *args), s_next))
        assert torch.equal(got, int8_conv_reference(xq, *args, out_scale=s_next))

    def test_near_ties_at_planted_scales_match_jax(self):
        # tests/test_torch_quant.py's planted scales, where 127/s and
        # reciprocal(s)*127 differ. An identity tap makes acc = xq, and the
        # multiplier 1/(2r) (and its fp32 neighbours) puts v * r at or next
        # to a half for every odd xq.
        scales = np.random.default_rng(0).uniform(0.05, 40, 64).astype(np.float32)
        xq = np.arange(-127, 128, dtype=np.int8)[:252].reshape(1, 6, 7, 6)
        q = np.zeros((3, 3, 6, 6), np.int8)
        q[1, 1] = np.eye(6, dtype=np.int8)
        ex = jq._Exec({"c": jnp.float32(127.0)}, None, jnp.float32)
        for s in scales:
            base = np.float32(0.5) / (np.float32(127) / s)
            wscale = np.array([base, np.nextafter(base, np.float32(1)),
                               np.nextafter(base, np.float32(0))] * 2, np.float32)
            y = ex.conv_q(jnp.asarray(xq), "c", jnp.asarray(q), jnp.asarray(wscale), jq.PAD1)
            want = np.asarray(jq._quantize_act(y, jnp.float32(s)))
            got = int8_conv(_nchw(xq), pack_int8_weight(torch.from_numpy(q)),
                            torch.from_numpy(wscale), torch.tensor(127.0),
                            out_dtype=torch.float32, out_scale=torch.tensor(s))
            np.testing.assert_array_equal(_nhwc(got).astype(np.int8), want)


class TestTiledWeights:
    @pytest.mark.parametrize("kh,cin,cout", [(3, 64, 256), (3, 3, 64), (3, 1024, 48),
                                             (3, 256, 12), (2, 96, 64)])
    def test_round_trips_to_the_packed_layout(self, kh, cin, cout):
        q = torch.from_numpy(np.random.default_rng(cin).integers(
            -127, 128, (kh, kh, cin, cout)).astype(np.int8))
        w = pack_int8_weight(q)
        assert w.n_tile == kernel_n_tile(kh, w.packed.shape[0])
        assert w.tiled.shape[-1] == 16 and w.tiled.shape[-3] == 2
        back = untile_weights(w.tiled, 1, kh, kh, w.packed.shape[3])[0]
        assert torch.equal(back, w.packed)

    def test_layout_is_the_kernels(self):
        # tiled[nt, chunk, tap, kcol, n, byte] = packed[nt*NT + n, tap, chunk*32 + kcol*16 + byte]
        q = torch.from_numpy(np.random.default_rng(9).integers(
            -127, 128, (3, 3, 48, 256)).astype(np.int8))
        w = pack_int8_weight(q)
        nt = w.n_tile
        assert nt == 128 and w.tiled.shape == (2, 2, 9, 2, nt, 16)
        rng = np.random.default_rng(10)
        for _ in range(200):
            t, c, tap, col, n, i = (int(rng.integers(0, d)) for d in w.tiled.shape)
            k = c * 32 + col * 16 + i
            want = w.packed[t * nt + n, tap // 3, tap % 3, k] if k < 48 else 0
            assert int(w.tiled[t, c, tap, col, n, i]) == int(want)

    def test_phases_tiled_by_slot(self):
        _, _, _, _, phases = _stage2(4, cin=8, cout=64)
        assert phases.n_tile == PHASES_N_TILE
        back = untile_weights(phases.tiled, 4, 2, 2, 32)
        for i, w in enumerate(phases.phases):
            assert torch.equal(back[i], w.packed)
        # slot (2p + q) * 4 + 2 gi + gj of chunk 0, N tile 0
        slots = phases.tiled[0, 0]
        for i, w in enumerate(phases.phases):
            for tap in range(4):
                got = slots[i * 4 + tap].permute(1, 0, 2).reshape(PHASES_N_TILE, 32)
                assert torch.equal(got, w.packed[:PHASES_N_TILE, tap // 2, tap % 2, :32])

    def test_n_tile_rule(self):
        assert kernel_n_tile(3, 256) == 128 and kernel_n_tile(3, 64) == 64
        assert kernel_n_tile(2, 256) == 64 and kernel_n_tile(3, 192) == 64
        tiled = tile_weights([torch.zeros((64, 3, 3, 16), dtype=torch.int8)], 64)
        assert tiled.shape == (1, 1, 9, 2, 64, 16)  # Cin 16 zero-filled to 32


def _unfused_tail_4x(lay, ex, y, n0="up0", n1="up1", mask=None):
    """The int8 4x tail unfused: stage 1 in the glue dtype, a separate
    quantize of its output, four single-phase convs (unmasked)."""
    assert mask is None
    a1 = ex.conv(y, n0, lay[n0])
    st = lay[n1]
    if "phases_q" in st:
        a1q = quantize_act_reference(
            a1.contiguous(memory_format=torch.channels_last), ex.scales[n1])
        phases = [
            int8_conv_reference(a1q, wq, st["ws"], ex.scales[n1], (1 - p, 1 - q),
                                st["b"], st["a"], ex.glue)
            for (p, q), wq in zip(PHASES, st["phases_q"].phases)
        ]
    else:
        phases = _phase_outputs(a1, st["phases"], st["b"], st["a"])
    head = lay["head"]
    if "parts" in head:
        z = _summed_head(phases, head["parts"], head["b32"])
    else:
        a2 = torch.cat(phases, dim=1).contiguous(memory_format=torch.channels_last)
        z = ex.conv(a2, "head", head).float() + head["b32"].view(1, -1, 1, 1)
    return F.pixel_shuffle(torch.tanh(z), 4)


class TestExecutor:
    @pytest.mark.parametrize("glue", _GLUES)
    @pytest.mark.parametrize("mode", sorted(quant.MODES))
    @pytest.mark.parametrize("scale", [2, 4, 8])
    def test_matches_the_unfused_call_sequence(self, monkeypatch, scale, mode, glue):
        params = random_params(8, 1, scale, seed=scale)
        x = np.random.default_rng(scale).uniform(-1, 1, (2, 6, 7, 3)).astype(np.float32)
        with torch.no_grad():
            scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x])
            plan = quant.prepare_generator(params, mode, glue, device="cpu")
            got = quant.sr_quant_forward(plan, scales, _nchw(x))
            monkeypatch.setattr(quant, "_tail_4x", _unfused_tail_4x)
            monkeypatch.setitem(quant._TAILS, 4, _unfused_tail_4x)
            want = quant.sr_quant_forward(plan, scales, _nchw(x))
        assert got.shape == (2, 3, 6 * scale, 7 * scale)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("mode,want", [
        ("ups", {"int8_conv": 1, "int8_conv_phases": 1, "quantize_act": 1}),
        ("tail", {"int8_conv": 2, "int8_conv_phases": 1, "quantize_act": 2}),
        ("trunk", {"int8_conv": 4, "int8_conv_phases": 0, "quantize_act": 4}),
        ("full", {"int8_conv": 6, "int8_conv_phases": 1, "quantize_act": 6}),
    ])
    def test_wrapper_calls_a_4x_forward(self, monkeypatch, mode, want):
        """ups: stage 1 quantizes stage 2's input in its epilogue and the
        four phases are one call, so 2 s8 calls and 1 quantize (unfused: 5
        and 2). With one residual block, full and trunk add 4 trunk convs."""
        calls = {k: 0 for k in want}
        fused = []

        def counted(name):
            fn = getattr(quant, name)

            def wrapper(*args, **kwargs):
                calls[name] += 1
                if name == "int8_conv":
                    fused.append(args[-1] is not None if len(args) == 9
                                 else kwargs.get("out_scale") is not None)
                return fn(*args, **kwargs)

            return wrapper

        for name in want:
            monkeypatch.setattr(quant, name, counted(name))
        params = random_params(8, 1, 4, seed=1)
        x = np.random.default_rng(1).uniform(-1, 1, (1, 5, 6, 3)).astype(np.float32)
        with torch.no_grad():
            scales = quant.calibrate_scales(quant.prepare_generator(params, device="cpu"), [x])
            for k in calls:
                calls[k] = 0
            fused.clear()
            plan = quant.prepare_generator(params, mode, torch.bfloat16, device="cpu")
            quant.sr_quant_forward(plan, scales, _nchw(x))
        assert calls == want
        assert sum(fused) == (1 if want["int8_conv_phases"] else 0)

    def test_phases_prepared_once(self):
        plan = quant.prepare_generator(random_params(8, 1, 4), "ups", device="cpu")
        st = plan.layers["up1"]
        assert isinstance(st["phases_q"], Int8Phases)
        assert st["phases_q"].tiled.dtype == torch.int8 and st["phases_q"].cout == 32

    def test_prepare_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            quant.prepare_generator(random_params(8, 1, 4))


class TestHaloForm:
    """The halo form's plain versions (a shard extended by its neighbours'
    columns, no zero column left or right) against a float64 conv of the
    same input, "same"-padded, less its two edge columns: bitwise."""

    def _case(self, k, cin, cout, shape, seed):
        gen = torch.Generator().manual_seed(seed)
        q = torch.randint(-127, 128, (k, k, cin, cout), generator=gen).to(torch.int8)
        b, h, w = shape
        xq = torch.randint(-127, 128, (b, h, w, cin), generator=gen).to(torch.int8)
        return xq.permute(0, 3, 1, 2), q, pack_int8_weight(q)

    @pytest.mark.parametrize("glue", [torch.float32, torch.bfloat16])
    def test_single_conv(self, glue):
        xq, q, weight = self._case(3, 16, 64, (2, 7, 12), seed=1)
        ws, s = torch.rand(64) * 1e-2 + 1e-3, torch.tensor(2.3)
        bias, alpha = (torch.rand(64) - 0.5).to(glue), torch.tensor([0.2]).to(glue)
        got = int8_conv(xq, weight, ws, s, (1, 0, 0), bias, alpha, glue)
        assert got.shape == (2, 64, 7, 10)
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(xq.double(), q.permute(3, 2, 0, 1).double(), padding=1)
        m = (ws * (s / 127.0)).view(1, -1, 1, 1)
        want = ((acc[..., 1:-1].to(torch.int32).float() * m).to(glue))
        want = want + bias.view(1, -1, 1, 1)
        want = torch.where(want >= 0, want, alpha * want)
        assert torch.equal(got, want)
        same = int8_conv(xq, weight, ws, s, (1, 1), bias, alpha, glue)
        assert torch.equal(got, same[..., 1:-1])
        s_next = torch.tensor(4.1)
        assert torch.equal(int8_conv(xq, weight, ws, s, (1, 0, 0), bias, alpha, glue, s_next),
                           int8_conv(xq, weight, ws, s, (1, 1), bias, alpha, glue,
                                     s_next)[..., 1:-1])

    def test_phases(self):
        gen = torch.Generator().manual_seed(2)
        k = torch.randint(-127, 128, (3, 3, 16, 32), generator=gen).to(torch.int8)
        phases = pack_int8_phases(
            [(pq, pack_int8_weight(kp)) for pq, kp in quant._phase_kernels_2x(k).items()])
        xq = torch.randint(-127, 128, (2, 5, 11, 64), generator=gen).to(torch.int8)
        xq = xq.permute(0, 3, 1, 2)
        ws, s = torch.rand(32, generator=gen) * 1e-2 + 1e-3, torch.tensor(1.7)
        same = int8_conv_phases(xq, phases, ws, s, out_dtype=torch.float32)
        halo = int8_conv_phases(xq, phases, ws, s, out_dtype=torch.float32, padding=(0, 0))
        for (p, q), a, b, wq in zip(PHASES, halo, same, phases.phases):
            assert a.shape == (2, 32, 5, 9) and torch.equal(a, b[..., 1:-1])
            # JAX's window of the halo-extended shard: xxq[:, :, q:q+w+1] at rows (1-p, p)
            want = int8_conv_reference(xq[..., q:q + 10], wq, ws, s, (1 - p, 0, 0),
                                       out_dtype=torch.float32)
            assert torch.equal(a, want)
        for pad in ((1, 0), (0, 1)):
            one = int8_conv_phases_reference(xq, phases, ws, s, out_dtype=torch.float32,
                                             padding=pad)
            crop = (slice(None), slice(None), slice(None), slice(1 - pad[0], 11 - pad[0]))
            assert all(o.shape[3] == 10 and torch.equal(o, b[crop]) for o, b in zip(one, same))

    def test_kernel_checks(self):
        from fast_srgan_torch.kernels.int8_conv import check_kernel_inputs, conv_pads

        assert conv_pads(3, (1, 1)) == (1, 1, 1) and conv_pads(2, (0, 1)) == (0, 1, 0)
        assert conv_pads(3, (1, 0, 0)) == (1, 0, 0)
        xq, _, weight = self._case(3, 16, 64, (1, 4, 6), seed=3)
        check_kernel_inputs(xq, weight, (1, 0, 0), torch.float32)
        for bad in ((1, 0, 2), (0, 0, 0), (1, -1, 1), (1, 0, 0, 0)):
            with pytest.raises(ValueError, match="padding"):
                check_kernel_inputs(xq, weight, bad, torch.float32)
