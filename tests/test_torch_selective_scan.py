"""The four-direction selective scan (``kernels/selective_scan.py``): its plain
version (the op's CPU implementation) against a float64 step loop written
here from the recurrence, the orders' token maps, the shape checks and the
kernel's envelope; on the card (``-m cuda``, skipped here) the kernel
against the plain version.

CPU tolerance: 1e-5 of the largest |y|. The plain version runs in fp32 and
in chunks of ``CHUNK`` steps (a walk from a zero state, the carry, the
correction by exp(A cumsum(delta))), the loop in float64 step by step: the
same recurrence in another order and precision, ~1e-6 apart.
"""

import importlib

import pytest
import torch
import torch.nn.functional as F

ss = importlib.import_module("fast_srgan_torch.kernels.selective_scan")

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
TOL = 1e-5


def _inputs(b, h, w, d, r, n, seed, device="cpu", dtype=F32):
    """u, xdbl in ``dtype``; dt_w, dt_b, A, ds fp32. dt near the published
    initialisation (softplus(-4 +- 1): a state's memory of tens to hundreds
    of steps), A = -exp(log(1..N) + N(0, 0.3))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa: E731
    u = rand(b, h, w, d).to(dtype)
    xdbl = rand(b, h, w, 4, r + 2 * n).to(dtype)
    dt_w = rand(4, d, r) * (0.5 / r ** 0.5)
    dt_b = rand(4, d) - 4.0
    a = -torch.exp(torch.log(torch.arange(1, n + 1, device=device, dtype=F32)) + 0.3 * rand(4, d, n))
    ds = 1.0 + 0.1 * rand(4, d)
    return u, xdbl, dt_w, dt_b, a, ds


def step_loop(u, xdbl, dt_w, dt_b, a, ds):
    """The scan's definition in float64, one step at a time, each order's
    tokens visited in its order: [B, H, W, D]."""
    b, h, w, d = u.shape
    n, r = a.shape[-1], dt_w.shape[-1]
    length = h * w
    uf = u.double().reshape(b, length, d)
    xf = xdbl.double().reshape(b, length, 4, r + 2 * n)
    y = torch.zeros(b, length, d, dtype=torch.float64)
    for k in range(4):
        steps = range(length) if k < 2 else range(length - 1, -1, -1)
        # row-major, or column-major: step s is (row s mod H, column s div H)
        tokens = [s if k % 2 == 0 else (s % h) * w + s // h for s in steps]
        state = torch.zeros(b, d, n, dtype=torch.float64)
        for t in tokens:
            x = xf[:, t, k]
            delta = F.softplus(x[:, :r] @ dt_w[k].double().t() + dt_b[k].double())
            state = (torch.exp(delta[..., None] * a[k].double()) * state
                     + (delta * uf[:, t])[..., None] * x[:, None, r:r + n])
            y[:, t] += (state * x[:, None, r + n:]).sum(-1) + ds[k].double() * uf[:, t]
    return y.view(b, h, w, d)


# (B, H, W, D, R, N): non-square maps (the column orders are no transpose of
# a square's), maps shorter than a chunk, one of exactly two chunks, a long
# row, the published rank and states at a small D
CASES = [(2, 5, 7, 16, 3, 4), (1, 7, 5, 8, 12, 16), (1, 3, 4, 8, 2, 4), (1, 8, 8, 8, 4, 4),
         (1, 2, 45, 8, 1, 2), (2, 9, 6, 24, 12, 16)]


@pytest.mark.parametrize("case", CASES, ids=["x".join(map(str, c)) for c in CASES])
def test_plain_version_is_the_step_recurrence(case):
    args = _inputs(*case, seed=sum(case))
    got = ss.selective_scan(*args)
    want = step_loop(*args)
    assert got.shape == case[:4] and got.dtype == F32
    assert (got.double() - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.parametrize("hw", [(3, 5), (4, 4), (1, 6), (6, 1)])
def test_orders_visit_each_token_once_in_their_order(hw):
    h, w = hw
    grid = torch.arange(h * w).view(h, w)
    orders = [ss.order_tokens(h, w, k) for k in range(4)]
    assert torch.equal(orders[0], grid.flatten())
    assert torch.equal(orders[1], grid.t().flatten())  # column-major
    assert torch.equal(orders[2], orders[0].flip(0))
    assert torch.equal(orders[3], orders[1].flip(0))
    for idx in orders:
        assert torch.equal(idx.sort().values, torch.arange(h * w))


def test_carry_matters_past_one_chunk(monkeypatch):
    """The state carried across the plain version's chunks: dropping the
    carry (the benchmark's planted fault) moves a map longer than a chunk
    and leaves one of a single chunk as it is."""
    for hw, moves in (((5, 6), False), ((9, 11), True)):
        args = _inputs(1, *hw, 8, 4, 16, seed=5)
        base = ss.selective_scan(*args)
        monkeypatch.setattr(ss, "CARRY", False)
        off = ss.selective_scan(*args)
        monkeypatch.setattr(ss, "CARRY", True)
        assert ((off - base).abs().max().item() > 1e-3) == moves


def test_op_takes_bf16_and_rounds_once():
    args = _inputs(1, 6, 7, 16, 4, 16, seed=2, dtype=BF16)
    got = ss.selective_scan(*args)
    assert got.dtype == BF16
    want = ss.selective_scan(args[0].float(), args[1].float(), *args[2:])
    assert torch.equal(got, want.to(BF16))


def test_fake_implementation_gives_shape_and_type():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args = _inputs(2, 6, 7, 16, 4, 16, seed=0, dtype=BF16)
        out = torch.ops.fast_srgan.selective_scan(*args)
    assert out.shape == (2, 6, 7, 16) and out.dtype == BF16 and out.is_contiguous()


SHAPE_FAULTS = {
    "u not 4-D": ((2, 6, 16), (2, 6, 1, 4, 36), (4, 16, 4), (4, 16, 16), "u must be"),
    "A of another D": ((1, 2, 3, 16), (1, 2, 3, 4, 36), (4, 16, 4), (4, 8, 16), "A must be"),
    "dt_w of another D": ((1, 2, 3, 16), (1, 2, 3, 4, 36), (4, 8, 4), (4, 16, 16), "dt_w must be"),
    "xdbl of another width": ((1, 2, 3, 16), (1, 2, 3, 4, 35), (4, 16, 4), (4, 16, 16),
                              "xdbl must be"),
}


@pytest.mark.parametrize("case", list(SHAPE_FAULTS))
def test_shape_check_refuses_what_is_no_ss2d(case):
    *shapes, match = SHAPE_FAULTS[case]
    with pytest.raises(ValueError, match=match):
        ss.check_shapes(*shapes)


KERNEL_FAULTS = {
    "fp16": ((1, 2, 3, 360), 12, 16, torch.float16, "bf16 or fp32"),
    "8 states": ((1, 2, 3, 360), 12, 8, BF16, "N = 16"),
    "rank 20": ((1, 2, 3, 360), 20, 16, BF16, "multiple of 4 up to 16"),
    "rank 6": ((1, 2, 3, 360), 6, 16, BF16, "multiple of 4 up to 16"),
    "rank 2": ((1, 2, 3, 360), 2, 16, BF16, "multiple of 4 up to 16"),
    "rank 14": ((1, 2, 3, 360), 14, 16, F32, "multiple of 4 up to 16"),
    "D 364": ((1, 2, 3, 364), 12, 16, BF16, "multiple of 8"),
}


@pytest.mark.parametrize("case", list(KERNEL_FAULTS))
def test_kernel_envelope_refuses(case):
    *args, match = KERNEL_FAULTS[case]
    with pytest.raises(ValueError, match=match):
        ss.check_kernel_shapes(*args)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("width", [(360, 12), (120, 4)], ids=["MambaIR", "MambaIR-light"])
def test_kernel_envelope_takes_the_published_widths(width, dtype):
    d, r = width
    ss.check_kernel_shapes((8, 180, 320, d), r, 16, dtype)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("rank", ss.KERNEL_RANKS)
def test_kernel_envelope_takes_each_rank_it_is_built_for(rank, dtype):
    """The checks let each rank of ``KERNEL_RANKS`` through, at a D that is no
    multiple of 16; that the kernel has an instantiation of each is what the
    card cases show (``CARD_CASES`` runs every rank in bf16 and fp32)."""
    ss.check_kernel_shapes((1, 3, 5, 24), rank, 16, dtype)


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def held(got, want, dtype):
    """bf16: each value within one bf16 ulp of the plain version's, above a
    floor of 1e-3 of the largest |y|; fp32: 1e-5 of the largest |y|. The
    kernel's exponentials are ex2.approx (2^-22 relative) and its fp32 sums
    run in another order: at the published SS2D its fp32 y reads ~3e-7 of
    the largest |y| off the plain version's, and in bf16 no value lies past
    one ulp above a floor of 1e-4 of it (NVIDIA H100, the first card runs of
    this kernel), so both limits leave ten times and more of room."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    if dtype == BF16:
        ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want.float().abs()).exponent - 8)
        assert (err <= torch.clamp_min(ulp, 1e-3 * scale)).all()
    else:
        assert err.max().item() <= 1e-5 * scale


# the published SS2D; maps shorter than a chunk; L not a multiple of the
# 32-step chunk (65 = two chunks and one step, 97 = three and one, the middle
# step 48 inside the second); D = 8 (one group), 24 and 40 (no multiple of
# 16), 120 (MambaIR-light); every rank 4, 8, 12, 16; batches of 1, 2 and 3
CARD_CASES = [(8, 180, 320, 360, 12, 16), (1, 7, 5, 8, 12, 16), (2, 3, 4, 40, 4, 16),
              (1, 33, 65, 120, 4, 16), (3, 1, 1, 16, 16, 16), (1, 1, 65, 8, 16, 16),
              (3, 97, 1, 24, 8, 16), (1, 13, 5, 8, 8, 16), (3, 20, 24, 120, 12, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CARD_CASES, ids=["x".join(map(str, c)) for c in CARD_CASES])
def test_kernel_matches_the_plain_version(case, dtype):
    """The published SS2D (8 x 180 x 320, D 360, R 12, N 16) and small maps:
    D not a multiple of 32 (the last block's idle lanes), maps shorter than
    a chunk and one token, non-square maps."""
    _card()
    args = _inputs(*case, seed=sum(case), device="cuda", dtype=dtype)
    launches = ss.selective_scan.launches
    got = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == launches + 1
    held(got, ss.selective_scan_reference(*args), dtype)
    assert torch.equal(got, ss.selective_scan(*args))  # run to run


#: share of the bf16 kernel's values at the published SS2D that may differ
#: from the plain version's fp32 y on the same inputs rounded once to bf16
BF16_OFF_SHARE = 1.6e-4


@pytest.mark.cuda
def test_kernel_keeps_fp32_deltas_in_bf16():
    """In bf16 the kernel projects dt on the tensor cores, dt_w split in three
    bf16 parts; its y has to round as the fp32 plain version's does. On the
    published SS2D (seeds 2800000404, -505, -606; NVIDIA H100) the share of
    values off the plain version's rounded y read 1.11e-4 to 1.12e-4, the
    deltas by fp32 FMAs 1.07e-4; two parts of dt_w 2.22e-4 to 2.25e-4, one
    part 0.057 to 0.061, every delta 1e-5 too large 9.8e-4 to 1.01e-3, the
    deltas rounded to bf16 0.103 to 0.106. The limit lies between three parts
    and two."""
    _card()
    u, xdbl, *rest = _inputs(8, 180, 320, 360, 12, 16, seed=2800000404, device="cuda", dtype=BF16)
    got = ss.selective_scan(u, xdbl, *rest)
    want = ss.selective_scan_reference(u.float(), xdbl.float(), *rest).to(BF16)
    assert (got != want).float().mean().item() <= BF16_OFF_SHARE


@pytest.mark.cuda
def test_kernel_drops_the_carry_as_the_plain_version(monkeypatch):
    _card()
    monkeypatch.setattr(ss, "CARRY", False)
    args = _inputs(1, 20, 24, 40, 4, 16, seed=3, device="cuda")
    held(ss.selective_scan(*args), ss.selective_scan_reference(*args), F32)


@pytest.mark.cuda
def test_kernel_rounds_the_state_when_planted(monkeypatch):
    """The planted bf16 state (the benchmark's control) moves the kernel's
    fp32 output as it moves the plain version's, within a factor of 4, and far
    past the fp32 limit; the plain version rounds only its chunks' walks, so
    the two faults are not compared value by value (on small maps the
    kernel's moves by 0.5e-3 to 1e-3 of the largest |y|, 0.5 to 1.8 times the
    plain version's)."""
    _card()
    args = _inputs(1, 20, 24, 40, 4, 16, seed=3, device="cuda")
    base, ref = ss.selective_scan(*args), ss.selective_scan_reference(*args)
    monkeypatch.setattr(ss, "STATE_BF16", True)
    fault, ref_fault = ss.selective_scan(*args), ss.selective_scan_reference(*args)
    assert torch.equal(fault, ss.selective_scan(*args))
    scale = ref.abs().max().item()
    moved = (fault - base).abs().max().item() / scale
    plain_moved = (ref_fault - ref).abs().max().item() / scale
    assert moved > 1e-4 and 0.25 < moved / plain_moved < 4


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_the_card():
    _card()
    args = _inputs(1, 2, 3, 16, 4, 8, seed=1, device="cuda", dtype=BF16)
    with pytest.raises(ValueError, match="N = 16"):
        ss.selective_scan(*args)
    args = _inputs(1, 2, 3, 12, 4, 16, seed=1, device="cuda", dtype=BF16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ss.selective_scan(*args)
    u, xdbl, *rest = _inputs(1, 2, 3, 16, 4, 16, seed=1, device="cuda", dtype=BF16)
    with pytest.raises(ValueError, match="u's"):
        ss.selective_scan(u, xdbl.float(), *rest)
