"""`pyramid_route`, the conv pyramid forward's route and launch plan, on the
CPU: which kernels a pyramid takes, that each plan fits an SM and covers
every output, and a plain model of the TMA addressing the "wgmma" kernels
read layers 3..L with (`csrc/conv_pyramid.cu`), held against
`conv_pyramid_reference`. The `cuda`-marked twins run the route on the card
against the plain version and skip here:

    python -m pytest tests/test_torch_port_conv_route.py -q            # CPU
    python -m pytest tests/test_torch_port_conv_route.py -q -m cuda \\
        --noconftest                                                  # card
"""

import numpy as np
import pytest
import torch

from cpc_tpu_torch.ops.conv_cuda import (EMPTY_ROW, MAX_SMEM, WGMMA_TILE,
                                         conv_pyramid_forward,
                                         conv_pyramid_reference,
                                         pyramid_route, same_padding)

FULL = ((512,) * 5, (10, 8, 4, 4, 4), (5, 4, 2, 2, 2))  # tpu_fast
NARROW = ((32, 32, 48), (10, 8, 4), (5, 4, 2))
SHAPES = [(64, 20480), (16, 163840), (2, 20000)]
# chip_smoke.py phase 14's cases: (spec, B, S, dtype)
CARD_CASES = [(FULL, 64, 20480, torch.bfloat16),
              (FULL, 64, 20480, torch.float32),
              (FULL, 16, 163840, torch.bfloat16),
              (NARROW, 3, 3205, torch.bfloat16),
              (NARROW, 3, 3205, torch.float32),
              (FULL, 2, 20000, torch.bfloat16),
              (FULL, 1, 20, torch.bfloat16)]
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _route(spec, B, S, dtype, aligned=True):
    channels, kernels, strides = spec
    return pyramid_route(kernels, strides, channels, B, S, dtype, aligned)


@pytest.mark.parametrize("spec", [FULL, NARROW], ids=["full", "narrow"])
@pytest.mark.parametrize("dtype,aligned,want", [
    (torch.bfloat16, True, "wgmma"), (torch.float32, True, "simt"),
    (torch.bfloat16, False, "simt"), (torch.float32, False, "simt")])
def test_route_by_dtype_and_pointer_alignment(spec, dtype, aligned, want):
    route = _route(spec, 3, 3205, dtype, aligned)
    assert route.route == want
    n = len(spec[1])
    assert [launch.layers for launch in route.launches] == (
        [(0, 1)] + [(i,) for i in range(2, n)])


@pytest.mark.parametrize("channels,want", [
    ((16, 24, 40), "wgmma"), ((20, 33, 48), "simt"), ((32, 36, 48), "simt"),
    ((32, 32, 44), "simt"), ((8, 8, 8), "wgmma")])
def test_route_by_channel_alignment(channels, want):
    assert _route((channels, (10, 8, 4), (5, 4, 2)), 2, 4000,
                  torch.bfloat16).route == want


@pytest.mark.parametrize("kernels,strides,want", [
    ((20, 8, 4), (5, 4, 2), "simt"),    # layer 1 beyond one k16 step
    ((16, 8, 4), (5, 4, 2), "wgmma"),
    ((10, 8, 4), (5, 4, 9), "simt"),    # 9 phases: more maps than a launch
    ((10, 40, 4), (5, 4, 2), "simt"),   # more taps than the table
    ((10,), (5,), "simt")])             # one layer: its C_in is 1
def test_route_by_kernel_and_stride(kernels, strides, want):
    channels = (64,) * len(kernels)
    assert pyramid_route(kernels, strides, channels, 2, 8000,
                         torch.bfloat16).route == want


@pytest.mark.parametrize("args,error", [
    (((10, 8), (5, 4), (16, 16), 2, 800, torch.float16), TypeError),
    (((10, 8), (5, 4), (16, 16), 0, 800, torch.float32), ValueError),
    (((10, 8), (5, 4), (16,), 2, 800, torch.float32), ValueError),
    (((10, 0), (5, 4), (16, 16), 2, 800, torch.float32), ValueError),
    # the fused SIMT kernel's waveform window does not fit an SM
    (((4000, 8), (4000, 4), (16, 16), 1, 10 ** 6, torch.float32),
     ValueError)])
def test_route_raises_on_what_no_kernel_takes(args, error):
    with pytest.raises(error):
        pyramid_route(*args)


@pytest.mark.parametrize("B,S", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plans_fit_and_cover_every_output(B, S, dtype):
    channels, kernels, strides = FULL
    route = _route(FULL, B, S, dtype)
    t = S
    lengths = []
    for s in strides:
        t = -(-t // s)
        lengths.append(t)
    for launch in route.launches:
        i = launch.layers[-1]
        rows, chans = launch.tile
        gx, gy, gz = launch.grid
        assert launch.smem + (0 if route.route == "wgmma" else 8320) \
            <= MAX_SMEM
        assert gz == B
        assert gx * chans >= channels[i] > (gx - 1) * chans
        assert gy * rows >= lengths[i] > (gy - 1) * rows
        if route.route == "wgmma":
            assert launch.tile == WGMMA_TILE and launch.stages >= 2
            assert len(launch.taps) == kernels[i]


@pytest.mark.parametrize("k,s", [(8, 4), (4, 2), (10, 5), (3, 1), (5, 3)])
def test_fused_taps_read_layer_two_rows_from_the_slab(k, s):
    """Tap j of the fused launch reads slots phase RP + row + m: the slot of
    local layer-1 row s m + j in the slab's phase-major order."""
    route = pyramid_route((10, k), (5, s), (8, 8), 2, 4000, torch.bfloat16)
    launch = route.launches[0]
    RP = WGMMA_TILE[0] + (k - 1) // s
    for j, (phase, row) in enumerate(launch.taps):
        for m in (0, 1, 63, 127):
            l = s * m + j
            assert (l % s) * RP + l // s == phase * RP + row + m
            assert phase * RP + row + m < s * RP


def _phase_tiles_layer(h, w, b, taps, s, t_out):
    """Layer i from its input h (B, T_in, C_in) as the wgmma kernel reads
    it: tap j's A tile is rows t + row of phase `phase` (h[:, phase::s]),
    zeros outside; the taps' fp32 products summed in order, then bias and
    ReLU."""
    B, _, c_in = h.shape
    acc = torch.zeros((B, t_out, w.shape[0]), dtype=torch.float32)
    for j, (phase, row) in enumerate(taps):
        ph = h[:, phase::s].float()
        tile = torch.zeros((B, t_out, c_in), dtype=torch.float32)
        for t in range(t_out):
            u = t + row
            if 0 <= u < ph.shape[1]:
                tile[:, t] = ph[:, u]
        acc += tile @ w[:, :, j].float().T
    return torch.relu(acc + b.float())


@pytest.mark.parametrize("t2", [1, 12, 13, 15])
@pytest.mark.parametrize("k,s", [(8, 4), (4, 2), (10, 5), (3, 1), (5, 3)])
def test_tma_addressing_model_matches_the_reference(k, s, t2):
    """Layer 3 through the plan's (phase, row offset) table equals the
    plain version, at input lengths t2 that do and do not divide s (t2 = 1 <
    s: phases with no rows, whose boxes read zeros)."""
    spec = ((8, 8, 8), (10, 8, k), (5, 4, s))
    channels, kernels, strides = spec
    S = 20 * t2  # layer 1: 4 t2 rows, layer 2: t2
    route = _route(spec, 2, S, torch.bfloat16)
    assert route.route == "wgmma"
    taps = route.launches[1].taps
    pad = same_padding(t2, k, s)[0]
    for j, (phase, row) in enumerate(taps):
        assert phase == (j - pad) % s
        assert row == ((j - pad) // s if phase < t2 else EMPTY_ROW)
    rng = np.random.default_rng(k * 10 + s + t2)
    x = torch.from_numpy(rng.standard_normal((2, S))).float()
    weights, biases, c_in = [], [], 1
    for ch, kk in zip(channels, kernels):
        weights.append(torch.from_numpy(
            rng.standard_normal((ch, c_in, kk)) / np.sqrt(c_in * kk)).float())
        biases.append(torch.from_numpy(rng.standard_normal(ch) * 0.1).float())
        c_in = ch
    h2 = conv_pyramid_reference(x, weights[:2], biases[:2], kernels[:2],
                                strides[:2])
    assert h2.shape[1] == t2
    got = _phase_tiles_layer(h2, weights[2], biases[2], taps, s, -(-t2 // s))
    want = conv_pyramid_reference(x, weights, biases, kernels, strides)
    assert got.shape == want.shape
    err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
    assert err <= 1e-6


# ----------------------------------------------------------- on the card
def _card_inputs(spec, B, S, dtype, seed):
    channels, kernels, strides = spec
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a).to("cuda", dtype).contiguous()
    weights, biases, c_in = [], [], 1
    for ch, k in zip(channels, kernels):
        weights.append(dev(rng.standard_normal((ch, c_in, k))
                           * np.sqrt(2.0 / (c_in * k))))
        biases.append(dev(rng.standard_normal(ch) * 0.1))
        c_in = ch
    return dev(rng.standard_normal((B, S))), weights, biases, kernels, strides


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_route_on_the_card_matches_plain_and_repeats(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec, B, S, dtype = CARD_CASES[case]
    args = _card_inputs(spec, B, S, dtype, seed=60 + case)
    route = _route(spec, B, S, dtype)
    assert route.route == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = conv_pyramid_forward.launches
    with torch.inference_mode():
        z = conv_pyramid_forward(*args)
        again = conv_pyramid_forward(*args)
        want = conv_pyramid_reference(*args)
    torch.cuda.synchronize()
    assert conv_pyramid_forward.launches == before + 2
    assert z.dtype == dtype and z.shape == want.shape and z.is_contiguous()
    assert torch.equal(z, again)
    scale = max(1.0, want.float().abs().max().item())
    for rows in (slice(None), slice(0, 2), slice(-2, None)):
        err = (z[:, rows].float() - want[:, rows].float()).abs().max().item()
        assert err / scale <= CARD_TOL[dtype]
