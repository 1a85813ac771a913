"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``: the kernels have no CPU mode,
so they skip elsewhere. The file imports neither JAX nor the JAX package,
so the card's machine runs it without them:

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_port_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import config, train
from rcvpose_tpu_torch.ops import epilogue, heads, mmconv, vote_cuda, voting

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _band_problem(seed, b, n, v, side=32):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(2, side - 2, size=(b, n, 3)).astype(np.float32)
    radii = np.round(rng.uniform(1, 9, size=(b, n))).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.9  # ~10% masked: lo = hi = 0
    vox = rng.uniform(0, side, size=(b, v, 3)).astype(np.float32)
    return [torch.tensor(x) for x in (pts, radii, mask, vox)]


@pytest.mark.parametrize("b,n,v", [(3, 2500, 3000), (1, 1, 1),
                                   (2, 1025, 257)])
def test_vote_counts_cuda_matches_plain(cuda, b, n, v):
    """K1 equals its plain version exactly, batched and shared voxels,
    ragged tile and chunk edges included."""
    pts, radii, mask, vox = _band_problem(0, b, n, v)
    lo, hi = voting.exact_band(radii, mask)
    args = [t.to(cuda) for t in (vox, pts, lo, hi)]
    before = vote_cuda.vote_counts_cuda.launches
    got = vote_cuda.vote_counts_cuda(*args)
    shared = vote_cuda.vote_counts_cuda(args[0][0], *args[1:])
    torch.cuda.synchronize()
    assert vote_cuda.vote_counts_cuda.launches == before + 2
    torch.testing.assert_close(got, vote_cuda.vote_counts_plain(*args),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        shared, vote_cuda.vote_counts_plain(args[0][0], *args[1:]),
        rtol=0, atol=0)
    # the dispatcher sends CUDA tensors to the kernel
    torch.testing.assert_close(voting.vote_counts(*args), got, rtol=0,
                               atol=0)


def test_vote_counts_cuda_takes_strided_points(cuda):
    pts, radii, mask, vox = _band_problem(1, 3, 4000, 500)
    lo, hi = voting.exact_band(radii, mask)
    vox, pts, lo, hi = (t.to(cuda) for t in (vox, pts, lo, hi))
    got = vote_cuda.vote_counts_cuda(vox, pts[:, ::8], lo[:, ::8],
                                     hi[:, ::8])
    want = vote_cuda.vote_counts_plain(vox, pts[:, ::8].contiguous(),
                                       lo[:, ::8].contiguous(),
                                       hi[:, ::8].contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# (seed, B, N, V, side): V and N off every tile's multiple (chunks of
# 256-2048 points, blocks of 128-2048 voxels), a single pair, and a
# grid-192 scale where the d2 forms round.
VARIANT_CASES = [(2, 3, 2501, 3001, 32), (3, 1, 1, 1, 32),
                 (4, 3, 1025, 257, 32), (5, 3, 777, 2049, 192)]


def _variant_args(cuda, seed, b, n, v, side):
    pts, radii, mask, vox = _band_problem(seed, b, n, v, side)
    lo, hi = voting.widened_band(radii, mask, 4.2)
    return [t.to(cuda) for t in (vox, pts, lo, hi)]


@pytest.mark.parametrize("tile", vote_cuda.TILES, ids=str)
def test_vote_counts_cuda_every_tile_matches_plain(cuda, tile):
    """Every tile of K1 equals the plain version exactly, per-batch and
    shared voxels, on ragged V and N."""
    for case in VARIANT_CASES:
        args = _variant_args(cuda, *case)
        before = vote_cuda.vote_counts_cuda.tiled_launches
        got = vote_cuda.vote_counts_cuda(*args, tile=tile)
        shared = vote_cuda.vote_counts_cuda(args[0][0], *args[1:], tile=tile)
        torch.cuda.synchronize()
        assert vote_cuda.vote_counts_cuda.tiled_launches == before + 2
        assert torch.equal(got, vote_cuda.vote_counts_plain(*args)), case
        assert torch.equal(shared, vote_cuda.vote_counts_plain(
            args[0][0], *args[1:])), case


def test_vote_counts_cuda_refuses_unbuilt_tile(cuda):
    args = _variant_args(cuda, *VARIANT_CASES[0])
    with pytest.raises(ValueError, match="tile"):
        vote_cuda.vote_counts_cuda(*args, tile=(1024, 1, 256))


# K1's split branches on a (3, 4096, 8155) problem (N off every chunk and
# split multiple): the planner's split, one split (stores, no atomics), 2
# and 7 splits, splits of 32 and 1001 points; and the planner on shared
# voxels
SPLIT_CASES = ["planner", "one", 2, 7, "32", "1001", "shared"]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_vote_counts_cuda_every_split_branch(cuda, case):
    """K1 equals its plain version exactly at each branch of its point
    split, and two runs agree bit for bit (the split blocks' atomic adds
    are of integers below 2^24)."""
    pts, radii, mask, vox = _band_problem(6, 3, 8155, 4096)
    lo, hi = voting.exact_band(radii, mask)
    args = [t.to(cuda) for t in (vox, pts, lo, hi)]
    n = args[1].shape[1]
    split = {"planner": None, "one": n, 2: -(-n // 2), 7: -(-n // 7),
             "32": 32, "1001": 1001, "shared": None}[case]
    if case == "shared":
        args[0] = args[0][0]
    got = vote_cuda.vote_counts_cuda(*args, split=split)
    again = vote_cuda.vote_counts_cuda(*args, split=split)
    torch.cuda.synchronize()
    assert torch.equal(got, vote_cuda.vote_counts_plain(*args))
    assert torch.equal(again, got)


def test_vote_counts_cuda_refuses_2_24_points(cuda):
    args = [torch.zeros(s, device=cuda) for s in ((4, 3), (1, 1 << 24, 3),
                                                   (1, 1 << 24),
                                                   (1, 1 << 24))]
    with pytest.raises(ValueError, match="2\\^24"):
        vote_cuda.vote_counts_cuda(*args)


# K1's live-point bounds (n_live) on a (3, 2501, 3001) problem whose points
# at or past each row's bound are masked: none, one, a few, a warp of
# points either side, all but one, all, and rows of one batch that differ
LIVE_N = 2501
LIVE_BOUNDS = [(0, 0, 0), (1, 1, 1), (3, 3, 3), (31, 31, 31), (33, 33, 33),
               (LIVE_N - 1,) * 3, (LIVE_N,) * 3, (0, 33, LIVE_N),
               (31, LIVE_N - 1, 1)]


def _live_problem(cuda, bounds, seed=7, v=3001):
    """``_band_problem``'s tensors on the card, each row masked from its
    bound on (so the bound keeps its promise), and the mask."""
    pts, radii, mask, vox = _band_problem(seed, len(bounds), LIVE_N, v)
    mask &= torch.arange(LIVE_N)[None] < torch.tensor(bounds)[:, None]
    lo, hi = voting.exact_band(radii, mask)
    return [t.to(cuda) for t in (vox, pts, lo, hi, mask)]


@pytest.mark.parametrize("tile", vote_cuda.TILES, ids=str)
def test_vote_counts_cuda_live_bound_is_bit_equal(cuda, tile):
    """K1 given each row's live-point bound equals K1 without it bit for
    bit, at every tile, at the planner's split and at forced splits of 32,
    1001 and N points, per-batch and shared voxels, and equals the plain
    version; ``live_bounded`` counts the launches given a bound."""
    for bounds in LIVE_BOUNDS:
        vox, pts, lo, hi, mask = _live_problem(cuda, bounds)
        n_live = torch.tensor(bounds, dtype=torch.int32, device=cuda)
        assert bool((voting.live_extent(mask) <= n_live).all())
        want = vote_cuda.vote_counts_plain(vox, pts, lo, hi)
        for voxels in (vox, vox[0]):
            for split in (None, 32, 1001, LIVE_N):
                full = vote_cuda.vote_counts_cuda(voxels, pts, lo, hi,
                                                  tile=tile, split=split)
                before = vote_cuda.vote_counts_cuda.live_bounded
                got = vote_cuda.vote_counts_cuda(voxels, pts, lo, hi,
                                                 tile=tile, split=split,
                                                 n_live=n_live)
                torch.cuda.synchronize()
                assert vote_cuda.vote_counts_cuda.live_bounded == before + 1
                case = (bounds, voxels.dim(), split)
                assert torch.equal(got, full), case
                if voxels.dim() == 3:
                    assert torch.equal(got, want), case


def test_vote_counts_cuda_graph_replays_each_calls_bound(cuda):
    """One CUDA graph of ``voting.vote_counts`` (K1 given the bound it
    derives on the card from ``hi``) captured at one call's bounds,
    replayed on calls with other bounds, smaller and larger, equals the
    eager unbounded counts each time."""
    from rcvpose_tpu_torch import profiling
    from rcvpose_tpu_torch.models import graphs

    cache = graphs.GraphCache(graphs.GraphPool(), "k1_live")

    before = profiling.counters()
    live = vote_cuda.vote_counts_cuda.live_bounded
    cases = [(1200, 1200, 1200), (0, 33, LIVE_N), (LIVE_N,) * 3,
             (31, 2000, 7)]
    with torch.inference_mode():
        for seed, bounds in enumerate(cases, 20):
            args = _live_problem(cuda, bounds, seed)
            got = cache("k1", voting.vote_counts, args[:4])
            want = vote_cuda.vote_counts_cuda(*args[:4])
            torch.cuda.synchronize()
            assert torch.equal(got, want), bounds
    after = profiling.counters()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in (
        "k1_live.captured", "k1_live.replayed")} == {
            "k1_live.captured": 1, "k1_live.replayed": len(cases) - 1}
    assert vote_cuda.vote_counts_cuda.live_bounded == live + len(cases)


@pytest.mark.parametrize("case", VARIANT_CASES, ids=str)
def test_vote_counts_mxu_cuda_matches_plain(cuda, case):
    """K5 equals its own plain version exactly (never K1: the matmul
    form's cancellation moves band-edge pairs); the dispatcher's
    ``mxu=True`` reaches it."""
    args = _variant_args(cuda, *case)
    before = vote_cuda.vote_counts_mxu_cuda.launches
    got = vote_cuda.vote_counts_mxu_cuda(*args)
    shared = vote_cuda.vote_counts_mxu_cuda(args[0][0], *args[1:])
    via = voting.vote_counts(*args, mxu=True)
    torch.cuda.synchronize()
    assert vote_cuda.vote_counts_mxu_cuda.launches == before + 3
    assert torch.equal(got, vote_cuda.vote_counts_mxu_plain(*args))
    assert torch.equal(shared, vote_cuda.vote_counts_mxu_plain(
        args[0][0], *args[1:]))
    assert torch.equal(via, got)


@pytest.mark.parametrize("compare", ["f32", "bf16"])
@pytest.mark.parametrize("case", VARIANT_CASES, ids=str)
def test_vote_counts_bf16_cuda_matches_plain(cuda, case, compare):
    """K6 equals its plain version's separate bf16 tensor ops exactly, in
    both compare modes; odd chunks end on a masked pair lane."""
    args = _variant_args(cuda, *case)
    before = vote_cuda.vote_counts_bf16_cuda.launches
    got = vote_cuda.vote_counts_bf16_cuda(*args, compare)
    shared = vote_cuda.vote_counts_bf16_cuda(args[0][0], *args[1:], compare)
    torch.cuda.synchronize()
    assert vote_cuda.vote_counts_bf16_cuda.launches == before + 2
    assert torch.equal(got, vote_cuda.vote_counts_bf16_plain(*args, compare))
    assert torch.equal(shared, vote_cuda.vote_counts_bf16_plain(
        args[0][0], *args[1:], compare))


# K6's split branches on the same (3, 4096, 8155) problem: the planner's,
# one split, 2 and 7 splits, splits of 32 and 1001 points, the largest split
# a block takes (one block of 8155), and the planner on shared voxels
K6_SPLIT_CASES = ["planner", "one", 2, 7, "32", "1001", "shared"]


@pytest.mark.parametrize("compare", ["f32", "bf16"])
@pytest.mark.parametrize("case", K6_SPLIT_CASES, ids=str)
def test_vote_counts_bf16_cuda_every_split_branch(cuda, case, compare):
    """K6 equals its plain version exactly at each branch of its point
    split, in both compares, and two runs agree bit for bit."""
    pts, radii, mask, vox = _band_problem(6, 3, 8155, 4096)
    lo, hi = voting.widened_band(radii, mask, 4.2)
    args = [t.to(cuda) for t in (vox, pts, lo, hi)]
    n = args[1].shape[1]
    split = {"planner": None, "one": n, 2: -(-n // 2), 7: -(-n // 7),
             "32": 32, "1001": 1001, "shared": None}[case]
    if case == "shared":
        args[0] = args[0][0]
    before = vote_cuda.vote_counts_bf16_cuda.bf16_compare_launches
    got = vote_cuda.vote_counts_bf16_cuda(*args, compare, split=split)
    again = vote_cuda.vote_counts_bf16_cuda(*args, compare, split=split)
    torch.cuda.synchronize()
    assert vote_cuda.vote_counts_bf16_cuda.bf16_compare_launches == before + (
        2 if compare == "bf16" else 0)
    assert torch.equal(got, vote_cuda.vote_counts_bf16_plain(*args, compare))
    assert torch.equal(again, got)


def test_vote_counts_bf16_cuda_band_edges(cuda):
    """The f32 compare at its edges: each point's lo and hi sit on the bf16
    d2 of a random voxel, one f32 ulp either side of it, or halfway to the
    next bf16 value, so the kernel's outward-rounded bf16 band meets every
    case of its identity; it must count exactly what the plain version's
    f32 compare counts, at one split and at several."""
    rng = np.random.default_rng(8)
    b, n, v = 2, 3001, 700
    pts = torch.tensor(rng.uniform(0, 24, size=(b, n, 3)), dtype=torch.float32)
    vox = torch.tensor(rng.uniform(0, 24, size=(b, v, 3)), dtype=torch.float32)
    bf = torch.bfloat16
    d2 = vote_cuda._d2_subtract_square(pts.to(bf))(vox.to(bf), 0, n)
    d2 = d2.float().numpy()  # (b, v, n), each a bf16 value
    edges = []
    for _ in range(2):
        e = np.take_along_axis(d2, rng.integers(0, v, size=(b, 1, n)), 1)[:, 0]
        bits = e.view(np.uint32)
        variants = np.stack([e, np.nextafter(e, np.float32(np.inf)),
                             np.nextafter(e, np.float32(-np.inf)),
                             (bits + np.uint32(0x8000)).view(np.float32)])
        pick = rng.integers(0, 4, size=(1, b, n))
        edges.append(np.take_along_axis(variants, pick, 0)[0])
    lo, hi = np.minimum(*edges), np.maximum(*edges)
    args = [t.to(cuda) for t in (vox, pts, torch.tensor(lo), torch.tensor(hi))]
    want = vote_cuda.vote_counts_bf16_plain(*args, "f32")
    for split in (None, 512, n):
        got = vote_cuda.vote_counts_bf16_cuda(*args, "f32", split=split)
        assert torch.equal(got, want), split
    assert float(want.sum()) > 0


def test_vote_counts_bf16_cuda_refuses_what_it_cannot_count(cuda):
    """2^24 points (f32 sums of counts stop being exact), and a split past
    the 2 x 65535 points a block's 16-bit lane counts hold."""
    args = [torch.zeros(s, device=cuda) for s in ((4, 3), (1, 1 << 24, 3),
                                                   (1, 1 << 24),
                                                   (1, 1 << 24))]
    with pytest.raises(ValueError, match="2\\^24"):
        vote_cuda.vote_counts_bf16_cuda(*args)
    n = vote_cuda.K6_MAX_SPLIT + 1
    args = [torch.zeros(s, device=cuda) for s in ((4, 3), (1, n, 3), (1, n),
                                                   (1, n))]
    with pytest.raises(ValueError, match="at most"):
        vote_cuda.vote_counts_bf16_cuda(*args, split=n)
    got = vote_cuda.vote_counts_bf16_cuda(*args)
    assert torch.equal(got, torch.zeros(1, 4, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_heads_channel_major_cuda_matches_plain(cuda, dtype, channels_last):
    """K2 equals its plain version bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 6, 48, 64, device=cuda, generator=g).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    before = heads.heads_channel_major_cuda.launches
    got = heads.heads_channel_major_cuda(x)
    torch.cuda.synchronize()
    assert heads.heads_channel_major_cuda.launches == before + 1
    torch.testing.assert_close(got, heads.heads_channel_major_plain(x),
                               rtol=0, atol=0)


def _heads_input(kind, c, dtype, channels_last, dev, gen, b=2, h=24, w=64):
    """conv8's output (b, c, h, w) laid out as ``kind``: contiguous NCHW or
    channels-last, a width off a multiple of 8, a contiguous view one
    element past a 16-byte boundary, or a strided view."""
    w = w - 3 if kind == "W % 8 != 0" else w
    shape = (b, h, w, c) if channels_last else (b, c, h, w)
    to_bchw = (0, 3, 1, 2) if channels_last else (0, 1, 2, 3)
    if kind == "misaligned":
        x = torch.randn(b * c * h * w + 1, device=dev, generator=gen).to(
            dtype)[1:].view(shape)
    elif kind == "strided":
        x = torch.randn(*shape[:-2], shape[-1], shape[-2], device=dev,
                        generator=gen).to(dtype).transpose(-1, -2)
    else:
        x = torch.randn(*shape, device=dev, generator=gen).to(dtype)
    return x.permute(*to_bchw)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["contiguous", "W % 8 != 0", "misaligned",
                                  "strided"])
@pytest.mark.parametrize("c", [2, 6])
def test_heads_cuda_every_branch(cuda, c, kind, dtype, channels_last):
    """K2 bit for bit at each branch and layout: the vectorized rows
    (channels-last) and planes (NCHW) branches, their scalar runs (a width
    off a multiple of 8, a base one element past a 16-byte boundary), the
    generic branch from a strided view; repeatable."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = _heads_input(kind, c, dtype, channels_last, cuda, g)
    assert x.shape[:2] == (2, c)
    want_branch = ("generic" if kind == "strided"
                   else "rows" if channels_last else "planes")
    assert heads.fwd_branch(x) == want_branch
    got = heads.heads_channel_major_cuda(x)
    again = heads.heads_channel_major_cuda(x)
    want = heads.heads_channel_major_plain(x)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.parametrize("cotangent", ["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_heads_bwd_cuda_matches_plain(cuda, dtype, channels_last, cotangent):
    """K2's backward equals ``g.permute(1, 0, 2, 3).to(dtype)`` bit for bit,
    in the requested layout, from contiguous and strided cotangents."""
    g = torch.Generator(device=cuda).manual_seed(1)
    ct = torch.randn(6, 3, 37, 53, device=cuda, generator=g)
    if cotangent == "strided":
        ct = torch.randn(6, 3, 53, 37, device=cuda,
                         generator=g).transpose(2, 3)
    before = heads.heads_channel_major_bwd_cuda.launches
    got = heads.heads_channel_major_bwd_cuda(ct, dtype, channels_last)
    torch.cuda.synchronize()
    assert heads.heads_channel_major_bwd_cuda.launches == before + 1
    want = heads.heads_channel_major_bwd_plain(ct, dtype, channels_last)
    assert got.dtype == dtype and got.stride() == want.stride()
    assert torch.equal(got, want)
    assert torch.equal(got.float(), ct.permute(1, 0, 2, 3).to(dtype).float())


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["contiguous", "W % 8 != 0", "misaligned",
                                  "strided"])
@pytest.mark.parametrize("c", [2, 6])
def test_heads_bwd_cuda_every_branch(cuda, c, kind, dtype, channels_last):
    """K2's backward bit for bit at each branch and layout: the vectorized
    rows (channels-last) and planes (NCHW) branches from a contiguous g,
    their scalar runs (a width off a multiple of 8, a base 4 bytes past a
    16-byte boundary), the generic branch from a strided g; repeatable."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, h, w = 2, 24, 61 if kind == "W % 8 != 0" else 64
    if kind == "misaligned":
        ct = torch.randn(c * b * h * w + 1, device=cuda,
                         generator=g)[1:].view(c, b, h, w)
    elif kind == "strided":
        ct = torch.randn(c, b, w, h, device=cuda, generator=g).transpose(2, 3)
    else:
        ct = torch.randn(c, b, h, w, device=cuda, generator=g)
    want_branch = ("generic" if kind == "strided"
                   else "rows" if channels_last else "planes")
    assert heads.bwd_branch(ct, channels_last) == want_branch
    got = heads.heads_channel_major_bwd_cuda(ct, dtype, channels_last)
    again = heads.heads_channel_major_bwd_cuda(ct, dtype, channels_last)
    want = heads.heads_channel_major_bwd_plain(ct, dtype, channels_last)
    torch.cuda.synchronize()
    assert got.stride() == want.stride()
    assert torch.equal(got, want) and torch.equal(again, got)


# (B, H, W, C, D, K): H, W and C off the tiles' multiples, channel counts
# that the bf16 wrappers pad to multiples of 8 (5, 6, 130; 7, 3, 70), K = 5,
# a long reduction (9 * 2048 products per output, as at conv_up4), and one
# shape for each branch of the planner: split-K (conv_up5-like), N = 192
# (conv_up1's dx), a 32-channel reduction (conv7's dx), and the tap-fused
# K4 tiles (9 taps with the consumers splitting the pixels; 3 taps)
CONV_SHAPES = [(2, 17, 23, 5, 7, 3), (1, 20, 16, 6, 3, 5),
               (2, 9, 13, 130, 70, 3), (2, 15, 20, 136, 72, 3),
               (1, 33, 47, 64, 32, 5), (2, 15, 20, 2048, 64, 3),
               (1, 15, 20, 3072, 256, 3), (2, 24, 40, 64, 192, 3),
               (2, 24, 40, 32, 64, 3), (2, 40, 48, 64, 32, 3),
               (2, 24, 40, 192, 64, 3)]


def _conv_problem(shape, dev, seed=0):
    b, h, w, c, d, k = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, device=dev, generator=g)
    kern = torch.randn(k, k, c, d, device=dev, generator=g) / (k * c ** 0.5)
    gy = torch.randn(b, h, w, d, device=dev, generator=g)
    return x, kern, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_same_cuda_matches_plain(cuda, shape, dtype):
    """K3 against its plain version on the card: f32 (TF32 off) within
    1e-5 of the output's scale (two f32 summation orders); bf16 within one
    bf16 ulp of the plain value, plus the f32 summation-order term where a
    sum cancels to near zero."""
    x, kern, _ = _conv_problem(shape, cuda)
    x, kern = x.to(dtype), kern.to(dtype)
    before = mmconv.conv_same_cuda.launches
    got = mmconv.conv_same_cuda(x, kern)
    again = mmconv.conv_same_cuda(x, kern)
    torch.cuda.synchronize()
    assert mmconv.conv_same_cuda.launches == before + 2
    # fixed-order split reduction, no atomics: bit-identical run to run
    assert torch.equal(got, again)
    want = mmconv.conv_same_plain(x, kern)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
        assert bool((err <= ulp + 1e-5 * scale).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_same_dk_cuda_matches_plain(cuda, shape, dtype):
    """K4 within 1e-4 of dk's scale, and bit-identical from run to run (a
    fixed-order two-pass reduction, no atomics)."""
    x, _, gy = _conv_problem(shape, cuda)
    x, gy = x.to(dtype), gy.to(dtype)
    k = shape[-1]
    got = mmconv.conv_same_dk_cuda(x, gy, k)
    again = mmconv.conv_same_dk_cuda(x, gy, k)
    torch.cuda.synchronize()
    want = mmconv.conv_same_dk_plain(x, gy, k)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_same_dk_cuda_many_slices(cuda, dtype):
    """A long pixel reduction split into many slices (conv7's shape class:
    few channels, many pixels) still matches and repeats exactly."""
    x, _, gy = _conv_problem((2, 96, 128, 16, 8, 3), cuda)
    x, gy = x.to(dtype), gy.to(dtype)
    plan = mmconv.plan_conv(
        "dk", 2, 96, 128, 16, 8, 3, dtype,
        torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.partials > 10
    got = mmconv.conv_same_dk_cuda(x, gy, 3)
    want = mmconv.conv_same_dk_plain(x, gy, 3)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    assert torch.equal(got, mmconv.conv_same_dk_cuda(x, gy, 3))


def test_conv_kernels_take_a_misaligned_base(cuda):
    """bf16 operands that start 2 bytes past a 16-byte boundary (a view at
    offset 1 of a flat buffer) go through the wrapper's aligned copy: K3
    within one bf16 ulp of the plain version, K4 within 1e-4 of its
    scale."""
    b, h, w, c, d = 2, 15, 20, 64, 32
    g = torch.Generator(device=cuda).manual_seed(3)
    buf = torch.randn(1 + b * h * w * c, device=cuda, generator=g)
    x = buf.to(torch.bfloat16)[1:].view(b, h, w, c)
    assert x.data_ptr() % 16 != 0
    kern = (torch.randn(3, 3, c, d, device=cuda, generator=g)
            / (3 * c ** 0.5)).to(torch.bfloat16)
    gy = torch.randn(b, h, w, d, device=cuda, generator=g).to(torch.bfloat16)
    got = mmconv.conv_same_cuda(x, kern)
    want = mmconv.conv_same_plain(x, kern)
    err = (got.float() - want.float()).abs()
    ulp = torch.finfo(torch.bfloat16).eps * want.float().abs()
    assert bool((err <= ulp + 1e-5 * float(want.float().abs().max())).all())
    dk = mmconv.conv_same_dk_cuda(x, gy, 3)
    dk_want = mmconv.conv_same_dk_plain(x, gy, 3)
    assert float((dk - dk_want).abs().max()) <= 1e-4 * float(
        dk_want.abs().max())


@pytest.mark.parametrize("conv_kernel", [False, True])
def test_train_forward_on_card_keeps_heads_differentiable(cuda, conv_kernel):
    """A train-mode forward on the card leaves seg and radial attached to
    the graph (K2 and its backward), and a bf16 step runs every kernel of
    the route: K3 12 times, K4 6 times, K2 and its backward once."""
    cfg = config.Config(image_height=64, image_width=64, initial_lr=1e-3)
    state = train.create_state(cfg, torch.Generator().manual_seed(0),
                               blocks=(1, 1, 1, 1), width=0.125,
                               conv_kernel=conv_kernel)
    x = torch.randn(2, 64, 64, 3, device=cuda)
    state.model.train()
    seg, radial = state.model(x)
    assert seg.requires_grad and radial.requires_grad
    radial = torch.zeros(2, 64, 64, device=cuda)
    radial[:, 16:48, 16:48] = 1.5
    batch = {"image": x, "radial": radial,
             "sem": torch.where(radial > 0, 1.0, -1.0)}
    counters = (mmconv.conv_same_cuda, mmconv.conv_same_dk_cuda,
                heads.heads_channel_major_cuda,
                heads.heads_channel_major_bwd_cuda)
    before = [f.launches for f in counters]
    state, m = train.train_step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    runs = [f.launches - b for f, b in zip(counters, before)]
    assert runs == ([12, 6, 1, 1] if conv_kernel else [0, 0, 1, 1])
    for p in state.model.parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32


def test_remat_step_on_card_keeps_heads_differentiable(cuda, monkeypatch):
    """Under ``Config.remat`` the heads stay attached to the graph through
    K2 and a step launches K2 and its backward once. In f32 (TF32 off,
    deterministic cuDNN) its loss and BN statistics equal the plain
    step's bit for bit, each BN's statistics moved once; its gradients lie
    within twice the plain step's own run-to-run spread (bilinear
    upsampling's backward adds with atomics on the card)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    x = torch.randn(2, 64, 64, 3, device=cuda)
    radial = torch.zeros(2, 64, 64, device=cuda)
    radial[:, 16:48, 16:48] = 1.5
    batch = {"image": x, "radial": radial,
             "sem": torch.where(radial > 0, 1.0, -1.0)}
    counters = (heads.heads_channel_major_cuda,
                heads.heads_channel_major_bwd_cuda)
    out = []
    for remat in (True, False, False):
        cfg = config.Config(image_height=64, image_width=64, initial_lr=1e-3,
                            compute_dtype="float32", remat=remat)
        state = train.create_state(cfg, torch.Generator().manual_seed(0),
                                   blocks=(1, 1, 1, 1), width=0.125)
        if remat:
            with torch.no_grad():
                assert state.model(x)[0].requires_grad is False
            state.model.train()
            seg, rad = state.model(x)
            assert seg.requires_grad and rad.requires_grad
            seg.sum().backward()
            state.optimizer.zero_grad(set_to_none=True)
            for m in state.model.modules():   # undo that forward's update
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.reset_running_stats()
        before = [f.launches for f in counters]
        state, m = train.train_step(state, batch)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [1, 1]
        out.append(({n: p.grad for n, p in state.model.named_parameters()},
                    state.model.state_dict(), float(m["loss"])))
    (g_r, sd_r, l_r), (g_p, sd_p, l_p), (g_q, _, _) = out
    assert l_r == l_p and np.isfinite(l_r)
    top = max(float(g.abs().max()) for g in g_p.values())
    spread = max(float((g_q[n] - g_p[n]).abs().max()) for n in g_p)
    diff = max(float((g_r[n] - g_p[n]).abs().max()) for n in g_p)
    assert diff <= 2 * spread + 1e-6 * top, (diff, spread, top)
    for key, val in sd_p.items():
        if key.endswith("num_batches_tracked"):
            assert int(sd_r[key]) == int(val) == 1, key
        elif "running" in key:
            torch.testing.assert_close(sd_r[key], val, rtol=0, atol=0,
                                       msg=key)


# ---------------------------------------------------------------------------
# The evaluation slice on the card: LMO, CAD labels, the RGB-only keypoint
# ---------------------------------------------------------------------------

LINEMOD_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                      [0.0, 0.0, 1.0]])


def _write_lmo_tree(root, h=120, w=160):
    """A small OCCLUSION_LINEMOD tree for ``ape`` (numpy and PIL only): a
    2-3 cm blob CAD, two posed frames, one without a pose, and the perfect
    ``_NNNNN.npy`` radial maps of the quantized depth."""
    from PIL import Image

    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(2000, 3))
    model_m = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
               * rng.uniform(0.02, 0.03, size=(2000, 1)))
    kpts9 = np.zeros((9, 3))
    kpts9[1:4] = [[0.06, 0.06, 0.06], [-0.06, 0.06, -0.06],
                  [0.06, -0.06, -0.06]]
    pv = root / "LINEMOD" / "ape"
    occ = root / "OCCLUSION_LINEMOD"
    rgb, dep = occ / "RGB-D" / "rgb_noseg", occ / "RGB-D" / "depth_noseg"
    for d in [pv, rgb, dep, occ / "blender_poses" / "ape"] + [
            occ / "estRadialMap" / "ape" / f"Out_pt{kp}_dm"
            for kp in range(1, 4)]:
        d.mkdir(parents=True)
    with open(pv / "ape.ply", "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(model_m)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        f.writelines(f"{x} {y} {z}\n" for x, y, z in model_m)
    np.save(pv / "Outside9.npy", kpts9)
    k = LINEMOD_K
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    for i in range(3):
        c, s = np.cos(0.2 * i), np.sin(0.2 * i)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        z = 0.75 + 0.04 * i
        t = np.array([(80 - k[0, 2]) / k[0, 0] * z,
                      (60 - k[1, 2]) / k[1, 1] * z, z])
        cam = model_m @ rot.T + t
        us = np.round(cam[:, 0] / cam[:, 2] * k[0, 0] + k[0, 2]).astype(int)
        vs = np.round(cam[:, 1] / cam[:, 2] * k[1, 1] + k[1, 2]).astype(int)
        depth = np.zeros((h, w), np.uint16)
        depth[vs, us] = np.round(cam[:, 2] * 1000.0)
        Image.fromarray(depth).save(dep / f"depth_{i:05d}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            rgb / f"color_{i:05d}.png")
        if i == 1:
            continue   # no pose: skipped
        np.save(occ / "blender_poses" / "ape" / f"pose{i}.npy",
                np.concatenate([rot, t[:, None]], axis=1))
        zq = depth.astype(np.float64)
        xyz = np.stack([(uu - k[0, 2]) * zq / k[0, 0],
                        (vv - k[1, 2]) * zq / k[1, 1], zq], -1) / 1000.0
        for kp in range(1, 4):
            r = np.linalg.norm(xyz - (kpts9[kp] @ rot.T + t), axis=-1) * 10
            np.save(occ / "estRadialMap" / "ape" / f"Out_pt{kp}_dm"
                    / f"_{i:05d}.npy", np.where(zq > 0, r, 0.0)
                    .astype(np.float32))


def test_lmo_evaluator_on_card_matches_cpu(cuda, tmp_path):
    """The LMO evaluator (precomputed route) on the card against the CPU:
    the same frames and pass rates, per-frame ADD within 1e-2 mm, and every
    vote through K1."""
    from unittest import mock

    from rcvpose_tpu_torch import eval as eval_mod

    _write_lmo_tree(tmp_path)
    cfg = config.Config(root_dataset=str(tmp_path), using_ckpts=False,
                        compute_dtype="float32", vote_grid_l=96,
                        max_points=2048)
    out = {}
    for dev in ("cpu", "cuda"):
        scores = []
        seq = eval_mod._frame_eval_seq

        def spy(*args, **kwargs):
            res = seq(*args, **kwargs)
            scores.append(res[1:3])
            return res

        before = vote_cuda.vote_counts_cuda.launches
        with mock.patch.object(eval_mod, "_frame_eval_seq", spy):
            res = eval_mod.estimate_6d_pose_lmo(
                cfg, class_names=["ape"], progress=lambda m: None,
                device=dev)["ape"]
        torch.cuda.synchronize()
        out[dev] = (res, scores, vote_cuda.vote_counts_cuda.launches - before)
    (cpu, cpu_scores, cpu_k1), (card, card_scores, card_k1) = (
        out["cpu"], out["cuda"])
    assert card["frames"] == cpu["frames"] == 2
    assert (card["add_before_icp"], card["add_after_icp"]) == (
        cpu["add_before_icp"], cpu["add_after_icp"]) == (1.0, 1.0)
    np.testing.assert_allclose(card_scores, cpu_scores, rtol=0, atol=1e-2)
    assert cpu_k1 == 0 and card_k1 > 0


def test_radial_labels_from_cad_on_card_matches_cpu(cuda):
    from rcvpose_tpu_torch import labels

    rng = np.random.default_rng(0)
    cad = rng.normal(size=(3000, 3)) * 0.03
    pose = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                           [[0.01], [-0.02], [0.75]]], axis=1)
    args = (pose, np.array([0.06, -0.05, 0.04]), LINEMOD_K, 8.0, (480, 640))
    want = labels.radial_labels_from_cad(torch.tensor(cad), *args)
    got = labels.radial_labels_from_cad(torch.tensor(cad, device=cuda),
                                        *args)
    assert got[0].is_cuda
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-4)
    assert (want[1] > 0).sum() > 100


def test_keypoint_from_maps_no_depth_on_card(cuda):
    """The RGB-only keypoint on the card: its votes go through K1, and the
    center is the CPU's within 1e-2 mm and the truth's within 10 mm."""
    from rcvpose_tpu_torch import eval as eval_mod

    h, w = 96, 128
    k = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]])
    z0 = 0.72
    mask = np.zeros((h, w), bool)
    mask[35:65, 45:85] = True
    vs, us = mask.nonzero()
    pts = np.stack([(us - k[0, 2]) * z0 / k[0, 0],
                    (vs - k[1, 2]) * z0 / k[1, 1], np.full(len(us), z0)], 1)
    kpt = np.array([0.02, -0.01, 0.75])
    radial = np.zeros((h, w), np.float32)
    radial[mask] = np.linalg.norm(pts - kpt, axis=1) * 10.0
    centers = {}
    for dev in ("cpu", "cuda"):
        before = vote_cuda.vote_counts_cuda.launches
        c, overflow, count = eval_mod.keypoint_from_maps_no_depth(
            torch.tensor(mask, dtype=torch.float32, device=dev),
            torch.tensor(radial, device=dev),
            torch.tensor(k, dtype=torch.float32, device=dev), z0 - 0.004,
            100.0, 0.5, n_points=2048, n_hyp=9, grid_l=128)
        torch.cuda.synchronize()
        launched = vote_cuda.vote_counts_cuda.launches - before
        assert launched > 0 if dev == "cuda" else launched == 0
        assert not bool(overflow) and int(count) == int(mask.sum())
        centers[dev] = c.cpu().numpy()
    np.testing.assert_allclose(centers["cuda"], centers["cpu"], rtol=0,
                               atol=1e-2)
    assert np.linalg.norm(centers["cuda"] - kpt * 1000.0) < 10.0


def test_carried_orbax_fixture_reads_through_the_built_decoder(cuda,
                                                               tmp_path):
    """The orbax directory chip_smoke.py carries (written by orbax) reads
    on the card's machine, which has neither orbax nor tensorstore, bit
    for bit through the decoder built there, reaching its Huffman and FSE
    paths; a tiny net staged in the orbax layout evaluates on the card as
    its .pth.tar twin does."""
    import chip_smoke
    from rcvpose_tpu_torch import checkpoint, orbax_read
    from rcvpose_tpu_torch.models import fcnresnet
    from rcvpose_tpu_torch.native import zstd

    chip_smoke.unpack_dir(chip_smoke.ORBAX_DIR, str(tmp_path / "fixture"))
    zstd.reset_stats()
    chip_smoke.same_tree(orbax_read.read_tree(str(tmp_path / "fixture")),
                         chip_smoke.orbax_fixture_arrays())
    assert zstd.STATS["compressed_blocks"] and zstd.STATS["fse_tables"]
    assert zstd.STATS["huffman_4_streams"]

    cfg = config.Config(model_blocks="1,1,1,1", model_width=0.125,
                        compute_dtype="float32")
    net = fcnresnet.init_params(train.build_model(cfg),
                                torch.Generator().manual_seed(5))
    sd = net.state_dict()
    chip_smoke.write_orbax(
        str(tmp_path / "ckpts" / "model_best"),
        chip_smoke.jax_payload(chip_smoke.flax_variables(checkpoint, sd), 1,
                               2, adam=True))
    loaded = train.build_model(cfg)
    checkpoint.load_model_weights(loaded, checkpoint.import_torch_checkpoint(
        str(tmp_path / "ckpts")))
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        outs = [m.to(cuda).eval()(x.to(cuda)) for m in (net, loaded)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The conv epilogue and the folded serving nets
# ---------------------------------------------------------------------------

# the serving shapes: the stem, stage 3 and stage 4 (with their residual),
# conv7 at full resolution
EPILOGUE_SHAPES = [(1, 64, 240, 320), (1, 1024, 30, 40), (1, 2048, 15, 20),
                   (1, 32, 480, 640), (2, 40, 7, 9)]


def _epilogue_operands(shape, dtype, residual, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]

    def act():
        return torch.randn(*shape, device=dev, generator=gen).to(
            dtype).contiguous(memory_format=torch.channels_last)

    scale = torch.rand(c, device=dev, generator=gen) + 0.5
    shift = torch.randn(c, device=dev, generator=gen)
    return act(), scale, shift, act() if residual else None


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES, ids=str)
def test_conv_epilogue_cuda_matches_plain(cuda, shape, dtype, residual, relu):
    """The epilogue equals its plain version bit for bit, in place."""
    x, scale, shift, res = _epilogue_operands(shape, dtype, residual, cuda)
    want = epilogue.conv_epilogue_plain(x.clone(), scale, shift, res, relu)
    before = epilogue.conv_epilogue_cuda.launches
    got = epilogue.conv_epilogue(x, scale, shift, res, relu)
    torch.cuda.synchronize()
    assert got is x
    assert epilogue.conv_epilogue_cuda.launches == before + 1
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_conv_epilogue_cuda_refuses_what_it_cannot_take(cuda):
    x, scale, shift, res = _epilogue_operands((1, 16, 6, 8), torch.bfloat16,
                                              True, cuda)
    with pytest.raises(ValueError, match="channels-last"):
        epilogue.conv_epilogue(x.contiguous(), scale, shift)
    with pytest.raises(ValueError, match="channels-last"):
        epilogue.conv_epilogue(x, scale, shift, res.contiguous())
    x12, s12, b12, _ = _epilogue_operands((1, 12, 6, 8), torch.bfloat16,
                                          False, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        epilogue.conv_epilogue(x12, s12, b12)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)
    misaligned = flat[1:].view(1, 6, 8, 16).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        epilogue.conv_epilogue(misaligned, scale, shift)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        epilogue.conv_epilogue(x.half(), scale, shift)


@pytest.fixture(scope="module")
def full_width_fused():
    """A full-width fused DenseFCNResNet152 (three heads) with seeded
    weights and random statistics, in bf16 channels-last on the card, and
    a 480x640 normalized image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from rcvpose_tpu_torch import labels
    from rcvpose_tpu_torch.models import fcnresnet
    from tests.torch_port_estimators import random_statistics

    net = random_statistics(fcnresnet.init_params(
        train.build_model(config.Config(kpt_heads=3)),
        torch.Generator().manual_seed(3)), 4)
    net = net.to("cuda", torch.bfloat16,
                 memory_format=torch.channels_last).eval()
    img = np.random.default_rng(5).integers(0, 256, (480, 640, 3),
                                            dtype=np.uint8)
    x = labels.normalize_image(torch.as_tensor(img, device="cuda"))[None]
    return net, x


def _maps_rel_err(prog, ref):
    """perfbench's ``maps_rel_err`` of one map: the L2 norm of the
    difference over the L2 norm of the reference about its mean."""
    prog, ref = prog.double(), ref.double()
    return float(torch.linalg.vector_norm(prog - ref)
                 / torch.linalg.vector_norm(ref - ref.mean()))


def test_folded_full_width_net_matches_its_unfolded_twin(cuda,
                                                         full_width_fused):
    """bf16 on the card, each of the six maps within the fused cell's sound
    reading (0.1433) of the unfolded net's, and each no farther from the
    f32 forward (TF32 off) than the unfolded net's plus that reading's
    tenth; a replayed forward launches the epilogue 162 times."""
    from rcvpose_tpu_torch import profiling
    from rcvpose_tpu_torch.models import folded, graphs

    net, x = full_width_fused
    before = profiling.counters().get("bn.folded", 0)
    f = folded.fold_for_serving(net)
    assert profiling.counters()["bn.folded"] - before == 162
    with torch.inference_mode():
        got = f(x)
        want = net(x)
    ref_net = copy.deepcopy(net).float()
    with torch.inference_mode():
        ref = ref_net(x)
    del ref_net
    errs = []
    for g, w, r in zip(got, want, ref):
        for k in range(g.shape[-1]):
            e_twin = _maps_rel_err(g[..., k], w[..., k])
            e_fold, e_unfold = (_maps_rel_err(t[..., k], r[..., k])
                                for t in (g, w))
            errs.append((e_twin, e_fold, e_unfold))
    print("maps_rel_err (folded vs unfolded, folded vs f32, unfolded vs "
          "f32):", [tuple(round(e, 5) for e in row) for row in errs])
    for e_twin, e_fold, e_unfold in errs:
        assert e_twin < 0.1433
        assert e_fold < e_unfold + 0.01433
    graphed = graphs.GraphedNet(f)
    with torch.inference_mode():
        graphed(x)                        # eager and capture
        for _ in range(2):
            launches = epilogue.conv_epilogue_cuda.launches
            graphed(x)
            assert epilogue.conv_epilogue_cuda.launches - launches == 162


def _eager_kernels(fn):
    """The kernels one eager call of ``fn`` runs, by the profiler (memory
    copies and sets aside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def test_folded_forward_runs_fewer_kernels(cuda, full_width_fused):
    """One eager fused forward: batch norm's transform and its casts are
    gone, the epilogue runs once a folded unit, and the forward runs at
    most 520 kernels."""
    from rcvpose_tpu_torch.models import folded

    net, x = full_width_fused
    f = folded.fold_for_serving(net)
    with torch.inference_mode():
        unfolded = _eager_kernels(lambda: net(x))
        got = _eager_kernels(lambda: f(x))
    print(f"kernels a forward: unfolded {len(unfolded)}, folded {len(got)}")
    assert sum("epilogue_kernel" in n for n in got) == 162
    assert not any("batch_norm" in n for n in got)
    assert any("batch_norm" in n for n in unfolded)
    assert len(got) <= 520 < len(unfolded)
