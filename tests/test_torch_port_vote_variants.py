"""The plain versions of K5 (matmul-form d2), K6 (bf16 pair arithmetic)
and K1's tiles against the JAX package on the CPU, and K1's point-split
planner.

K5 is held against ``vote_pallas.vote_counts_pallas_mxu`` in interpret
mode, K6 against ``vote_pallas.vote_counts_pallas(compute_dtype=bfloat16)``
(bf16 compare) and against ``scripts/prof_vote_bf16.py``'s ``_kernel_bf16``
(f32 compare) in interpret mode. Counts are exactly equal where every
operand and partial result is exact in the working type; elsewhere K5 may
move a pair whose f64 d2 lies within the form's rounding of a band edge,
and XLA:CPU may keep K6's bf16 intermediates in f32.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rcvpose_tpu.ops import vote_pallas
from rcvpose_tpu.ops import voting as jax_voting
from rcvpose_tpu_torch.ops import vote_cuda
from rcvpose_tpu_torch.ops import voting as port_voting
from rcvpose_tpu_torch.scripts import coarse_problem, hier_problem, prof_vote
from rcvpose_tpu_torch.scripts import (prof_pipes, prof_vote_bf16,
                                       prof_vote_tiles)
from tests.torch_port_threads import port_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_BF16 = _jax_script("prof_vote_bf16")
JAX_TILES = _jax_script("prof_vote_tiles")


def _run_bf16_interpret(voxels, points, lo, hi):
    """``prof_vote_bf16.run_bf16``'s layout around its ``_kernel_bf16``,
    in the Pallas interpreter (the script's own function has no
    ``interpret`` flag): -1e4 voxel padding, bf16 coordinates, f32 band."""
    vb, pc = JAX_BF16.VOX_BLOCK, JAX_BF16.PT_CHUNK
    v, n = voxels.shape[0], points.shape[0]
    vox = jnp.pad(voxels, ((0, (-v) % vb), (0, 1)), constant_values=-1e4)
    pts = jnp.concatenate([points.T, jnp.zeros((5, n))], axis=0)
    pts = jnp.pad(pts, ((0, 0), (0, (-n) % pc)))
    band = jnp.concatenate([lo[None, :], hi[None, :], jnp.zeros((6, n))],
                           axis=0)
    band = jnp.pad(band, ((0, 0), (0, (-n) % pc)))
    out = pl.pallas_call(
        JAX_BF16._kernel_bf16,
        grid=(vox.shape[0] // vb, pts.shape[1] // pc),
        in_specs=[pl.BlockSpec((vb, 4), lambda i, j: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((8, pc), lambda i, j: (0, j),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((8, pc), lambda i, j: (0, j),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((vb, 1), lambda i, j: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((vox.shape[0], 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((vb, pc), jnp.float32)],
        interpret=True,
    )(vox.astype(jnp.bfloat16), pts.astype(jnp.bfloat16),
      band.astype(jnp.float32))
    return np.asarray(out[:v, 0])


def _t(x):
    return torch.tensor(np.asarray(x))


def _integer_problem(seed, b, n, v, side):
    """Integer voxels and points in [0, side) with an exact band: with
    side <= 32 every operand and partial sum of both d2 forms is an exact
    f32 integer (|v|^2 + |p|^2 < 2^13)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, side, size=(b, n, 3)).astype(np.float32)
    vox = rng.integers(0, side, size=(b, v, 3)).astype(np.float32)
    radii = rng.integers(1, side // 2, size=(b, n)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.9
    lo, hi = port_voting.exact_band(_t(radii), _t(mask))
    return _t(vox), _t(pts), lo, hi


def _jax_each(fn, vox, pts, lo, hi, **kw):
    """A JAX vote function (one point set) over the batch."""
    shared = vox.dim() == 2
    return np.stack([np.asarray(fn(
        jnp.asarray((vox if shared else vox[i]).numpy()),
        jnp.asarray(pts[i].numpy()), jnp.asarray(lo[i].numpy()),
        jnp.asarray(hi[i].numpy()), **kw)) for i in range(pts.shape[0])])


# ---------------------------------------------------------------------------
# K5: matmul-form d2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
def test_mxu_plain_exact_on_integer_inputs(shared):
    vox, pts, lo, hi = _integer_problem(0, 2, 333, 700, side=32)
    if shared:
        vox = vox[0]
    got = vote_cuda.vote_counts_mxu_plain(vox, pts, lo, hi)
    assert got.shape == (2, 700) and got.dtype == torch.float32
    mxu = _jax_each(vote_pallas.vote_counts_pallas_mxu, vox, pts, lo, hi,
                    interpret=True)
    xla = _jax_each(jax_voting.vote_counts_xla, vox, pts, lo, hi)
    np.testing.assert_array_equal(got.numpy(), mxu)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(
        got.numpy(), vote_cuda.vote_counts_plain(vox, pts, lo, hi).numpy())
    assert got.sum() > 0


def _near_edge_pairs(vox, pts, lo, hi):
    """Per voxel, the pairs whose f64 d2 lies within the matmul form's
    rounding, 4 * 2^-24 * (|v|^2 + |p|^2), of lo or hi."""
    v = vox.numpy().astype(np.float64)
    p = pts.numpy().astype(np.float64)
    if v.ndim == 2:
        v = np.broadcast_to(v, (p.shape[0],) + v.shape)
    d2 = ((v[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    tol = 4 * 2.0 ** -24 * ((v * v).sum(-1)[:, :, None]
                            + (p * p).sum(-1)[:, None, :])
    l = lo.numpy().astype(np.float64)[:, None, :]
    h = hi.numpy().astype(np.float64)[:, None, :]
    near = (np.abs(d2 - l) <= tol) | (np.abs(d2 - h) <= tol)
    return (near & (h > 0)).sum(-1)


def test_mxu_plain_within_band_edge_rounding_at_hier_scale():
    """Coarse-cell centers of a grid-192 cube against random points: K5
    differs from K1 and from the JAX MXU kernel per voxel by at most the
    pairs that sit on a band edge within the form's rounding."""
    rng = np.random.default_rng(1)
    cells = rng.integers(0, 48, size=(2000, 3)).astype(np.float32) * 4 + 1.5
    pts = rng.uniform(0, 192, size=(2, 600, 3)).astype(np.float32)
    radii = np.round(rng.uniform(10, 60, size=(2, 600))).astype(np.float32)
    mask = rng.uniform(size=(2, 600)) < 0.9
    lo, hi = port_voting.widened_band(_t(radii), _t(mask), 4.2)
    vox, pts = _t(cells), _t(pts)
    got = vote_cuda.vote_counts_mxu_plain(vox, pts, lo, hi).numpy()
    k1 = vote_cuda.vote_counts_plain(vox, pts, lo, hi).numpy()
    mxu = _jax_each(vote_pallas.vote_counts_pallas_mxu, vox, pts, lo, hi,
                    interpret=True)
    near = _near_edge_pairs(vox, pts, lo, hi)
    assert (np.abs(got - k1) <= near).all()
    assert (np.abs(got - mxu) <= near).all()
    assert got.sum() > 0


def test_vote_counts_mxu_dispatches_to_k5_plain_on_cpu(monkeypatch):
    vox, pts, lo, hi = _integer_problem(2, 3, 100, 50, side=32)
    want = vote_cuda.vote_counts_mxu_plain(vox, pts, lo, hi)
    torch.testing.assert_close(port_voting.vote_counts(vox, pts, lo, hi,
                                                       mxu=True),
                               want, rtol=0, atol=0)
    calls = []

    def spy(*args):
        calls.append(len(args))
        return want

    monkeypatch.setattr(vote_cuda, "vote_counts_mxu_plain", spy)
    port_voting.vote_counts(vox, pts, lo, hi, mxu=True)
    port_voting.vote_counts(vox, pts, lo, hi)
    assert calls == [4]


# ---------------------------------------------------------------------------
# K6: bf16 pair arithmetic
# ---------------------------------------------------------------------------

def test_bf16_plain_exact_where_bf16_is_exact():
    """Coordinate differences of 0-7: every bf16 intermediate is exact, so
    both compare modes equal the JAX kernels and K1."""
    vox, pts, lo, hi = _integer_problem(3, 2, 700, 1100, side=8)
    k1 = vote_cuda.vote_counts_plain(vox, pts, lo, hi).numpy()
    for b in range(2):
        args = [jnp.asarray(t[b].numpy()) for t in (vox, pts, lo, hi)]
        f32 = vote_cuda.vote_counts_bf16_plain(vox, pts, lo, hi, "f32")
        np.testing.assert_array_equal(f32[b].numpy(),
                                      _run_bf16_interpret(*args))
        np.testing.assert_array_equal(f32[b].numpy(), k1[b])
        bf = vote_cuda.vote_counts_bf16_plain(vox, pts, lo, hi, "bf16")
        want = vote_pallas.vote_counts_pallas(
            *args, interpret=True, compute_dtype=jnp.bfloat16)
        np.testing.assert_array_equal(bf[b].numpy(), np.asarray(want))
    assert k1.sum() > 0


def test_bf16_plain_close_on_the_coarse_problem():
    """The JAX script's coarse-stage problem at a reduced size: counts
    within 5% relative error on average and the same four best cells."""
    vox, pts, lo, hi = coarse_problem(n=1024, v=4096, slack=4.2, seed=0,
                                      device="cpu")
    args = [jnp.asarray(t.numpy()) for t in (vox, pts[0], lo[0], hi[0])]
    for compare, want in (
            ("f32", _run_bf16_interpret(*args)),
            ("bf16", np.asarray(vote_pallas.vote_counts_pallas(
                *args, interpret=True, compute_dtype=jnp.bfloat16)))):
        got = vote_cuda.vote_counts_bf16_plain(vox, pts, lo, hi, compare)[0]
        mean, mx, overlap = prof_vote_bf16.count_errors(want, got.numpy())
        assert mean <= 0.05 and overlap == 4, (compare, mean, mx, overlap)


def _round_bf16(x, up):
    """f32 ``x`` rounded to a bf16 value toward +inf (``up``) or -inf, as
    f32, with bit operations (the kernel's ``__float2bfloat16_ru`` /
    ``_rd``): truncate the low 16 bits (toward zero), then step one bf16 ulp
    away from zero where that is the rounding's direction and the value was
    not exact. NaN stays NaN, +-inf stay, and a finite value beyond the
    largest bf16 rounds outward to inf."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    trunc = bits & np.uint32(0xFFFF0000)
    negative = (bits >> 31) == 1
    away = ((bits & np.uint32(0xFFFF)) != 0) & (negative != up)
    out = (trunc + np.where(away, np.uint32(0x10000), np.uint32(0))).view(
        np.float32)
    return np.where(np.isnan(x), x, out).astype(np.float32)


def _band_edges():
    """Band edges for the identity: every 64th bf16 value of either sign,
    each also one f32 ulp either side and halfway to the next bf16 value,
    then 0, -0, +-inf, NaN and the largest finite f32 (past the largest
    bf16) of either sign."""
    mags = (np.arange(0, 0x7F80, 64, dtype=np.uint32) << 16).view(np.float32)
    bf = np.concatenate([mags, -mags[1:]])
    halfway = (bf.view(np.uint32) + np.uint32(0x8000)).view(np.float32)
    big = np.finfo(np.float32).max
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, big, -big],
                       np.float32)
    return np.concatenate([bf, np.nextafter(bf, np.float32(np.inf)),
                           np.nextafter(bf, np.float32(-np.inf)),
                           halfway, special]).astype(np.float32)


def test_k6_band_rounded_outward_is_the_f32_compare():
    """K6 compares in bf16 in both arms: for every finite non-negative bf16
    d2, the f32 test ``lo < d2 < hi`` of ``vote_counts_bf16_plain`` equals
    ``rd(lo) < d2 < ru(hi)`` with lo rounded to bf16 toward -inf and hi
    toward +inf, whatever lo and hi are (bf16 values, one f32 ulp off them,
    halfway between two, 0, inf, NaN, past the largest bf16)."""
    d2 = (np.arange(0, 0x7F80, dtype=np.uint32) << 16).view(np.float32)
    edges = _band_edges()
    rd, ru = _round_bf16(edges, up=False), _round_bf16(edges, up=True)
    finite = np.isfinite(rd) & np.isfinite(ru)
    assert not ((rd.view(np.uint32)[finite] & 0xFFFF).any()
                or (ru.view(np.uint32)[finite] & 0xFFFF).any())
    for lo, lo_bf in zip(np.array_split(edges, 8), np.array_split(rd, 8)):
        np.testing.assert_array_equal(lo_bf[:, None] < d2[None],
                                      lo[:, None] < d2[None])
    for hi, hi_bf in zip(np.array_split(edges, 8), np.array_split(ru, 8)):
        np.testing.assert_array_equal(d2[None] < hi_bf[:, None],
                                      d2[None] < hi[:, None])


def test_k6_outward_band_counts_like_the_f32_compare():
    """The identity through the plain version: on a problem whose d2 lie on
    and around the band edges, the bf16 compare with the band rounded
    outward (what K6's f32 arm runs) counts exactly what the f32 compare
    counts, and rounding to nearest instead would not."""
    rng = np.random.default_rng(3)
    vox, pts, lo, hi = coarse_problem(n=700, v=300, slack=4.2, seed=3,
                                      device="cpu")
    d2 = vote_cuda._d2_subtract_square(pts.to(torch.bfloat16))(
        vox.to(torch.bfloat16).expand(1, -1, -1), 0, 700).float()[0].numpy()
    edges = []
    for _ in range(2):
        e = d2[rng.integers(0, 300, size=700), np.arange(700)]
        halfway = (e.view(np.uint32) + np.uint32(0x8000)).view(np.float32)
        cands = np.stack([e, np.nextafter(e, np.float32(np.inf)),
                          np.nextafter(e, np.float32(-np.inf)), halfway])
        edges.append(cands[rng.integers(0, 4, size=700), np.arange(700)])
    lo_np, hi_np = np.minimum(*edges)[None], np.maximum(*edges)[None]
    want = vote_cuda.vote_counts_bf16_plain(
        vox, pts, torch.tensor(lo_np), torch.tensor(hi_np), "f32")
    outward = vote_cuda.vote_counts_bf16_plain(
        vox, pts, torch.tensor(_round_bf16(lo_np, up=False)),
        torch.tensor(_round_bf16(hi_np, up=True)), "bf16")
    nearest = vote_cuda.vote_counts_bf16_plain(
        vox, pts, torch.tensor(lo_np), torch.tensor(hi_np), "bf16")
    assert torch.equal(outward, want)
    assert not torch.equal(nearest, want)


def test_bf16_rejects_unknown_compare():
    vox, pts, lo, hi = _integer_problem(4, 1, 10, 10, side=8)
    with pytest.raises(ValueError, match="compare"):
        vote_cuda.vote_counts_bf16_plain(vox, pts, lo, hi, "f16")


# ---------------------------------------------------------------------------
# K1 tiles and the measurement entry points
# ---------------------------------------------------------------------------

def test_every_tile_plain_path_equal(monkeypatch):
    """Every tile's plain path is ``vote_counts_plain``: it equals the JAX
    sweep's tiled kernel (``make_runner``, in the Pallas interpreter) at
    several of its tiles. Every port tile is built; on CPU tensors the
    wrapper raises instead of launching, and an unbuilt tile is refused."""
    vox, pts, lo, hi = _integer_problem(5, 2, 257, 1025, side=32)
    want = vote_cuda.vote_counts_plain(vox, pts, lo, hi)
    monkeypatch.setattr(JAX_TILES.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    for vb, pc in [(256, 128), (512, 256), (1024, 512)]:
        got = _jax_each(JAX_TILES.make_runner(vb, pc), vox, pts, lo, hi)
        np.testing.assert_array_equal(want.numpy(), got)
    assert want.sum() > 0
    assert len(vote_cuda.TILES) == 36
    assert vote_cuda.DEFAULT_TILE in vote_cuda.TILES
    for tile in vote_cuda.TILES:
        with pytest.raises(ValueError, match="CUDA device"):
            vote_cuda.vote_counts_cuda(vox, pts, lo, hi, tile=tile)
    with pytest.raises(ValueError, match="tile"):
        vote_cuda.vote_counts_cuda(vox, pts, lo, hi, tile=(1024, 1, 256))


def test_coarse_problem_is_the_jax_scripts_problem():
    """Same numbers as the JAX scripts' ``main`` makes from seed 0."""
    vox, pts, lo, hi = coarse_problem(n=64, v=128, slack=4.2, seed=0,
                                      device="cpu")
    rng = np.random.default_rng(0)
    want_vox = jnp.asarray(
        rng.integers(0, 32, size=(128, 3)).astype(np.float32) * 4 + 1.5)
    want_pts = jnp.asarray(rng.uniform(0, 128, size=(64, 3))
                           .astype(np.float32))
    r = jnp.asarray(rng.uniform(10, 50, size=64).astype(np.float32))
    np.testing.assert_array_equal(vox.numpy(), np.asarray(want_vox))
    np.testing.assert_array_equal(pts[0].numpy(), np.asarray(want_pts))
    np.testing.assert_array_equal(
        lo[0].numpy(), np.asarray(jnp.maximum(r - 4.2, 0.0) ** 2))
    np.testing.assert_array_equal(hi[0].numpy(),
                                  np.asarray((r + 4.2) ** 2))


@pytest.mark.parametrize("script", [prof_vote_tiles, prof_vote_bf16,
                                    prof_vote, prof_pipes])
def test_measurement_scripts_need_the_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main()


# ---------------------------------------------------------------------------
# K1's point-split planner
# ---------------------------------------------------------------------------

# (B, V, N) of K1's launches: the serving hier stages (grid 128, topk 32),
# the LM evaluator's (grid 192, topk 64), chip_smoke's exact64 stage, the
# sweep scripts' coarse problem, and the card tests' shapes
PLAN_SHAPES = [(3, 32768, 1024), (3, 16384, 8192), (3, 110592, 1024),
               (3, 32768, 8192), (3, 262144, 8192), (1, 32768, 2048),
               (3, 3000, 2500), (1, 1, 1), (2, 257, 1025), (3, 3001, 2501),
               (3, 2049, 777), (3, 4096, 8155), (2, 5, 0)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_k1_plan_is_legal_covers_every_point_once_and_fills_the_card(shape):
    """At every tile: the splits tile [0, N) without gap or overlap, fit
    the grid, and give at least the planner's target of blocks an SM at
    132 SMs unless N is too short for more splits; the target is 32 warps
    an SM (4 blocks of 256 threads) or all a tile's blocks that fit."""
    b, v, n = shape
    for tile in vote_cuda.TILES:
        plan = vote_cuda.plan_votes(b, v, n, tile, vote_cuda.H100_SMS)
        threads, vpt, chunk = tile
        assert plan.split >= 1 and 1 <= plan.splits <= 65535
        assert plan.splits == (-(-n // plan.split) if n > plan.split else 1)
        assert plan.splits == 1 or plan.split % vote_cuda.SPLIT_ALIGN == 0
        ranges = [(i * plan.split, min(n, (i + 1) * plan.split))
                  for i in range(plan.splits)]
        covered = np.zeros(n, np.int64)
        for lo_, hi_ in ranges:
            covered[lo_:hi_] += 1
        assert (covered == 1).all(), (tile, plan)
        assert plan.voxel_blocks == max(1, b * -(-v // (threads * vpt)))
        assert plan.resident == vote_cuda.resident_blocks(tile)
        assert 20 * chunk * plan.resident <= 233472
        assert plan.target == min(plan.resident,
                                  vote_cuda.TARGET_WARPS * 32 // threads)
        short = plan.split <= vote_cuda.SPLIT_ALIGN or plan.splits * \
            vote_cuda.SPLIT_ALIGN >= n
        assert plan.blocks >= plan.target * plan.sms or short, (tile, plan)


@pytest.mark.parametrize("shape", PLAN_SHAPES[:4], ids=str)
def test_k1_default_tile_gives_four_blocks_an_sm_at_the_hier_stages(shape):
    """The serving and LM stages at the default tile: at least 4 blocks
    (32 warps) an SM, where the voxel tiles alone gave 1.45 at the serving
    refine stage, and the busiest SM within 25% of the mean's points."""
    plan = vote_cuda.plan_votes(*shape)
    b, v, n = shape
    assert plan.tile == vote_cuda.DEFAULT_TILE
    assert plan.blocks_per_sm >= 4
    busiest = -(-plan.blocks // plan.sms) * plan.split
    assert busiest <= 1.25 * plan.voxel_blocks * n / plan.sms


def _k1_split_emulation(vox, pts, lo, hi, split, chunk, rng):
    """K1's split kernel in plain PyTorch: each split of ``split`` points
    staged in chunks of ``chunk``, each chunk padded to a multiple of 4
    with masked points (coordinates 0, lo = hi = 0); each split's integer
    counts added into a zeroed f32 output in a shuffled order, as the
    blocks' atomicAdds land."""
    b, n, _ = pts.shape
    parts = []
    for s0 in range(0, max(n, 1), split):
        s1 = min(n, s0 + split)
        count = torch.zeros((b, vox.shape[-2]), dtype=torch.int64)
        for c0 in range(s0, s1, chunk):
            c1 = min(s1, c0 + chunk)
            pad = (-(c1 - c0)) % 4
            p = torch.cat([pts[:, c0:c1], torch.zeros(b, pad, 3)], dim=1)
            l_ = torch.cat([lo[:, c0:c1], torch.zeros(b, pad)], dim=1)
            h_ = torch.cat([hi[:, c0:c1], torch.zeros(b, pad)], dim=1)
            count += vote_cuda.vote_counts_plain(vox, p, l_, h_).long()
        parts.append(count.float())
    out = torch.zeros((b, vox.shape[-2]), dtype=torch.float32)
    for i in rng.permutation(len(parts)):
        out += parts[i]
    return out


@functools.lru_cache(maxsize=None)
def _serving_refine_cut():
    """The serving refine stage's 8192 points against its first 2048
    voxels per keypoint, with the whole counts."""
    stages = hier_problem(128, 32, device="cpu")
    vox, pts, lo, hi = stages["refine"]
    args = (vox[:, :2048].contiguous(), pts, lo, hi)
    return args, vote_cuda.vote_counts_plain(*args)


@pytest.mark.parametrize("split", ["planner", 8192, 4096, 1171, 1001, 32])
def test_k1_split_partials_sum_to_the_whole_count(split):
    """Partial counts of any split, summed in f32 in any order, equal the
    whole count exactly (every partial sum is an integer below 2^24), and
    the masked padding changes nothing: the kernel's atomics cannot change
    a count."""
    args, whole = _serving_refine_cut()
    b, v, n = args[1].shape[0], args[0].shape[1], args[1].shape[1]
    if split == "planner":
        split = vote_cuda.plan_votes(b, v, n).split
    got = _k1_split_emulation(*args, split, vote_cuda.DEFAULT_TILE[2],
                              np.random.default_rng(split))
    assert whole.sum() > 0 and whole.max() < 2 ** 24
    assert torch.equal(got, whole)


def test_k1_wrapper_refuses_a_split_below_one_point():
    vox, pts, lo, hi = _integer_problem(5, 2, 17, 9, side=32)
    with pytest.raises(ValueError, match="split"):
        vote_cuda.vote_counts_cuda(vox, pts, lo, hi, split=0)


@pytest.mark.parametrize("bad", ["int64", "shape", "strided", "device"])
def test_k1_wrapper_refuses_a_live_bound_it_cannot_read(bad):
    """``n_live`` is a contiguous (B,) int32 tensor on the points' device,
    or the wrapper raises before any launch."""
    vox, pts, lo, hi = _integer_problem(5, 2, 17, 9, side=32)
    n_live = {"int64": torch.tensor([3, 9]),
              "shape": torch.tensor([3, 9, 9], dtype=torch.int32),
              "strided": torch.tensor([3, 0, 9, 0], dtype=torch.int32)[::2],
              "device": torch.zeros(2, dtype=torch.int32, device="meta")}[bad]
    with pytest.raises(ValueError, match="n_live"):
        vote_cuda.vote_counts_cuda(vox, pts, lo, hi, n_live=n_live)


# ---------------------------------------------------------------------------
# K6's point-split planner
# ---------------------------------------------------------------------------

# K1's shapes, and N past the split cap (an exact-mode frame of 480 x 640
# points, a cap plus one)
K6_PLAN_SHAPES = PLAN_SHAPES + [(3, 1000, 307200), (1, 4096, 2 * 65535 + 1),
                                (3, 262144, 307200)]


@pytest.mark.parametrize("shape", K6_PLAN_SHAPES, ids=str)
def test_k6_plan_covers_every_point_once_under_the_cap(shape):
    """K6's splits tile [0, N) without gap or overlap, each at most
    ``K6_MAX_SPLIT`` points (its 16-bit lane counts), fit the grid, and
    give at least the target of blocks an SM at 132 SMs unless N is too
    short for more splits."""
    b, v, n = shape
    plan = vote_cuda.plan_votes(b, v, n, vote_cuda.K6_TILE,
                                vote_cuda.H100_SMS, "K6")
    threads, vpt, chunk = vote_cuda.K6_TILE
    assert plan.kernel == "K6" and plan.tile == vote_cuda.K6_TILE
    assert 1 <= plan.split <= vote_cuda.K6_MAX_SPLIT
    assert 1 <= plan.splits <= 65535
    assert plan.splits == (-(-n // plan.split) if n > plan.split else 1)
    assert plan.splits == 1 or plan.split % vote_cuda.SPLIT_ALIGN == 0
    covered = np.zeros(n, np.int64)
    for i in range(plan.splits):
        covered[i * plan.split:min(n, (i + 1) * plan.split)] += 1
    assert (covered == 1).all(), plan
    assert plan.voxel_blocks == max(1, b * -(-v // (threads * vpt)))
    assert plan.resident == vote_cuda.resident_blocks(vote_cuda.K6_TILE,
                                                      "K6")
    assert 10 * chunk * plan.resident <= 233472
    short = plan.split <= vote_cuda.SPLIT_ALIGN or plan.splits * \
        vote_cuda.SPLIT_ALIGN >= n
    assert plan.blocks >= plan.target * plan.sms or short, plan


@pytest.mark.parametrize("shape", PLAN_SHAPES[:4], ids=str)
def test_k6_plan_fills_the_card_at_the_hier_stages(shape):
    """The serving and LM hier stages: at least 4 blocks (32 warps) an SM,
    and the busiest SM within 25% of the mean's points."""
    plan = vote_cuda.plan_votes(*shape, tile=vote_cuda.K6_TILE,
                                kernel="K6")
    assert plan.blocks_per_sm >= 4
    busiest = -(-plan.blocks // plan.sms) * plan.split
    assert busiest <= 1.25 * plan.voxel_blocks * shape[2] / plan.sms


def test_k6_plan_and_split_refusals():
    """K6 is built at one tile; an explicit split past the cap is refused
    before anything is allocated on the card; N = 2^24 is refused."""
    with pytest.raises(ValueError, match="K6"):
        vote_cuda.plan_votes(3, 1000, 1000, vote_cuda.DEFAULT_TILE[:2]
                             + (2048,), kernel="K6")
    cap = vote_cuda.K6_MAX_SPLIT
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="at most"):
        vote_cuda._split_output("K6", 1, 4, cap + 1, cap + 1,
                                vote_cuda.K6_TILE, "K6", cpu)
    split, out = vote_cuda._split_output("K6", 1, 4, cap + 1, cap,
                                         vote_cuda.K6_TILE, "K6", cpu)
    assert split == cap and torch.equal(out, torch.zeros(1, 4))
    with pytest.raises(ValueError, match="2\\^24"):
        vote_cuda._split_output("K6", 1, 4, 1 << 24, 1 << 20,
                                vote_cuda.K6_TILE, "K6", cpu)


@pytest.mark.parametrize("pairs", [1, 1000, 65535, 65536])
def test_k6_lane_counts_are_exact_up_to_the_cap(pairs):
    """K6 adds 0x00010001 into a uint32 for a staged pair whose two points
    both vote and folds the two 16-bit lanes at the end: exact while a lane
    counts at most 65535 points, which K6_MAX_SPLIT = 2 x 65535 points a
    block guarantees; one pair more and the low lane carries into the high
    one."""
    acc = np.uint32(0)
    step = np.uint32(0x00010001)
    acc = np.uint32((int(acc) + pairs * int(step)) % (1 << 32))
    folded = int(acc & np.uint32(0xFFFF)) + int(acc >> np.uint32(16))
    assert (folded == 2 * pairs) == (2 * pairs <= vote_cuda.K6_MAX_SPLIT)
