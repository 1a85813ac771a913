"""The port's vote counts, accumulator, geometry and Horn fit against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side reaches its vote kernel through the CPU dispatch
(``vote_counts_xla``) or the Pallas interpreter; the port side through
K1's plain version. Vote counts are held exactly equal: both evaluate
d2 as ``dx*dx + dy*dy + dz*dz`` with each operation rounded on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcvpose_tpu import fit as jax_fit
from rcvpose_tpu import geometry as jax_geometry
from rcvpose_tpu.ops import vote_pallas
from rcvpose_tpu.ops import voting as jax_voting
from rcvpose_tpu_torch import fit as port_fit
from rcvpose_tpu_torch import geometry as port_geometry
from rcvpose_tpu_torch.ops import vote_cuda
from rcvpose_tpu_torch.ops import voting as port_voting
from tests import oracles
from tests.test_geometry import random_pose
from tests.test_voting import synth_cloud
from tests.torch_port_threads import port_threads  # noqa: F401

# The accumulator decodes centers as (voxel + shift + mean + 0.5) * 5 mm;
# the f32 masked means may round differently between the frameworks.
CENTER_ATOL_MM = 1e-3


def _t(x):
    return torch.tensor(np.asarray(x))


def _band_problem(rng, b=3, n=300, v=500, side=32):
    pts = rng.uniform(2, side - 2, size=(b, n, 3)).astype(np.float32)
    radii = np.round(rng.uniform(1, 9, size=(b, n))).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.9  # ~10% masked: lo = hi = 0
    vox = rng.uniform(0, side, size=(b, v, 3)).astype(np.float32)
    return pts, radii, mask, vox


def test_vote_counts_plain_matches_jax_xla_and_reference():
    rng = np.random.default_rng(0)
    pts, radii, mask, vox = _band_problem(rng)
    lo, hi = port_voting.exact_band(_t(radii), _t(mask))
    got = port_voting.vote_counts(_t(vox), _t(pts), lo, hi)
    assert got.shape == (3, vox.shape[1]) and got.dtype == torch.float32
    for i in range(3):
        jlo, jhi = jax_voting.exact_band(jnp.asarray(radii[i]),
                                         jnp.asarray(mask[i]))
        np.testing.assert_array_equal(np.asarray(jlo), lo[i].numpy())
        np.testing.assert_array_equal(np.asarray(jhi), hi[i].numpy())
        xla = jax_voting.vote_counts_xla(jnp.asarray(vox[i]),
                                         jnp.asarray(pts[i]), jlo, jhi)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(xla))
        jref = jax_voting.vote_counts_reference(
            jnp.asarray(vox[i]), jnp.asarray(pts[i]), jnp.asarray(radii[i]),
            jnp.asarray(mask[i]))
        pref = port_voting.vote_counts_reference(
            _t(vox[i]), _t(pts[i]), _t(radii[i]), _t(mask[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jref))
        np.testing.assert_array_equal(pref.numpy(), np.asarray(jref))


def test_vote_counts_shared_voxels_and_pallas_interpret():
    """(V, 3) voxels shared by the batch, the coarse stage's form, against
    the JAX Pallas kernel in interpret mode; a ragged point count."""
    rng = np.random.default_rng(1)
    pts, radii, mask, vox = _band_problem(rng, n=333, v=300)
    lo, hi = port_voting.widened_band(_t(radii), _t(mask), 3.2)
    got = vote_cuda.vote_counts_plain(_t(vox[0]), _t(pts), lo, hi)
    for i in range(3):
        want = vote_pallas.vote_counts_pallas(
            jnp.asarray(vox[0]), jnp.asarray(pts[i]),
            jnp.asarray(lo[i].numpy()), jnp.asarray(hi[i].numpy()),
            interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_vote_counts_rejects_bad_shapes():
    z = torch.zeros
    with pytest.raises(ValueError):
        port_voting.vote_counts(z(5, 3), z(2, 4, 3), z(2, 4), z(2, 5))
    with pytest.raises(TypeError):
        port_voting.vote_counts(z(5, 3, dtype=torch.float64), z(2, 4, 3),
                                z(2, 4), z(2, 4))


@pytest.mark.parametrize("widened", [False, True])
def test_band_bounds_match_jax(widened):
    rng = np.random.default_rng(2)
    radii = np.round(rng.uniform(-2, 9, size=64)).astype(np.float32)
    mask = rng.uniform(size=64) < 0.8
    if widened:
        got = port_voting.widened_band(_t(radii), _t(mask), 3.9)
        want = jax_voting.widened_band(jnp.asarray(radii), jnp.asarray(mask),
                                       3.9)
    else:
        got = port_voting.surface_band(_t(radii), _t(mask))
        want = jax_voting.surface_band(jnp.asarray(radii), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _clouds(seed, b=3, n=150, n_pad=256):
    """Per-keypoint synthetic sphere clouds, padded and masked."""
    rng = np.random.default_rng(seed)
    xyz, rad, mask = [], [], []
    for _ in range(b):
        center = np.array([0.02, -0.01, 0.75]) + rng.normal(size=3) * 0.02
        pts, radial_dm, _ = synth_cloud(rng, n=n, center=center)
        xyz.append(np.pad(pts, ((0, n_pad - n), (0, 0))))
        rad.append(np.pad(radial_dm, (0, n_pad - n)))
        mask.append(np.arange(n_pad) < n)
    return (np.stack(xyz).astype(np.float32), np.stack(rad).astype(np.float32),
            np.stack(mask))


def _assert_same_result(port_res, jax_res):
    np.testing.assert_array_equal(port_res.peak_voxel.numpy(),
                                  np.asarray(jax_res.peak_voxel))
    np.testing.assert_array_equal(port_res.peak_votes.numpy(),
                                  np.asarray(jax_res.peak_votes))
    np.testing.assert_array_equal(port_res.overflow.numpy(),
                                  np.asarray(jax_res.overflow))
    np.testing.assert_allclose(port_res.center_mm.numpy(),
                               np.asarray(jax_res.center_mm),
                               atol=CENTER_ATOL_MM)


@pytest.mark.parametrize("mode", ["exact", "surface", "hier"])
def test_accumulate_3d_matches_jax(mode):
    xyz, rad, mask = _clouds(seed=3)
    got = port_voting.accumulate_3d(_t(xyz), _t(rad), _t(mask), grid_l=64,
                                    mode=mode)
    for i in range(3):
        want = jax_voting.accumulate_3d(
            jnp.asarray(xyz[i]), jnp.asarray(rad[i]), jnp.asarray(mask[i]),
            grid_l=64, mode=mode)
        _assert_same_result(
            port_voting.AccumulatorResult(*(t[i] for t in got)), want)
        # the unbatched form gives the same answer
        single = port_voting.accumulate_3d(_t(xyz[i]), _t(rad[i]),
                                           _t(mask[i]), grid_l=64, mode=mode)
        _assert_same_result(single, want)
    if mode == "exact":
        # the reference accumulator as a third witness
        for i in range(3):
            n = int(mask[i].sum())
            center_np, side = oracles.accumulator_3d_np(xyz[i, :n],
                                                        rad[i, :n])
            assert side <= 64
            np.testing.assert_allclose(got.center_mm[i].numpy(), center_np,
                                       atol=1e-2)


def test_top_indices_break_ties_like_lax_top_k():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 4, size=(3, 500)).astype(np.float32)
    got = port_voting._top_indices(_t(vals), 32)
    for i in range(3):
        _, want = jax.lax.top_k(jnp.asarray(vals[i]), 32)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_hier_with_tied_coarse_counts_at_the_cut():
    """A sparse cloud: few points make many coarse cells score the same, so
    the top-k cut falls inside a run of ties and the refine windows depend
    on the tie order."""
    rng = np.random.default_rng(5)
    n, n_pad = 12, 64
    xyz = np.zeros((1, n_pad, 3), np.float32)
    xyz[0, :n] = (np.array([0.0, 0.0, 0.8])
                  + rng.normal(size=(n, 3)) * 0.03).astype(np.float32)
    rad = np.zeros((1, n_pad), np.float32)
    rad[0, :n] = rng.uniform(0.3, 0.6, size=n)
    mask = np.arange(n_pad)[None] < n

    pts, rr, _, _, bound = port_voting._prepare(_t(xyz), _t(rad), _t(mask))
    lc = 64 // port_voting._COARSE
    coarse = (port_voting.enumerate_grid(lc) + 0.5) * port_voting._COARSE - 0.5
    slack = port_voting.VOTE_BAND + np.sqrt(3.0) * port_voting._COARSE / 2
    lo, hi = port_voting.widened_band(rr, _t(mask), slack)
    s = port_voting._CPT_STRIDE
    cv = port_voting.vote_counts(coarse, pts[:, ::s], lo[:, ::s],
                                 hi[:, ::s])[0]
    ranked = torch.sort(cv, descending=True).values
    k = port_voting._TOPK
    assert ranked[k - 1] == ranked[k], "construction: no tie at the cut"

    got = port_voting.accumulate_3d(_t(xyz[0]), _t(rad[0]), _t(mask[0]),
                                    grid_l=64, mode="hier")
    want = jax_voting.accumulate_3d(jnp.asarray(xyz[0]), jnp.asarray(rad[0]),
                                    jnp.asarray(mask[0]), grid_l=64,
                                    mode="hier")
    _assert_same_result(got, want)


def test_accumulate_3d_no_depth_matches_jax():
    rng = np.random.default_rng(6)
    mask2d = np.zeros((24, 32), bool)
    mask2d[8:16, 10:20] = True
    clouds, mask, _, _ = jax_geometry.depth_hypothesis_clouds(
        jnp.asarray(mask2d), jnp.asarray(jax_geometry.LINEMOD_K, jnp.float32),
        0.7, 4, 128)
    clouds = np.asarray(clouds)
    mask = np.asarray(mask)
    radial = rng.uniform(0.2, 0.6, size=128).astype(np.float32)
    got = port_voting.accumulate_3d_no_depth(_t(clouds), _t(radial),
                                             _t(mask), grid_l=64)
    want = jax_voting.accumulate_3d_no_depth(
        jnp.asarray(clouds), jnp.asarray(radial), jnp.asarray(mask),
        grid_l=64)
    _assert_same_result(got, want)


def test_suggest_grid_l_matches_jax():
    for diam, rmax in ((0.102, 2.0), (0.3, 1.0), (0.05, 0.5)):
        assert (port_voting.suggest_grid_l(diam, rmax)
                == jax_voting.suggest_grid_l(diam, rmax))
    assert port_voting.suggest_grid_l(0.102, 2.0) == 128


@pytest.mark.parametrize("n_points", [40, 500, 5000])
def test_pack_valid_indices_matches_jax(n_points):
    rng = np.random.default_rng(7)
    valid = rng.uniform(size=64 * 48) < 0.05
    order, mask = port_geometry.pack_valid_indices(_t(valid), n_points)
    jorder, jmask = jax_geometry.pack_valid_indices(jnp.asarray(valid),
                                                    n_points)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_backprojection_matches_jax():
    rng = np.random.default_rng(8)
    depth = np.where(rng.uniform(size=(24, 32)) < 0.3,
                     rng.uniform(600, 900, size=(24, 32)), 0.0).astype(
                         np.float32)
    k = jax_geometry.LINEMOD_K.astype(np.float32)
    pts, mask, count = port_geometry.depth_to_pointcloud(_t(depth), _t(k), 300)
    jpts, jmask, jcount = jax_geometry.depth_to_pointcloud(
        jnp.asarray(depth), jnp.asarray(k), 300)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(count) == int(jcount)
    xyz = rng.normal(size=(20, 3)).astype(np.float32) * 0.05
    rt = random_pose(rng).astype(np.float32)
    xy, cam = port_geometry.project(_t(xyz), _t(k), _t(rt))
    jxy, jcam = jax_geometry.project(jnp.asarray(xyz), jnp.asarray(k),
                                     jnp.asarray(rt))
    np.testing.assert_allclose(cam.numpy(), np.asarray(jcam), atol=1e-6)
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_horn_fit_matches_jax(weighted):
    rng = np.random.default_rng(9)
    pose = random_pose(rng)
    p1 = (rng.normal(size=(12, 3)) * 80.0).astype(np.float32)
    p2 = (p1 @ pose[:3, :3].T + pose[:3, 3] * 1000.0
          + rng.normal(size=(12, 3)) * 0.5).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=12).astype(np.float32) if weighted \
        else None
    got = port_fit.horn_fit(_t(p1), _t(p2),
                            None if w is None else _t(w)).numpy()
    want = np.asarray(jax_fit.horn_fit(jnp.asarray(p1), jnp.asarray(p2),
                                       None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=1e-5)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=1e-2)
    np.testing.assert_array_equal(got[3], [0, 0, 0, 1])


def _scattered(row_ends, n=64, seed=12):
    """A (B, n) mask per row: random entries below the row's end, the
    entry just before it valid, nothing at or past it."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((len(row_ends), n), bool)
    for i, end in enumerate(row_ends):
        mask[i, :end] = rng.uniform(size=end) < 0.5
        if end:
            mask[i, end - 1] = True
    return mask


# (mask, each row's last True index + 1)
LIVE_CASES = {
    "packed": (np.arange(64)[None] < np.array([[17], [64], [1], [0]]),
               [17, 64, 1, 0]),
    "scattered": (_scattered([64, 41, 2]), [64, 41, 2]),
    "empty": (np.zeros((2, 64), bool), [0, 0]),
    "full": (np.ones((2, 64), bool), [64, 64]),
    "no points": (np.zeros((2, 0), bool), [0, 0]),
}


@pytest.mark.parametrize("case", LIVE_CASES)
def test_live_extent_is_the_last_valid_index_plus_one(case):
    mask, want = LIVE_CASES[case]
    got = port_voting.live_extent(_t(mask))
    assert got.dtype == torch.int32 and got.shape == (len(want),)
    assert got.tolist() == want


def _bounded_plain(plain, calls):
    """``plain`` (K1's plain version) walking each row's points only below
    the bound that ``voting.vote_counts`` gives K1 (``live_extent(hi >
    0)``), as K1 does with it; records each bound and whether the counts
    equal those over every point."""
    def counts(voxels, points, lo, hi):
        full = plain(voxels, points, lo, hi)
        n_live = port_voting.live_extent(hi > 0)
        vox = voxels.expand(points.shape[0], -1, -1)
        got = torch.cat([plain(vox[i:i + 1], points[i:i + 1, :end],
                               lo[i:i + 1, :end], hi[i:i + 1, :end])
                         for i, end in enumerate(n_live.tolist())])
        calls.append((n_live.tolist(), torch.equal(got, full)))
        return got
    return counts


@pytest.mark.parametrize("layout", ["packed", "scattered"])
@pytest.mark.parametrize("mode", ["hier", "exact"])
def test_accumulate_3d_with_the_live_bound_equals_without(mode, layout,
                                                          monkeypatch):
    """``accumulate_3d`` through the plain route gives the same result
    bit for bit whether its votes walk every point or only each row's
    points up to its last one that can vote, the bound K1 is given (the
    coarse stage's over its strided points): packed clouds of 150 points
    in 256 slots, and the same points scattered with rows of different
    extents."""
    xyz, rad, mask = _clouds(seed=13, n=150, n_pad=256)
    if layout == "scattered":
        rng = np.random.default_rng(14)
        for i, end in enumerate((256, 201, 163)):
            slots = np.sort(rng.choice(end - 1, 149, replace=False))
            slots = np.append(slots, end - 1)
            for arr in (xyz, rad, mask):
                row = arr[i, :150].copy()
                arr[i] = 0
                arr[i, slots] = row
    want = port_voting.accumulate_3d(_t(xyz), _t(rad), _t(mask), grid_l=64,
                                     mode=mode)
    calls = []
    monkeypatch.setattr(vote_cuda, "vote_counts_plain",
                        _bounded_plain(vote_cuda.vote_counts_plain, calls))
    got = port_voting.accumulate_3d(_t(xyz), _t(rad), _t(mask), grid_l=64,
                                    mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    def ends(m):
        return [int(np.flatnonzero(row)[-1]) + 1 for row in m]
    stride = port_voting._CPT_STRIDE
    want_bounds = ([ends(mask[:, ::stride]), ends(mask)] if mode == "hier"
                   else [ends(mask)])
    assert calls == [(bounds, True) for bounds in want_bounds]
    assert min(ends(mask)) < 256        # the bound cut points away
