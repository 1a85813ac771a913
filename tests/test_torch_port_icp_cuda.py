"""The refinement's ICP: ``PoseEstimator.refine`` over the one scene cloud,
the kernels of ``ops/icp_cuda.py`` against the tensor ops they stand for,
and ``refine``'s CUDA graph (a ``models.graphs.GraphCache``).

The CPU cases run everywhere. The ``cuda`` cases need an NVIDIA card and
``nvcc`` (the ICP library builds at first use) and skip elsewhere; the file
imports neither JAX nor the JAX package, so the card's machine runs them:

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_port_icp_cuda.py -q
"""

import sys
import threading

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import fit, profiling
from rcvpose_tpu_torch.ops import icp_cuda
from tests.torch_port_estimators import estimator
from tests.torch_port_icp import icp_problem, rot
from tests.torch_port_threads import port_threads  # noqa: F401

ICP_COUNTERS = ("icp.captured", "icp.replayed", "icp.eager")
ITERS = 30


def _t(x, device="cpu"):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _icp_counts():
    counts = profiling.counters()
    return {name: counts.get(name, 0) for name in ICP_COUNTERS}


def _estimator(cad_mm, device="cpu"):
    """The tiny fused estimator, whose ``refine`` is under test (its net
    takes no part in it)."""
    return estimator(3, device=device, cad_mm=cad_mm, icp_iters=ITERS)


def _lm_scene(seed, n_src=3000, n_points=8192, n_valid=5000, k=3,
              depth=800.0):
    """The refine cell's shapes at LINEMOD's scale: a CAD ellipsoid of
    ``n_src`` points (semi-axes 60 / 40 / 30 mm), a packed scene of
    ``n_points`` whose first ``n_valid`` points are the object at
    ``depth`` mm (1 mm noise) and clutter, the rest padding, each
    keypoint's mask a random subset of the valid points, and an initial
    pose a few degrees and millimetres off. Returns numpy arrays: cad
    (S, 3), scene_pts (K, n, 3) (one cloud), scene_mask (K, n), rt
    (4, 4)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_src, 3))
    cad = u / np.linalg.norm(u, axis=1, keepdims=True) * [60.0, 40.0, 30.0]
    r = rot(rng.normal(size=3), rng.uniform(0, np.pi))
    t = np.array([rng.uniform(-80, 80), rng.uniform(-60, 60), depth])
    n_obj = (2 * n_valid) // 3
    obj = cad[rng.integers(0, n_src, n_obj)] @ r.T + t
    clutter = t + rng.uniform(-150, 150, size=(n_valid - n_obj, 3))
    pts = np.zeros((n_points, 3))
    pts[:n_valid] = np.concatenate([obj + rng.normal(size=obj.shape),
                                    clutter])
    mask = np.zeros((k, n_points), bool)
    mask[:, :n_valid] = rng.uniform(size=(k, n_valid)) < 0.8
    mask[0, :n_valid] |= ~mask.any(axis=0)[:n_valid]
    init = np.eye(4)
    init[:3, :3] = rot(rng.normal(size=3), 0.06) @ r
    init[:3, 3] = t + rng.normal(size=3) * 4.0
    return (cad.astype(np.float32),
            np.broadcast_to(pts.astype(np.float32), (k, n_points, 3)),
            mask, init.astype(np.float32))


def _result(scene, mask, rt, device="cpu"):
    return {"scene_pts": _t(scene, device),
            "scene_mask": torch.tensor(mask, device=device),
            "rt": rt.to(device) if torch.is_tensor(rt) else _t(rt, device)}


def _placed(rt, cad):
    return cad @ rt[:3, :3].T + rt[:3, 3]


def _problem(seed, device="cpu", t=(10.0, -20.0, 80.0)):
    """``tests/torch_port_icp.py``'s lattice problem as tensors: cad,
    target, mask, init."""
    cad, target, mask, init = icp_problem(seed, t)
    return (_t(cad, device), _t(target, device),
            torch.tensor(mask, device=device), _t(init, device))


# ---------------------------------------------------------------------------
# CPU: the one cloud, the plain versions
# ---------------------------------------------------------------------------

def _refine_both_ways(seed, same_masks, depth):
    """``refine`` (row 0 of ``scene_pts``, the OR of the masks) and the
    ICP over the K copies with their own masks, as the JAX package runs
    it: (cad, union pose, K-copy pose)."""
    cad, scene, mask, rt = _lm_scene(seed, n_src=400, n_points=1024,
                                     n_valid=700, depth=depth)
    if same_masks:
        mask = np.broadcast_to(mask.any(axis=0), mask.shape).copy()
    got = _estimator(cad).refine(_result(scene, mask, rt), 20.0,
                                 icp_iters=ITERS)
    want = fit.icp_point_to_point(_t(cad), _t(scene).reshape(-1, 3),
                                  torch.tensor(mask).reshape(-1), _t(rt),
                                  20.0, max_iters=ITERS)
    assert not torch.equal(got, _t(rt))
    return _t(cad), got, want


@pytest.mark.parametrize("seed", [0, 1, 3])
@pytest.mark.parametrize("same_masks, depth", [(True, 800.0), (False, 80.0)],
                         ids=["same-masks-800mm", "own-masks-80mm"])
def test_refine_on_the_union_cloud_equals_the_k_copies(seed, same_masks,
                                                       depth):
    """Bit for bit where no two distinct targets tie exactly: keypoint
    masks that agree (a copy's tie resolves by index either way), or own
    masks near the camera, where d2 rounds to finer steps than ties need."""
    _, got, want = _refine_both_ways(seed, same_masks, depth)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
def test_refine_on_the_union_cloud_within_ties_at_linemod_depth(seed):
    """Own masks at 800 mm: d2 rounds to steps of 1/16 mm^2 there, so two
    distinct targets tie exactly now and then. ``refine`` orders the
    union's targets by the first keypoint whose mask holds them, so a tie
    resolves to the target the K copies take (the earlier copy, then the
    lower index): bit for bit."""
    _, got, want = _refine_both_ways(seed, False, 800.0)
    assert torch.equal(got, want)


def test_kernels_refuse_what_they_do_not_take():
    cad, target, mask, init = _problem(8)
    t2 = (target * target).sum(dim=1)
    keys = icp_cuda.new_keys(cad.shape[0], "cpu")
    for args, what in (((cad[:, :2], target, t2, mask, keys), "src"),
                       ((cad, target[:0], t2, mask, keys), "target"),
                       ((cad, target, t2[:-1], mask, keys), "t2"),
                       ((cad, target, t2, mask, keys), "CUDA")):
        with pytest.raises(ValueError, match=what):
            icp_cuda.nearest_cuda(*args)
    s3 = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="rt"):
        icp_cuda.update_pose_cuda(s3, s3[0], s3[0], s3[0, 0], init[:3])
    with pytest.raises(ValueError, match="CUDA"):
        icp_cuda.update_pose_cuda(s3, s3[0], s3[0], s3[0, 0], init)


# ---------------------------------------------------------------------------
# The card: kernels, the graph, threads
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ICP kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_problem(seed, cuda, **kw):
    """``_lm_scene`` on the card as the ICP takes it: cad, target (row 0),
    the OR of the masks, rt; and the scene and masks as numpy."""
    cad, scene, mask, rt = _lm_scene(seed, **kw)
    return (_t(cad, cuda), _t(scene[0], cuda),
            torch.tensor(mask.any(axis=0), device=cuda), _t(rt, cuda),
            scene, mask)


def _tensor_route(*args, **kw):
    """``fit.icp_point_to_point`` through the tensor ops, on any device."""
    kw = {"max_iters": ITERS, "rel_fitness": None, "rel_rmse": None,
          "return_iters": False, **kw}
    return fit._icp(*args, **kw, kernels=False)


def _k_copies(cad, scene, mask, rt, threshold, kernels):
    """The ICP over the K copies of the scene with their own masks, as the
    benchmark's reference and the JAX package run it, on ``cad``'s device
    through the kernels or the tensor ops."""
    dev = cad.device
    return fit._icp(cad, _t(scene, dev).reshape(-1, 3),
                    torch.tensor(mask, device=dev).reshape(-1), rt.to(dev),
                    threshold, ITERS, None, None, False, kernels=kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 8192, 5000), (3000, 24576, 15000),
                                   (37, 300, 123), (700, 1000, 0)],
                         ids=["lm", "lm-3-copies", "ragged", "all-masked"])
def test_nearest_kernel_equals_fit_nn(cuda, shape):
    """The kernel's indices and distances equal ``fit._nn``'s (the matmul
    form through cuBLAS) bit for bit, from several poses; no masked target
    is chosen; the keys are reset."""
    n_src, n_points, n_valid = shape
    cad, target, mask, rt, _, _ = _card_problem(11, cuda, n_src=n_src,
                                                n_points=n_points,
                                                n_valid=max(n_valid, 1))
    if n_valid == 0:
        mask = torch.zeros_like(mask)
    t2 = (target * target).sum(dim=1)
    keys = icp_cuda.new_keys(n_src, cuda)
    for step in range(4):
        src = cad @ rt[:3, :3].T + rt[:3, 3]
        launches = icp_cuda.nearest_cuda.launches
        idx, dist = icp_cuda.nearest_cuda(src, target, t2, mask, keys)
        assert icp_cuda.nearest_cuda.launches == launches + 2
        want_idx, want_dist = fit._nn(src, target, t2, mask)
        assert torch.equal(idx, want_idx), step
        assert torch.equal(dist, want_dist), step
        assert bool(mask[idx].all()) or n_valid == 0
        assert bool((keys == icp_cuda.NO_KEY).all())
        rt = fit.icp_point_to_point(cad, target, mask, rt, 20.0, max_iters=1)


@pytest.mark.cuda
def test_update_kernel_equals_fit_update_pose(cuda):
    """Horn's solve, the keep rule and the composition equal
    ``fit._update_pose``'s tensor ops bit for bit: on random sums at
    several scales, with fewer than 3 correspondences, and on the sums of
    real updates."""
    g = torch.Generator(device=cuda).manual_seed(3)
    cases = []
    for scale in (1e-3, 1.0, 1e2, 1e6):
        for n_corr in (0.0, 2.0, 3.0, 2900.0):
            s = torch.randn(3, 3, generator=g, device=cuda) * scale
            c = torch.randn(2, 3, generator=g, device=cuda) * 800.0
            rt = torch.eye(4, device=cuda)
            rt[:3] += torch.randn(3, 4, generator=g, device=cuda) * 0.1
            cases.append((s, c[0], c[1], torch.tensor(n_corr, device=cuda),
                          rt))
    cad, target, mask, rt, _, _ = _card_problem(12, cuda)
    src = cad @ rt[:3, :3].T + rt[:3, 3]
    idx, dist = fit._nn(src, target, (target * target).sum(dim=1), mask)
    w = (dist <= 20.0).to(torch.float32)
    cases.append((*fit._horn_sums(src, target[idx], w), w.sum(), rt))
    for k, case in enumerate(cases):
        launches = icp_cuda.update_pose_cuda.launches
        got = icp_cuda.update_pose_cuda(*case)
        assert icp_cuda.update_pose_cuda.launches == launches + 1
        assert torch.equal(got, fit._update_pose(*case)), k
        if float(case[3]) < 3.0:
            assert torch.equal(got, case[4])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [13, 14])
def test_kernel_route_equals_the_tensor_route_on_the_card(cuda, seed):
    """A whole ICP through the kernels gives the tensor route's pose on
    the card bit for bit, 1 and 30 fixed updates, and converged mode the
    same pose after the same number of updates."""
    cad, target, mask, rt, _, _ = _card_problem(seed, cuda)
    for iters in (1, ITERS):
        got = fit.icp_point_to_point(cad, target, mask, rt, 20.0,
                                     max_iters=iters)
        assert torch.equal(got, _tensor_route(cad, target, mask, rt, 20.0,
                                              max_iters=iters)), iters
        assert not torch.equal(got, rt)
    kw = dict(max_iters=50, rel_fitness=1e-6, rel_rmse=1e-4,
              return_iters=True)
    got, n = fit.icp_point_to_point(cad, target, mask, rt, 20.0, **kw)
    want, want_n = _tensor_route(cad, target, mask, rt, 20.0, **kw)
    assert n == want_n and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("depth, iters", [(80.0, 1), (80.0, ITERS),
                                          (800.0, ITERS)])
def test_kernel_route_against_the_cpu_route(cuda, depth, iters):
    """Against the tensor ops on the CPU (another matmul and other sums)
    on a cloud whose neighbours stay at least 2 mm apart: CAD points placed
    within 1e-3 mm, after one update near the camera and once converged at
    LINEMOD's depth. (The first update at 800 mm starts from a pose off by
    up to half the lattice's spacing, where a source point can lie within
    the 1/16 mm^2 that d2 rounds to there of two targets, and the CPU's
    rounding can pick the other one.)"""
    cad, target, mask, rt = _problem(13, cuda, (10.0, -20.0, depth))
    got = fit.icp_point_to_point(cad, target, mask, rt, 6.0, max_iters=iters)
    want = fit.icp_point_to_point(cad.cpu(), target.cpu(), mask.cpu(),
                                  rt.cpu(), 6.0, max_iters=iters)
    dist = torch.linalg.vector_norm(_placed(got.cpu(), cad.cpu())
                                    - _placed(want, cad.cpu()), dim=1)
    assert float(dist.max()) <= 1e-3
    assert not torch.equal(got.cpu(), rt.cpu())


@pytest.mark.cuda
def test_fewer_than_three_correspondences_keep_the_pose(cuda):
    cad, target, mask, init = _problem(4, cuda)
    init = init.clone()
    init[:3, 3] += 500.0   # nothing within the threshold
    got = fit.icp_point_to_point(cad, target, mask, init, 1.0, max_iters=5)
    assert torch.equal(got, init)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6])
def test_converged_update_count_matches_the_cpu_route(cuda, seed):
    """Open3D's convergence test (``tests/test_torch_port_eval.py``'s
    problem and tolerances): the same number of updates as the CPU route,
    no ``icp.*`` counter moved, and the pose within its parity
    tolerances."""
    kw = dict(max_iters=50, rel_fitness=1e-6, rel_rmse=1e-4,
              return_iters=True)
    want, want_it = fit.icp_point_to_point(*_problem(seed), 6.0, **kw)
    before = _icp_counts()
    got, got_it = fit.icp_point_to_point(*_problem(seed, cuda), 6.0, **kw)
    assert got_it == want_it and 1 < got_it < 50
    assert _icp_counts() == before   # not a refinement of the estimator
    np.testing.assert_allclose(got[:3, :3].cpu().numpy(),
                               want[:3, :3].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:3, 3].cpu().numpy(), want[:3, 3].numpy(),
                               rtol=0, atol=1e-2)


def _launches():
    return (icp_cuda.nearest_cuda.launches, icp_cuda.update_pose_cuda.launches)


@pytest.mark.cuda
def test_refine_replays_one_graph_equal_to_the_eager_icp(cuda):
    """The first refinement at a shape runs eagerly and captures; later
    ones replay. Each pose equals the ICP over the K copies with their
    own masks on the card, through the kernels and through the tensor
    ops, bit for bit, whatever the threshold; each replay counts its
    kernels' launches."""
    cad = _lm_scene(20)[0]
    est = _estimator(cad, device=None)
    before, launches = _icp_counts(), _launches()
    got = []
    for seed, thr in ((21, 20.0), (22, 20.0), (23, 35.5)):
        _, _, _, rt, scene, mask = _card_problem(seed, cuda)
        got.append((est.refine(_result(scene, mask, rt, cuda), thr),
                    scene, mask, rt, thr))
    after, now = _icp_counts(), _launches()
    assert after["icp.captured"] - before["icp.captured"] == 1
    assert after["icp.eager"] - before["icp.eager"] == 1
    assert after["icp.replayed"] - before["icp.replayed"] == 2
    assert (now[0] - launches[0], now[1] - launches[1]) == (
        3 * 2 * ITERS, 3 * ITERS)
    assert len(est._icp) == 1
    for pose, scene, mask, rt, thr in got:
        args = (est.cad_mm, scene, mask, rt, thr)
        assert torch.equal(pose, _k_copies(*args, kernels=True))
        assert torch.equal(pose, _k_copies(*args, kernels=False))
        assert not torch.equal(pose, rt)


@pytest.mark.cuda
def test_refine_with_grad_enabled_replays_too(cuda):
    """``refine`` runs in inference mode, so a caller's ``enable_grad``
    neither keeps it from the graph nor changes its pose."""
    _, _, _, rt, scene, mask = _card_problem(24, cuda, n_src=300,
                                             n_points=1024, n_valid=600)
    est = _estimator(_lm_scene(24, n_src=300)[0], device=None)
    res = _result(scene, mask, rt, cuda)
    first = est.refine(res, 20.0, icp_iters=5)
    before = _icp_counts()
    with torch.enable_grad():
        got = est.refine(res, 20.0, icp_iters=5)
    after = _icp_counts()
    assert after["icp.replayed"] == before["icp.replayed"] + 1
    assert after["icp.eager"] == before["icp.eager"]
    assert torch.equal(got, first) and not got.requires_grad


@pytest.mark.cuda
def test_escalated_n_points_captures_a_second_graph(cuda):
    cad = _lm_scene(30)[0]
    est = _estimator(cad, device=None)
    before = _icp_counts()
    for n_points in (8192, 16384, 8192, 16384):
        _, _, _, rt, scene, masks = _card_problem(
            31, cuda, n_points=n_points, n_valid=n_points // 2)
        pose = est.refine(_result(scene, masks, rt, cuda), 20.0)
        want = _k_copies(est.cad_mm, scene, masks, rt, 20.0, kernels=False)
        assert torch.equal(pose, want), n_points
    after = _icp_counts()
    assert after["icp.captured"] - before["icp.captured"] == 2
    assert after["icp.replayed"] - before["icp.replayed"] == 2
    assert len(est._icp) == 2


@pytest.mark.cuda
def test_threads_on_streams_of_their_own_get_their_own_poses(cuda):
    """Threads refining through one estimator, each on a stream of its
    own, each get the pose of their own scene, and their inputs stay as
    they were: the pool's lock, its wait on the last replay's stream and
    the graph's own copies of the inputs keep them apart."""
    cad = _lm_scene(40)[0]
    est = _estimator(cad, device=None)
    results, kept, want = [], [], []
    for i in range(8):
        _, _, _, rt, scene, mask = _card_problem(41 + i, cuda)
        res = _result(scene, mask, rt, cuda)
        results.append(res)
        kept.append({k: v.clone() for k, v in res.items()})
        want.append(_k_copies(est.cad_mm, scene, mask, rt, 20.0,
                              kernels=False))
    est.refine(results[0], 20.0)       # eager and capture
    torch.cuda.synchronize()
    bad = []

    def serve(i):
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            for _ in range(5):
                got = est.refine(results[i], 20.0)
                stream.synchronize()
                if not torch.equal(got, want[i]):
                    bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(len(results))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    for res, old in zip(results, kept):
        assert all(torch.equal(res[k], old[k]) for k in res)
