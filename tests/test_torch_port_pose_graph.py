"""The CUDA graph over the serving pose: ``PoseEstimator.estimate`` replays
``infer._pose_from_maps`` (packing, the hier vote, Horn's fit) as one
graph a key through ``models.graphs.GraphCache`` (counters ``pose.*``).

The CPU cases run everywhere: ``ops.voting._prepare``'s bounds as Python
scalars and the packed outputs a replay copies out
(``tests/test_torch_port_graphs.py`` holds the pose off the card and the
copies of an estimator). The ``cuda`` cases need
an NVIDIA card and ``nvcc`` (K1 and K2 build at first use) and skip
elsewhere; the file imports neither JAX nor the JAX package, so the card's
machine runs them:

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_port_pose_graph.py -q
"""

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import infer, labels, profiling
from rcvpose_tpu_torch.models import graphs
from rcvpose_tpu_torch.ops import vote_cuda, voting
from tests.torch_port_estimators import estimator, frame
from tests.torch_port_threads import port_threads  # noqa: F401

POSE_COUNTERS = ("pose.captured", "pose.replayed", "pose.eager")


def _pose_counts():
    counts = profiling.counters()
    return {name: counts.get(name, 0) for name in POSE_COUNTERS}


def _outputs(est, img):
    """The estimator's nets' outputs for ``img`` (``infer._forward``)."""
    with torch.inference_mode():
        x = labels.normalize_image(est._put(img, torch.uint8))
        return infer._forward(est.models, x)


def _eager_pose(est, outs, depth, full_frame=False, n_points=None):
    """``_pose_from_maps`` run op by op on the nets' outputs ``outs``."""
    kwargs = est._frame_kwargs(full_frame, n_points or est.cfg.max_points)
    with torch.inference_mode():
        return infer._pose_from_maps(
            *infer._maps(outs, est.fused), est._put(depth, torch.float32),
            est.k, est.max_radii, est.gt_kpts_mm, **kwargs)


def _assert_same(got, want, expanded=True):
    """Every output equal bit for bit, in dtype, shape and order too;
    ``scene_pts`` an expand of one cloud over the keypoints."""
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(g, w), key
    assert got["scene_pts"].stride(0) == 0 or not expanded


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


class _Replays(dict):
    """The pose's ``GraphCache`` off the card: each call at a key runs
    ``fn``, writes its outputs over the key's static outputs (as a replay
    overwrites them) and returns the cache's owned copies of those."""

    def __call__(self, key, fn, args):
        out = fn(*args)
        static = self.setdefault(key, out)
        for s, o in zip(static, out):
            s.copy_(o)
        return graphs._own_copy(static)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["masked", "empty", "one point"])
def test_prepare_scalar_bounds_equal_the_tensor_form(case, monkeypatch):
    """``_prepare``'s +-3e38 bounds as Python scalars give what the 0-d
    f32 tensor it held before gave, bit for bit: masked batches and a
    batch whose masks are empty (where the bounds reach the outputs)."""
    gen = torch.Generator().manual_seed(7)
    xyz = torch.rand(3, 50, 3, generator=gen) * 0.3 + 0.6
    radial = torch.rand(3, 50, generator=gen) * 2.0
    mask = torch.rand(3, 50, generator=gen) < 0.6
    if case == "empty":
        mask[:] = False
    elif case == "one point":
        mask[:] = False
        mask[:, 17] = True
    got = voting._prepare(xyz, radial, mask)

    where = torch.where

    def tensor_form(cond, a, b=None):
        if isinstance(b, float):
            b = torch.tensor(b, dtype=torch.float32, device=a.device)
        return where(cond, a, b)

    monkeypatch.setattr(torch, "where", tensor_form)
    want = voting._prepare(xyz, radial, mask)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    if case == "empty":
        assert torch.isinf(got[4]).all()   # the bounds reached ``bound``


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_graphed_route_copies_its_outputs_out(kpt_heads):
    """``_pose_of`` through a stand-in that overwrites the static
    outputs at each call, as replays do: each result equals the eager pose,
    shares no storage with the static outputs, and outlives the next call
    at its key; ``scene_pts`` is an expand of one (n_points, 3) cloud."""
    est = estimator(kpt_heads)
    est._pose = _Replays()
    kwargs = est._frame_kwargs(False, est.cfg.max_points)
    results = []
    for seed in (1, 2):
        img, depth = frame(seed)
        outs = _outputs(est, img)
        with torch.inference_mode():
            got = est._pose_of(outs, est._put(depth, torch.float32),
                                    kwargs)
        _assert_same(got, _eager_pose(est, outs, depth))
        results.append((got, {k: v.clone() for k, v in got.items()}))
    (static,) = est._pose.values()
    assert len(static) == 3             # one buffer a dtype
    for got, kept in results:
        assert not _storages(got.values()) & _storages(static)
        assert got["scene_pts"][0].shape == (est.cfg.max_points, 3)
        assert all(torch.equal(got[k], kept[k]) for k in kept)
    assert not torch.equal(results[0][0]["rt"], results[1][0]["rt"])


# ---------------------------------------------------------------------------
# The card: replays against the eager pose
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_estimator(kpt_heads, **kw):
    return estimator(kpt_heads, device=None, dtype="bfloat16", **kw)


def _hooked(est):
    """A list that gathers each net forward's outputs, and the hooks."""
    outs = []
    handles = [m.register_forward_hook(lambda module, args, out:
                                       outs.append(out))
               for m in est.models]
    return outs, handles


@pytest.mark.cuda
@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_graphed_pose_equals_eager_bit_for_bit(cuda, kpt_heads):
    """Over N frames at the serving key: each pose equals the eager
    ``_pose_from_maps`` of the same maps in every output; the first frame
    runs eagerly and captures, the rest replay; K1 counts 2 launches a
    frame; one ``rcvpose.pose`` span a frame, the stage spans only in the
    first (the eager run and the capture)."""
    from torch.profiler import ProfilerActivity, profile

    est = _card_estimator(kpt_heads)
    maps, handles = _hooked(est)
    n = len(est.models)
    frames = [frame(seed) for seed in range(4)]
    before = _pose_counts()
    got, k1 = [], []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for img, depth in frames:
            launches = vote_cuda.vote_counts_cuda.launches
            got.append((est.estimate(img, depth),
                        tuple(t for out in maps[-n:] for t in out)))
            k1.append(vote_cuda.vote_counts_cuda.launches - launches)
    for h in handles:
        h.remove()
    after = _pose_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "pose.captured": 1, "pose.replayed": len(frames) - 1,
        "pose.eager": 1}
    assert k1 == [2] * len(frames)
    spans = {e.key: e.count for e in prof.key_averages()}
    assert spans["rcvpose.pose"] == len(frames)
    assert spans["rcvpose.pack"] == spans["rcvpose.fit"] == 2
    for (result, outs), (_, depth) in zip(got, frames):
        _assert_same(result, _eager_pose(est, outs, depth))
    assert len(est._pose) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("full_frame, n_points",
                         [(True, None), (False, 16384)],
                         ids=["forced_crop", "forced_budget"])
def test_a_new_key_captures_and_equals_eager(cuda, full_frame, n_points):
    """Full-frame packing or a grown point budget is a key of its own: its
    first call runs eagerly and captures, the next replays, and both equal
    the eager pose at the same packing."""
    est = _card_estimator(1)
    est.estimate(*frame(4))                # the serving key
    kwargs = est._frame_kwargs(full_frame, n_points or est.cfg.max_points)
    before = _pose_counts()
    for seed in (5, 6):
        img, depth = frame(seed, patch=40)
        outs = _outputs(est, img)
        with torch.inference_mode():
            got = est._pose_of(outs, est._put(depth, torch.float32),
                                    kwargs)
        _assert_same(got, _eager_pose(est, outs, depth, full_frame,
                                      kwargs["n_points"]))
    after = _pose_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "pose.captured": 1, "pose.replayed": 1, "pose.eager": 1}
    assert len(est._pose) == 2


@pytest.mark.cuda
def test_pose_at_a_derived_budget_equals_the_unbounded_vote(cuda,
                                                            monkeypatch):
    """A point budget derived from the CAD (``max_points=0``) well above
    the frames' unions, as in the YCB deployment: each replayed pose, whose
    K1 walks each keypoint's live points only (2 bounded launches a frame),
    equals bit for bit the eager pose whose K1 walks the whole budget."""
    dirs = np.random.default_rng(15).normal(size=(500, 3))
    cad = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * 25.0
    est = _card_estimator(1, cad_mm=cad, max_points=0, pack_win_h=64,
                          pack_win_w=64)
    assert est.n_points == 3072
    maps, handles = _hooked(est)
    frames = [frame(seed, patch=patch)
              for seed, patch in ((20, 24), (21, 40), (22, 12), (23, 31))]
    live = vote_cuda.vote_counts_cuda.live_bounded
    got = []
    for img, depth in frames:
        got.append((est.estimate(img, depth),
                    tuple(t for out in maps[-3:] for t in out)))
    for h in handles:
        h.remove()
    assert vote_cuda.vote_counts_cuda.live_bounded == live + 2 * len(frames)
    assert len(est._pose) == 1
    monkeypatch.setattr(voting, "vote_counts",
                        lambda *args: vote_cuda.vote_counts_cuda(*args))
    for (result, outs), (_, depth) in zip(got, frames):
        assert int(result["union_count"]) < est.n_points
        _assert_same(result, _eager_pose(est, outs, depth,
                                         n_points=est.n_points))


@pytest.mark.cuda
def test_a_replays_outputs_survive_the_next_replay(cuda):
    est = _card_estimator(1)
    est.estimate(*frame(7))                # eager and capture
    first = est.estimate(*frame(8))        # replay
    kept = {k: v.clone() for k, v in first.items()}
    second = est.estimate(*frame(9))       # replay over the same graph
    torch.cuda.synchronize()
    assert all(torch.equal(first[k], kept[k]) for k in kept)
    assert not torch.equal(first["rt"], second["rt"])
    (graph,) = est._pose.values()
    for result in (first, second):
        assert not _storages(result.values()) & _storages(graph.out)
        assert result["scene_pts"].stride(0) == 0


@pytest.mark.cuda
def test_refine_on_a_replayed_pose_equals_refine_on_the_eager_one(cuda):
    cad = np.random.default_rng(10).normal(size=(300, 3)).astype(
        np.float32) * 20.0
    est = _card_estimator(1, cad_mm=cad, icp_iters=10)
    maps, handles = _hooked(est)
    est.estimate(*frame(11))               # eager and capture
    img, depth = frame(12)
    got = est.estimate(img, depth)         # replay
    for h in handles:
        h.remove()
    want = _eager_pose(est, tuple(t for out in maps[-3:] for t in out),
                       depth)
    _assert_same(got, want)
    assert torch.equal(est.refine(got, 1000.0), est.refine(want, 1000.0))


@pytest.mark.cuda
def test_other_callers_run_the_pose_eagerly(cuda):
    """``estimate_batch`` and ``_frame_pose`` (the route of ``bench.py``,
    ``parallel.mesh`` and ``eval``) take no pose graph."""
    est = _card_estimator(1)
    frames = [frame(s) for s in (13, 14)]
    est.estimate(*frames[0])               # eager and capture
    before = _pose_counts()
    imgs, deps = (np.stack(a) for a in zip(*frames))
    batch = est.estimate_batch(imgs, deps)
    with torch.inference_mode():
        x = labels.normalize_image(est._put(frames[1][0], torch.uint8))
        single = infer._frame_pose(
            est.models, x, est._put(frames[1][1], torch.float32), est.k,
            est.max_radii, est.gt_kpts_mm,
            **est._frame_kwargs(False, est.cfg.max_points))
    assert _pose_counts() == before and len(est._pose) == 1
    _assert_same({k: v[1] for k, v in batch.items()}, single,
                 expanded=False)
