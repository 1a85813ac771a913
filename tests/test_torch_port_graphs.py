"""CUDA graphs over the serving path (``models/graphs.py``): the one rule
``GraphCache`` keeps for the nets, the pose and the ICP off the card, what
copies of an estimator carry, and, on the card, that the nets' replays
equal the eager forward.

The CPU cases run everywhere. The ``cuda`` cases need an NVIDIA card and
``nvcc`` (K1 and K2 build at first use) and skip elsewhere; the file
imports neither JAX nor the JAX package, so the card's machine runs them:

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_port_graphs.py -q
"""

import copy
import pickle

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import fit, infer, labels, profiling
from rcvpose_tpu_torch.models import graphs
from rcvpose_tpu_torch.ops import heads
from tests.torch_port_estimators import HW, estimator, frame
from tests.torch_port_icp import icp_problem
from tests.torch_port_threads import port_threads  # noqa: F401

GRAPH_COUNTERS = ("graphs.captured", "graphs.replayed", "graphs.eager")
ALL_COUNTERS = tuple(f"{prefix}.{what}" for prefix in ("graphs", "pose", "icp")
                     for what in ("captured", "replayed", "eager"))


def _eager_twin(est):
    """The same estimator with the bare nets and its pose run in place of
    the pose graph's replay: the frame before graphs."""
    twin = copy.copy(est)
    twin.models = tuple(m.net for m in est.models)
    twin._pose = lambda key, fn, args: fn(*args)
    return twin


def _counts(names=GRAPH_COUNTERS):
    counts = profiling.counters()
    return {name: counts.get(name, 0) for name in names}


def _equal_results(a, b):
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


def _caches(est, what=None):
    """The estimator's ``GraphCache``s: the nets', the pose's and the
    ICP's, or those of ``what`` alone."""
    caches = {"nets": [m._graphs for m in est.models], "pose": [est._pose],
              "icp": [est._icp]}
    return caches[what] if what else [c for cs in caches.values() for c in cs]


def _frame_args(est, img, depth):
    """``img`` normalized and ``depth`` on the estimator's device."""
    return (labels.normalize_image(est._put(img, torch.uint8)),
            est._put(depth, torch.float32))


# ---------------------------------------------------------------------------
# CPU: the rule off the card, the hooks, copies
# ---------------------------------------------------------------------------

def _net_off_the_card(est, mode):
    """A net's forward in ``mode`` equals the bare net's; train mode, which
    the serving nets (batch norm folded) do not have, raises and leaves the
    net in eval mode."""
    net = est.models[0]
    x = torch.rand(1, HW, HW, 3, generator=torch.Generator().manual_seed(0))
    if mode == "train":
        with pytest.raises(RuntimeError, match="no train mode"):
            net.train()
        net.eval()
        assert not net.training and not net.net.training
        assert len(net(x)) == 2
        return
    context = (torch.inference_mode() if mode == "inference"
               else torch.enable_grad())
    with context:
        got = net(x)
        want = net.net(x)
    assert len(got) == 2 and got[0].shape == (1, HW, HW, 1)
    # the folded nets hold no trainable parameter
    assert not got[0].requires_grad
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _pose_off_the_card(est):
    """A frame's pose equals the eager ``_pose_from_maps`` of the same
    nets' outputs."""
    img, depth = frame(0)
    got = est.estimate(img, depth)
    with torch.inference_mode():
        x, dep = _frame_args(est, img, depth)
        want = infer._pose_from_maps(
            *infer._maps(infer._forward(est.models, x), est.fused), dep,
            est.k, est.max_radii, est.gt_kpts_mm,
            **est._frame_kwargs(False, est.cfg.max_points))
    _equal_results(got, want)
    assert got["scene_pts"].stride(0) == 0


def _icp_off_the_card(est):
    """Refinements, with grad disabled and enabled, equal the ICP over the
    one masked cloud (all K masks alike), which counts nothing either."""
    cad, target, mask, init = (torch.as_tensor(a) for a in icp_problem(2))
    result = {"scene_pts": target.expand(3, -1, -1),
              "scene_mask": mask.expand(3, -1), "rt": init}
    want = fit.icp_point_to_point(cad, target, mask, init, 6.0, max_iters=3)
    assert torch.equal(est.refine(result, 6.0, icp_iters=3), want)
    with torch.enable_grad():
        assert torch.equal(est.refine(result, 6.0, icp_iters=3), want)


@pytest.mark.parametrize("case", ["net-inference", "net-train", "net-grad",
                                  "pose-3net", "pose-fused", "icp"])
def test_off_the_card_nothing_is_graphed_and_no_counter_moves(case):
    """Off the card each ``GraphCache`` runs its call: a net's forward in
    any mode, ``estimate``'s pose and ``refine``'s ICP give the eager
    results; no cache holds a graph and no ``graphs.*``, ``pose.*`` or
    ``icp.*`` counter moves."""
    what, _, mode = case.partition("-")
    cad = icp_problem(2)[0] if what == "icp" else None
    est = estimator(3 if mode == "fused" else 1, cad_mm=cad)
    before = _counts(ALL_COUNTERS)
    if what == "net":
        _net_off_the_card(est, mode)
    elif what == "pose":
        _pose_off_the_card(est)
    else:
        _icp_off_the_card(est)
    assert _counts(ALL_COUNTERS) == before
    assert not any(_caches(est))


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_forward_hooks_fire_once_a_call_with_its_outputs(kpt_heads):
    est = estimator(kpt_heads)
    seen = {i: [] for i in range(len(est.models))}
    handles = [m.register_forward_hook(
        lambda module, args, out, i=i: seen[i].append(out))
        for i, m in enumerate(est.models)]
    pre = []
    handles.append(est.models[0].register_forward_pre_hook(
        lambda module, args: pre.append(args[0].shape)))
    img, depth = frame(0)
    est.estimate(img, depth)
    est.estimate(*frame(1))
    for h in handles:
        h.remove()
    assert pre == [(1, HW, HW, 3)] * 2
    x = labels.normalize_image(torch.as_tensor(img))[None]
    with torch.inference_mode():
        for i, m in enumerate(est.models):
            assert len(seen[i]) == 2
            want = m.net(x)
            assert all(torch.equal(g, w) for g, w in zip(seen[i][0], want))


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_cpu_estimator_matches_the_bare_nets(kpt_heads):
    """The CPU estimator gives what ``infer._frame_pose(_fused)`` of its
    bare nets gives, bit for bit: the route the CPU took before the pose
    went through a ``GraphCache``; ``estimate_batch`` gives those frames
    stacked."""
    est = estimator(kpt_heads)
    bare = tuple(m.net for m in est.models)
    frames = [frame(s) for s in (2, 3)]
    wants = []
    for img, depth in frames:
        with torch.inference_mode():
            args = (*_frame_args(est, img, depth), est.k, est.max_radii,
                    est.gt_kpts_mm)
            kwargs = est._frame_kwargs(False, est.cfg.max_points)
            wants.append(
                infer._frame_pose_fused(bare[0], *args, **kwargs) if est.fused
                else infer._frame_pose(bare, *args, **kwargs))
        _equal_results(est.estimate(img, depth), wants[-1])
    imgs, deps = (np.stack(a) for a in zip(*frames))
    _equal_results(est.estimate_batch(imgs, deps),
                   {k: torch.stack([w[k] for w in wants]) for k in wants[0]})


@pytest.mark.parametrize("how", ["replicate_to", "deepcopy", "pickle"])
@pytest.mark.parametrize("what", ["nets", "pose", "icp"])
def test_copies_carry_no_graph_and_a_pool_of_their_own(what, how):
    """A replica, a deep copy or a pickle of an estimator has empty caches
    under the same prefixes, all in one new pool, and the original keeps
    its own; the nets are new ``GraphedNet``s in eval mode with equal
    weights in memory of their own. A copy serves the same frame (checked
    once a way of copying: which cache holds the marker does not change
    the copy)."""
    est = estimator(1)
    marker = object()
    for cache in _caches(est, what):
        cache[("key",)] = marker
    if how == "replicate_to":
        new = est.replicate_to("cpu")
    elif how == "deepcopy":
        new = copy.deepcopy(est)
    else:
        new = pickle.loads(pickle.dumps(est))
    pool = new.models[0].pool
    assert pool is not est.models[0].pool
    assert all(cache.pool is pool for cache in _caches(new))
    for old, cache in zip(_caches(est, what), _caches(new, what)):
        assert isinstance(cache, graphs.GraphCache) and cache == {}
        assert cache.prefix == old.prefix and old[("key",)] is marker
    for old, net in zip(est.models, new.models):
        assert isinstance(net, graphs.GraphedNet) and net is not old
        assert not net.training and not net.net.training
        for (k, v), w in zip(old.state_dict().items(),
                             net.state_dict().values()):
            assert torch.equal(v, w) and v.data_ptr() != w.data_ptr(), k
    if what == "pose":
        img, depth = frame(4)
        _equal_results(new.estimate(img, depth), est.estimate(img, depth))


def test_moving_a_net_drops_its_graphs():
    net = estimator(3).models[0]
    net._graphs[("shape",)] = object()
    net.to("cpu")
    assert net._graphs == {}


def test_held_launches_wait_for_count_launches():
    def kernel():
        pass

    kernel.launches = 0
    before = profiling.counters().get("test.not_held", 0)
    with profiling.held_launches() as held:
        profiling.count("launches", 2, owner=kernel)
        profiling.count("test.not_held")
    assert kernel.launches == 0
    assert profiling.counters()["test.not_held"] == before + 1
    assert held == [(kernel, "launches", 2)]
    profiling.count_launches(held)
    profiling.count_launches(held)
    assert kernel.launches == 4


# ---------------------------------------------------------------------------
# The card: replays against the eager forward
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_estimator(kpt_heads, **kw):
    return estimator(kpt_heads, device=None, dtype="bfloat16", **kw)


def _maps_hooks(est):
    maps = []
    handles = [m.register_forward_hook(lambda module, args, out:
                                       maps.append(out))
               for m in est.models]
    return maps, handles


@pytest.mark.cuda
@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_replay_equals_eager_bit_for_bit(cuda, kpt_heads):
    est = _card_estimator(kpt_heads)
    twin = _eager_twin(est)
    n = len(est.models)
    maps, handles = _maps_hooks(est)
    before = _counts()
    for seed in range(3):
        img, depth = frame(seed)
        got = est.estimate(img, depth)
        _equal_results(got, twin.estimate(img, depth))
        x = labels.normalize_image(torch.as_tensor(
            img, device=cuda))[None]
        with torch.inference_mode():
            for out, m in zip(maps[-n:], est.models):
                want = m.net(x)
                for g, w in zip(out, want):
                    assert torch.equal(g, w)
    for h in handles:
        h.remove()
    after = _counts()
    # the first frame ran eagerly and captured; two frames replayed
    assert after["graphs.captured"] - before["graphs.captured"] == n
    assert after["graphs.eager"] - before["graphs.eager"] == n
    assert after["graphs.replayed"] - before["graphs.replayed"] == 2 * n


@pytest.mark.cuda
def test_returned_maps_survive_the_next_replay(cuda):
    est = _card_estimator(3)
    net = est.models[0]
    xs = [labels.normalize_image(torch.as_tensor(
        frame(s)[0], device=cuda))[None] for s in range(3)]
    with torch.inference_mode():
        net(xs[0])                     # eager and capture
        a = net(xs[1])                 # replay
        kept = [t.clone() for t in a]
        b = net(xs[2])                 # replay over the same graph
        torch.cuda.synchronize()
        assert all(torch.equal(t, k) for t, k in zip(a, kept))
        assert not torch.equal(a[0], b[0])
        # seg and radial are views of one buffer, as K2 returns them
        for out in (a, b):
            assert (out[0].untyped_storage().data_ptr()
                    == out[1].untyped_storage().data_ptr())
            assert out[0].stride() == out[1].stride()
        (graph,) = net._graphs.values()
        assert a[0].data_ptr() != graph.out[0].data_ptr()


@pytest.mark.cuda
def test_escalated_frame_replays_and_equals_eager(cuda):
    """A union larger than the packing window and the point budget re-runs
    the frame (full frame, grown budget): the re-runs replay too."""
    est = _card_estimator(1, pack_win_h=32, pack_win_w=32)
    twin = _eager_twin(est)
    img, depth = frame(5, patch=48)
    est.estimate(*frame(6))            # eager and capture
    before = _counts()
    esc0 = profiling.counters().get("escalations.cropped", 0)
    got = est.estimate(img, depth)
    assert profiling.counters()["escalations.cropped"] == esc0 + 1
    assert got["scene_pts"].shape[1] > est.cfg.max_points
    assert not got["cropped"].any()
    replayed = _counts()["graphs.replayed"] - before["graphs.replayed"]
    assert replayed >= 2 * len(est.models)
    assert replayed % len(est.models) == 0
    _equal_results(got, twin.estimate(img, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_estimate_batch_replays(cuda, kpt_heads):
    est = _card_estimator(kpt_heads)
    twin = _eager_twin(est)
    frames = [frame(s) for s in (7, 8, 9)]
    est.estimate(*frames[0])           # eager and capture
    imgs, deps = (np.stack(a) for a in zip(*frames))
    before = _counts()
    got = est.estimate_batch(imgs, deps)
    after = _counts()
    assert after["graphs.replayed"] - before["graphs.replayed"] == (
        3 * len(est.models))
    assert after["graphs.captured"] == before["graphs.captured"]
    _equal_results(got, twin.estimate_batch(imgs, deps))


@pytest.mark.cuda
def test_one_graph_a_net_and_shape(cuda):
    est = _card_estimator(1)
    before = _counts()
    for hw in (HW, 96, HW, 96):
        img, depth = frame(10, hw=hw)
        est.estimate(img, depth)
    after = _counts()
    assert after["graphs.captured"] - before["graphs.captured"] == 3 * 2
    assert after["graphs.replayed"] - before["graphs.replayed"] == 3 * 2
    assert all(len(m._graphs) == 2 for m in est.models)


@pytest.mark.cuda
def test_k2_launches_count_each_forward_that_runs(cuda):
    """K2 counts once a forward, eager or replayed; the capture, which
    runs nothing, counts nothing."""
    est = _card_estimator(1)
    x = labels.normalize_image(torch.as_tensor(
        frame(11)[0], device=cuda))[None]
    k2 = heads.heads_channel_major_cuda
    with torch.inference_mode():
        for calls in (1, 2, 3):
            before = k2.launches
            for m in est.models:
                m(x)
            assert k2.launches - before == len(est.models), calls


@pytest.mark.cuda
def test_grad_enabled_or_train_mode_on_the_card_runs_eagerly(cuda):
    """Grad enabled runs eagerly; train mode, which the folded serving nets
    do not have, raises and captures nothing."""
    est = _card_estimator(3)
    net = est.models[0]
    x = labels.normalize_image(torch.as_tensor(
        frame(12)[0], device=cuda))[None]
    before = _counts()
    with torch.enable_grad():
        got = net(x)
    assert not got[0].requires_grad
    with pytest.raises(RuntimeError, match="no train mode"):
        net.train()
    net.eval()
    assert not net.net.training
    after = _counts()
    assert after["graphs.eager"] - before["graphs.eager"] == 1
    assert after["graphs.captured"] == before["graphs.captured"]
    assert not net._graphs


@pytest.mark.cuda
def test_threads_on_streams_of_their_own_get_their_own_maps(cuda):
    """Threads replaying one estimator's nets, each on a stream of its
    own, each get the maps of their own input: the pool's lock and its
    wait on the last replay's stream keep the shared graph memory apart."""
    import sys
    import threading

    est = _card_estimator(1)
    xs = [labels.normalize_image(torch.as_tensor(
        frame(20 + i)[0], device=cuda))[None] for i in range(8)]
    with torch.inference_mode():
        want = [[m.net(x) for m in est.models] for x in xs]
        for m in est.models:
            m(xs[0])                   # eager and capture
    torch.cuda.synchronize()
    bad = []

    def serve(i):
        stream = torch.cuda.Stream(cuda)
        with torch.inference_mode(), torch.cuda.stream(stream):
            for _ in range(5):
                got = [m(xs[i]) for m in est.models]
                stream.synchronize()
                bad.extend((i, j) for j, (g, w) in enumerate(
                    zip(got, want[i])) if not torch.equal(g[0], w[0]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
