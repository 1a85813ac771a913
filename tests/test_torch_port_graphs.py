"""CUDA graphs over the serving nets (``models/graphs.py``): what the
estimator's ``GraphedNet``s do off the card and, on the card, that a
replay equals the eager forward.

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

from rcvpose_tpu_torch import infer, profiling, train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.models import fcnresnet, graphs
from rcvpose_tpu_torch.ops import heads

HW = 64
GRAPH_COUNTERS = ("graphs.captured", "graphs.replayed", "graphs.eager")


def _cfg(kpt_heads, dtype="float32", **kw):
    # a threshold below every logit and radii above every map: each pixel
    # with depth is in every mask, whatever the random heads give
    return Config(compute_dtype=dtype, vote_grid_l=64, max_points=1024,
                  image_height=HW, image_width=HW, model_blocks="1,1,1,1",
                  model_width=0.125, kpt_heads=kpt_heads,
                  sem_threshold=-1e30, **kw)


def _estimator(kpt_heads, device="cpu", dtype="float32", **kw):
    cfg = _cfg(kpt_heads, dtype, **kw)
    weights = []
    for i in range(1 if kpt_heads > 1 else 3):
        net = fcnresnet.init_params(train.build_model(cfg),
                                    torch.Generator().manual_seed(i))
        weights.append(net.state_dict())
    keypoints = np.random.default_rng(kpt_heads).normal(size=(9, 3)) * 0.05
    return infer.PoseEstimator(cfg, weights, keypoints, [1e6] * 3,
                               device=device)


def _frame(seed, hw=HW, patch=24):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(hw, hw, 3), dtype=np.uint8)
    depth = np.zeros((hw, hw), np.float32)
    r0 = (hw - patch) // 2
    depth[r0:r0 + patch, r0:r0 + patch] = rng.uniform(
        650.0, 750.0, size=(patch, patch))
    return img, depth


def _eager_twin(est):
    """The same estimator with the bare nets and its pose run in place of
    the pose graph's replay: the frame before graphs."""
    twin = copy.copy(est)
    twin.models = tuple(m.net for m in est.models)
    twin._pose = lambda key, fn, args, copy_out: fn(*args)
    return twin


def _graph_counts():
    counts = profiling.counters()
    return {name: counts.get(name, 0) for name in GRAPH_COUNTERS}


def _equal_results(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# CPU: the eager path, the hooks, copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inference", "train", "grad"])
def test_off_the_card_the_eager_forward_runs_and_counts_nothing(mode):
    est = _estimator(1)
    net = est.models[0]
    x = torch.rand(1, HW, HW, 3, generator=torch.Generator().manual_seed(0))
    before = _graph_counts()
    if mode == "train":
        net.train()
        assert net.net.training
        got = net(x)
        net.eval()
        want = None   # train-mode batch norm moved the statistics
    else:
        context = (torch.inference_mode() if mode == "inference"
                   else torch.enable_grad())
        with context:
            got = net(x)
            want = net.net(x)
    assert _graph_counts() == before
    assert not net._graphs
    assert len(got) == 2 and got[0].shape == (1, HW, HW, 1)
    if want is not None:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    if mode == "grad":
        assert got[0].requires_grad


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_forward_hooks_fire_once_a_call_with_its_outputs(kpt_heads):
    est = _estimator(kpt_heads)
    seen = {i: [] for i in range(len(est.models))}
    handles = [m.register_forward_hook(
        lambda module, args, out, i=i: seen[i].append(out))
        for i, m in enumerate(est.models)]
    pre = []
    handles.append(est.models[0].register_forward_pre_hook(
        lambda module, args: pre.append(args[0].shape)))
    img, depth = _frame(0)
    est.estimate(img, depth)
    est.estimate(*_frame(1))
    for h in handles:
        h.remove()
    assert pre == [(1, HW, HW, 3)] * 2
    x = infer.labels.normalize_image(torch.as_tensor(img))[None]
    with torch.inference_mode():
        for i, m in enumerate(est.models):
            assert len(seen[i]) == 2
            want = m.net(x)
            assert all(torch.equal(g, w) for g, w in zip(seen[i][0], want))


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_cpu_estimator_matches_the_bare_nets(kpt_heads):
    """The CPU estimator gives what it gave before its nets were wrapped:
    the same frame through the bare nets, single and batched."""
    est = _estimator(kpt_heads)
    twin = _eager_twin(est)
    frames = [_frame(s) for s in (2, 3)]
    for img, depth in frames:
        _equal_results(est.estimate(img, depth), twin.estimate(img, depth))
    imgs, deps = (np.stack(a) for a in zip(*frames))
    _equal_results(est.estimate_batch(imgs, deps),
                   twin.estimate_batch(imgs, deps))


@pytest.mark.parametrize("how", ["replicate_to", "deepcopy", "pickle"])
def test_copies_carry_no_graph_and_a_pool_of_their_own(how):
    est = _estimator(1)
    nets = est.models
    marker = object()
    for m in nets:
        m._graphs[("shape",)] = marker
    if how == "replicate_to":
        copies = est.replicate_to("cpu").models
    elif how == "deepcopy":
        copies = copy.deepcopy(nets)
    else:
        for m in nets:
            m._graphs.clear()   # the marker does not pickle
        copies = pickle.loads(pickle.dumps(nets))
    assert len({id(m.pool) for m in copies}) == 1
    assert copies[0].pool is not nets[0].pool
    for old, new in zip(nets, copies):
        assert isinstance(new, graphs.GraphedNet) and new is not old
        assert new._graphs == {}
        assert not new.training and not new.net.training
        for (k, v), w in zip(old.state_dict().items(),
                             new.state_dict().values()):
            assert torch.equal(v, w) and v.data_ptr() != w.data_ptr(), k
    img, depth = _frame(4)
    if how == "replicate_to":
        _equal_results(est.estimate(img, depth),
                       est.replicate_to("cpu").estimate(img, depth))


def test_moving_a_net_drops_its_graphs():
    net = _estimator(3).models[0]
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
    return _estimator(kpt_heads, device=None, dtype="bfloat16", **kw)


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
    before = _graph_counts()
    for seed in range(3):
        img, depth = _frame(seed)
        got = est.estimate(img, depth)
        _equal_results(got, twin.estimate(img, depth))
        x = infer.labels.normalize_image(torch.as_tensor(
            img, device=cuda))[None]
        with torch.inference_mode():
            for out, m in zip(maps[-n:], est.models):
                want = m.net(x)
                for g, w in zip(out, want):
                    assert torch.equal(g, w)
    for h in handles:
        h.remove()
    after = _graph_counts()
    # the first frame ran eagerly and captured; two frames replayed
    assert after["graphs.captured"] - before["graphs.captured"] == n
    assert after["graphs.eager"] - before["graphs.eager"] == n
    assert after["graphs.replayed"] - before["graphs.replayed"] == 2 * n


@pytest.mark.cuda
def test_returned_maps_survive_the_next_replay(cuda):
    est = _card_estimator(3)
    net = est.models[0]
    xs = [infer.labels.normalize_image(torch.as_tensor(
        _frame(s)[0], device=cuda))[None] for s in range(3)]
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
    img, depth = _frame(5, patch=48)
    est.estimate(*_frame(6))           # eager and capture
    before = _graph_counts()
    esc0 = profiling.counters().get("escalations.cropped", 0)
    got = est.estimate(img, depth)
    assert profiling.counters()["escalations.cropped"] == esc0 + 1
    assert got["scene_pts"].shape[1] > est.cfg.max_points
    assert not got["cropped"].any()
    replayed = _graph_counts()["graphs.replayed"] - before["graphs.replayed"]
    assert replayed >= 2 * len(est.models)
    assert replayed % len(est.models) == 0
    _equal_results(got, twin.estimate(img, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_estimate_batch_replays(cuda, kpt_heads):
    est = _card_estimator(kpt_heads)
    twin = _eager_twin(est)
    frames = [_frame(s) for s in (7, 8, 9)]
    est.estimate(*frames[0])           # eager and capture
    imgs, deps = (np.stack(a) for a in zip(*frames))
    before = _graph_counts()
    got = est.estimate_batch(imgs, deps)
    after = _graph_counts()
    assert after["graphs.replayed"] - before["graphs.replayed"] == (
        3 * len(est.models))
    assert after["graphs.captured"] == before["graphs.captured"]
    _equal_results(got, twin.estimate_batch(imgs, deps))


@pytest.mark.cuda
def test_one_graph_a_net_and_shape(cuda):
    est = _card_estimator(1)
    before = _graph_counts()
    for hw in (HW, 96, HW, 96):
        img, depth = _frame(10, hw=hw)
        est.estimate(img, depth)
    after = _graph_counts()
    assert after["graphs.captured"] - before["graphs.captured"] == 3 * 2
    assert after["graphs.replayed"] - before["graphs.replayed"] == 3 * 2
    assert all(len(m._graphs) == 2 for m in est.models)


@pytest.mark.cuda
def test_k2_launches_count_each_forward_that_runs(cuda):
    """K2 counts once a forward, eager or replayed; the capture, which
    runs nothing, counts nothing."""
    est = _card_estimator(1)
    x = infer.labels.normalize_image(torch.as_tensor(
        _frame(11)[0], device=cuda))[None]
    k2 = heads.heads_channel_major_cuda
    with torch.inference_mode():
        for calls in (1, 2, 3):
            before = k2.launches
            for m in est.models:
                m(x)
            assert k2.launches - before == len(est.models), calls


@pytest.mark.cuda
def test_grad_enabled_or_train_mode_on_the_card_runs_eagerly(cuda):
    est = _card_estimator(3)
    net = est.models[0]
    x = infer.labels.normalize_image(torch.as_tensor(
        _frame(12)[0], device=cuda))[None]
    before = _graph_counts()
    with torch.enable_grad():
        got = net(x)
    assert got[0].requires_grad
    net.train()
    net(x)
    net.eval()
    after = _graph_counts()
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
    xs = [infer.labels.normalize_image(torch.as_tensor(
        _frame(20 + i)[0], device=cuda))[None] for i in range(8)]
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
