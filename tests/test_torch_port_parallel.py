"""The port's meshes (``rcvpose_tpu_torch.parallel``) against the JAX
package's ``rcvpose_tpu.parallel``.

* ``sharded_vote_counts`` over two gloo ranks (one and two CPU slots a
  rank) against the JAX function on a 2- and 4-device CPU mesh, exactly;
* ``host_allgather``/``host_allgather_concat`` across two ranks, with
  ragged lengths;
* ``sharded_frame_pose``/``sharded_frame_scores`` over a mesh of two CPU
  slots against the JAX functions on a 2-device mesh, for the 3-net, fused
  and precomputed-map forms, on tiny conditioned nets
  (``test_torch_port_infer.py``'s weights and frame) at 64x64, and a
  three-frame batch padded to four as the eval sweeps pad their last
  chunk.

The rank worker is a module-level function that imports neither JAX nor
the JAX package: the spawned processes import this module.
"""

import types

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import parallel
from rcvpose_tpu_torch.ops import voting
from tests.torch_port_threads import port_threads  # noqa: F401

CPU2 = [torch.device("cpu")] * 2
RANK_TIMEOUT = 120.0
# centers as test_torch_port_infer.py holds them (mm); the Horn fit of
# centers that close, over ~0.1 m keypoint lever arms, moves rotations by
# well under 1e-3
CENTER_ATOL_MM = 1e-2
ROT_ATOL = 1e-3
# ADD scores as test_torch_port_eval.py holds them (mm)
SCORE_ATOL_MM = 1e-2


def vote_problem(seed=0, v=300, n=1024):
    """Voxels, points padded to a multiple of 4 with masked entries (lo =
    hi = 0) and squared-distance bands."""
    rng = np.random.default_rng(seed)
    voxels = rng.uniform(-8, 8, size=(v, 3)).astype(np.float32)
    points = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    r = rng.uniform(1, 9, size=n).astype(np.float32)
    lo, hi = (r - 0.43) ** 2, r ** 2
    lo[n - 7:] = hi[n - 7:] = 0.0
    return voxels, points, lo.astype(np.float32), hi.astype(np.float32)


def ranks_worker(rank, world, problem):
    t = [torch.from_numpy(a) for a in problem]
    one = parallel.data_mesh(devices=[torch.device("cpu")])
    two = parallel.data_mesh(devices=CPU2)
    ragged = np.arange(rank * 3 + 1, dtype=np.float32) + 10 * rank
    return {
        "counts1": parallel.sharded_vote_counts(one, *t),
        "counts2": parallel.sharded_vote_counts(two, *t),
        "gather": parallel.host_allgather(np.array([rank, 7 * rank + 1],
                                                   np.int32)),
        "concat": parallel.host_allgather_concat(ragged),
        "concat_empty": parallel.host_allgather_concat(
            np.zeros(0 if rank == 0 else 2, np.float32)),
        "world": (one.world, one.rank, one.size, two.size),
    }


@pytest.fixture(scope="module")
def rank_runs():
    problem = vote_problem()
    return problem, parallel.run_ranks(ranks_worker, 2, (problem,),
                                       timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("slots", [1, 2])
def test_sharded_vote_counts_two_ranks_match_jax_exactly(rank_runs, slots):
    """Two ranks of ``slots`` CPU slots against the JAX function on a
    2 * ``slots``-device mesh and against the unsharded count: integer
    counts, bit for bit, on both ranks."""
    import jax.numpy as jnp

    from rcvpose_tpu import parallel as jax_parallel

    problem, ranks = rank_runs
    want = np.asarray(jax_parallel.sharded_vote_counts(
        jax_parallel.data_mesh(2 * slots), *(jnp.asarray(a)
                                             for a in problem)))
    t = [torch.from_numpy(a) for a in problem]
    whole = voting.vote_counts(t[0], t[1][None], t[2][None], t[3][None])[0]
    np.testing.assert_array_equal(whole.numpy(), want)
    assert want.sum() > 1000
    for r in ranks:
        np.testing.assert_array_equal(r[f"counts{slots}"].numpy(), want)
        assert r["world"][:2] in ((2, 0), (2, 1))


def test_sharded_vote_counts_needs_padding():
    voxels, points, lo, hi = (torch.from_numpy(a) for a in vote_problem())
    with pytest.raises(ValueError, match="multiple"):
        parallel.sharded_vote_counts(parallel.data_mesh(devices=CPU2 * 3),
                                     voxels, points[:1022], lo[:1022],
                                     hi[:1022])


def test_host_allgather_two_ranks(rank_runs):
    _, ranks = rank_runs
    for r in ranks:
        np.testing.assert_array_equal(r["gather"], [[0, 1], [1, 8]])
        assert r["gather"].dtype == np.int32
        np.testing.assert_array_equal(
            r["concat"], np.concatenate([np.arange(1), 10 + np.arange(4)]))
        np.testing.assert_array_equal(r["concat_empty"], [0.0, 0.0])


def test_one_process_mesh_and_allgather():
    """Without a process group: no collective, ``x[None]``, and a mesh
    of the given slots; ``n_devices`` takes a prefix."""
    x = np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(parallel.host_allgather(x), x[None])
    np.testing.assert_array_equal(parallel.host_allgather_concat(x), x)
    mesh = parallel.data_mesh(1, devices=CPU2)
    assert (mesh.size, mesh.world, mesh.rank, mesh.group) == (1, 1, 0, None)
    assert parallel.local_data_mesh("cpu").devices == (torch.device("cpu"),)
    parallel.warm_collectives(mesh)   # a no-op without a group
    batch = parallel.shard_batch(mesh, {"x": x})
    assert batch["x"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Frame programs over a 2-slot mesh against the JAX ones on 2 devices
# ---------------------------------------------------------------------------

def _depths(depth):
    """Four frames' depths: the conditioned window and sub-windows of it
    (the conditioning's margins hold on any subset of its pixels)."""
    out = [depth.copy() for _ in range(4)]
    out[1][:30] = 0.0
    out[2][:, 36:] = 0.0
    out[3][20:26] = 0.0
    return np.stack(out)


@pytest.fixture(scope="module", params=[1, 3], ids=["3net", "fused"])
def nets(request):
    """JAX variables and the port's networks with the same conditioned
    weights, the frame and the configs (``test_torch_port_infer.py``)."""
    import jax
    import jax.numpy as jnp

    from rcvpose_tpu import labels as jax_labels
    from rcvpose_tpu import train as jax_train
    from rcvpose_tpu.config import Config as JaxConfig
    from rcvpose_tpu_torch import labels, train
    from rcvpose_tpu_torch.checkpoint import from_flax_variables
    from rcvpose_tpu_torch.config import Config
    from tests import test_torch_port_infer as ti

    heads = request.param
    jcfg = JaxConfig(**ti._cfg(heads))
    model = jax_train.build_model(jcfg)
    img, depth, keypoints = ti._frame(heads)
    init = jax.jit(model.init, static_argnums=2)
    jitted = types.SimpleNamespace(apply=jax.jit(model.apply,
                                                 static_argnums=2))
    variables = [ti._condition(jitted, init(
        jax.random.PRNGKey(i), jnp.zeros((1, ti.HW, ti.HW, 3)), False),
        img, depth) for i in range(1 if heads > 1 else 3)]
    pcfg = Config(**ti._cfg(heads))
    ports = []
    for v in variables:
        m = train.build_model(pcfg)
        m.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, v)))
        ports.append(m.eval())
    jvars = variables[0] if heads > 1 else tuple(variables)
    pnet = ports[0] if heads > 1 else tuple(ports)
    depths = _depths(depth)
    imgs = np.stack([img] * 4)
    return {
        "heads": heads, "model": model, "jvars": jvars, "pnet": pnet,
        "depths": depths, "keypoints": keypoints, "ti": ti,
        "jimgs": jax.vmap(jax_labels.normalize_image)(jnp.asarray(imgs)),
        "pimgs": labels.normalize_image(torch.from_numpy(imgs)),
    }


def _assert_pose(got, want, n=4):
    for key in ("counts", "overflow"):
        np.testing.assert_array_equal(got[key][:n].numpy(),
                                      np.asarray(want[key])[:n], err_msg=key)
    np.testing.assert_allclose(got["centers"][:n].numpy(),
                               np.asarray(want["centers"])[:n],
                               atol=CENTER_ATOL_MM)
    rt, wrt = got["rt"][:n].numpy(), np.asarray(want["rt"])[:n]
    np.testing.assert_allclose(rt[:, :3, :3], wrt[:, :3, :3], atol=ROT_ATOL)
    np.testing.assert_allclose(rt[:, :3, 3], wrt[:, :3, 3],
                               atol=CENTER_ATOL_MM)


def test_sharded_frame_pose_matches_jax(nets):
    import jax.numpy as jnp

    from rcvpose_tpu import parallel as jax_parallel

    ti = nets["ti"]
    kw = dict(sem_threshold=ti.SEM_THRESHOLD, n_points=1024, grid_l=64,
              mode="hier")
    k = np.array([[300.0, 0, 32.0], [0, 300.0, 32.0], [0, 0, 1]], np.float32)
    mr = np.asarray(ti.MAX_RADII, np.float32)
    gk = (nets["keypoints"][1:4] * 1000.0).astype(np.float32)
    want = jax_parallel.sharded_frame_pose(
        jax_parallel.data_mesh(2), nets["model"].apply, nets["jvars"],
        nets["jimgs"], jnp.asarray(nets["depths"]), jnp.asarray(k),
        jnp.asarray(mr), jnp.asarray(gk), **kw)
    mesh = parallel.data_mesh(devices=CPU2)
    args = (torch.from_numpy(k), torch.from_numpy(mr), torch.from_numpy(gk))
    got = parallel.sharded_frame_pose(mesh, nets["pnet"], nets["pimgs"],
                                      torch.from_numpy(nets["depths"]),
                                      *args, **kw)
    assert got["counts"].min() > 0
    _assert_pose(got, want)
    # three frames padded to four by the last (the eval sweeps' padding)
    pad = [0, 1, 2, 2]
    got3 = parallel.sharded_frame_pose(
        mesh, nets["pnet"], nets["pimgs"][pad],
        torch.from_numpy(nets["depths"][pad]), *args, **kw)
    _assert_pose(got3, want, n=3)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        parallel.sharded_frame_pose(mesh, nets["pnet"], nets["pimgs"][:3],
                                    torch.from_numpy(nets["depths"][:3]),
                                    *args, **kw)


@pytest.mark.parametrize("maps", [False, True], ids=["net", "maps"])
def test_sharded_frame_scores_matches_jax(nets, maps):
    """The eval frame program (votes -> Horn -> ADD -> ICP -> ADD) through
    the networks, and through their maps passed as precomputed ones:
    per-frame scores within 1e-2 mm, overflow flags equal."""
    import jax.numpy as jnp

    from rcvpose_tpu import parallel as jax_parallel

    ti = nets["ti"]
    rng = np.random.default_rng(3)
    cad = (rng.normal(size=(64, 3)) * 40.0).astype(np.float32)
    rt_gts = np.tile(np.eye(4, dtype=np.float32)[:3][None], (4, 1, 1))
    rt_gts[:, :, 3] = [[0.0, 0.0, 700.0], [5.0, 0.0, 690.0],
                       [0.0, -4.0, 710.0], [3.0, 3.0, 700.0]]
    ks = np.tile(np.array([[300.0, 0, 32.0], [0, 300.0, 32.0], [0, 0, 1]],
                          np.float32)[None], (4, 1, 1))
    mr = np.asarray(ti.MAX_RADII, np.float32)
    gk = (nets["keypoints"][1:4] * 1000.0).astype(np.float32)
    kw = dict(sem_threshold=ti.SEM_THRESHOLD, n_points=1024, grid_l=64,
              mode="hier", icp_iters=5)
    mesh = parallel.data_mesh(devices=CPU2)
    tail = (torch.from_numpy(nets["depths"]), torch.from_numpy(rt_gts),
            torch.from_numpy(ks), torch.from_numpy(mr), torch.from_numpy(gk),
            torch.from_numpy(cad), False)
    jtail = (jnp.asarray(nets["depths"]), jnp.asarray(rt_gts),
             jnp.asarray(ks), jnp.asarray(mr), jnp.asarray(gk),
             jnp.asarray(cad), False)
    jmesh = jax_parallel.data_mesh(2)
    if maps:
        with torch.inference_mode():
            outs = ([m(nets["pimgs"]) for m in nets["pnet"]]
                    if nets["heads"] == 1 else [nets["pnet"](nets["pimgs"])])
        if nets["heads"] == 1:
            sems = torch.stack([o[0][..., 0] for o in outs], 1)
            rads = torch.stack([o[1][..., 0] for o in outs], 1)
        else:
            sems, rads = (outs[0][i].permute(0, 3, 1, 2) for i in (0, 1))
        got = parallel.sharded_frame_scores(mesh, None, (sems, rads), *tail,
                                            **kw)
        want = jax_parallel.sharded_frame_scores(
            jmesh, None, (jnp.asarray(sems.numpy()),
                          jnp.asarray(rads.numpy())), None, *jtail, **kw)
    else:
        got = parallel.sharded_frame_scores(mesh, nets["pnet"],
                                            nets["pimgs"], *tail, **kw)
        want = jax_parallel.sharded_frame_scores(
            jmesh, nets["model"].apply, nets["jvars"], nets["jimgs"],
            *jtail, **kw)
    np.testing.assert_array_equal(got["overflow"].numpy(),
                                  np.asarray(want["overflow"]))
    for key in ("score_bf", "score_af"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=SCORE_ATOL_MM, err_msg=key)
    assert float(got["score_bf"].min()) > 0
    assert not torch.equal(got["rt"], got["rt2"])   # the ICP moved poses
