"""The port's RGB-only keypoint (``eval.keypoint_from_maps_no_depth`` on
``geometry.depth_hypothesis_clouds``) against the JAX package and the
reference oracle of ``tests/test_no_depth.py`` on the CPU."""

import inspect

import jax.numpy as jnp
import numpy as np
import torch

from rcvpose_tpu import eval as jax_eval
from rcvpose_tpu import geometry as jax_geometry
from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch import geometry as port_geometry
from tests.test_no_depth import reference_no_depth_clouds


def test_depth_hypothesis_clouds_match_jax_and_oracle():
    rng = np.random.default_rng(0)
    h, w = 24, 32
    k = np.array([[60.0, 0, 16], [0, 60.0, 12], [0, 0, 1]])
    depth = np.zeros((h, w))
    depth[5:15, 8:20] = rng.uniform(0.7, 0.705, size=(10, 12))
    ref = reference_no_depth_clouds(k, depth)
    n_hyp, n_ref = ref.shape[:2]
    z_min = np.float32(depth[depth > 0].min())
    for n_points in (256, 64):   # padded, and truncated
        want = jax_geometry.depth_hypothesis_clouds(
            jnp.asarray(depth > 0), jnp.asarray(k, jnp.float32), z_min,
            n_hyp, n_points=n_points)
        got = port_geometry.depth_hypothesis_clouds(
            torch.tensor(depth > 0), k, torch.tensor(z_min), n_hyp, n_points)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                       atol=1e-6)
        assert got[0].shape == (n_hyp, n_points, 3)
        n = min(n_ref, n_points)
        np.testing.assert_allclose(got[0][:, :n].numpy(), ref[:, :n],
                                   rtol=0, atol=1e-6)
        assert int(got[3]) == n_ref and int(got[1].sum()) == n
        # padded entries carry the plane's z and x = y = 0
        assert (got[0][:, n:, :2] == 0).all()


def _planar_scene(h=96, w=128):
    """``tests/test_no_depth.py``'s constant-z scene: a masked patch at
    0.72 m, its true radii to a keypoint at (0.02, -0.01, 0.75) m."""
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
    return k, z0, mask.astype(np.float32), radial, kpt


def test_keypoint_from_maps_no_depth_matches_jax():
    k, z0, sem, radial, _ = _planar_scene()
    kw = dict(n_points=2048, n_hyp=32, grid_l=96, mode="hier")
    want = jax_eval.keypoint_from_maps_no_depth(
        jnp.asarray(sem), jnp.asarray(radial), jnp.asarray(k, jnp.float32),
        jnp.float32(z0 - 0.004), jnp.float32(100.0), jnp.float32(0.5), **kw)
    got = port_eval.keypoint_from_maps_no_depth(
        torch.tensor(sem), torch.tensor(radial),
        torch.tensor(k, dtype=torch.float32), torch.tensor(z0 - 0.004),
        torch.tensor(100.0), torch.tensor(0.5), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    assert not bool(got[1]) and not bool(want[1])
    assert int(got[2]) == int(want[2]) == int(sem.sum())


def test_keypoint_from_maps_no_depth_defaults_match_jax():
    def defaults(fn):
        return {n: p.default for n, p in inspect.signature(fn).parameters
                .items() if p.default is not inspect.Parameter.empty}

    assert defaults(port_eval.keypoint_from_maps_no_depth) == defaults(
        jax_eval.keypoint_from_maps_no_depth)


def test_no_depth_keypoint_recovers_planar_scene():
    """``tests/test_no_depth.py``'s recovery check on the port: the true
    plane's votes dominate and the keypoint lands within 10 mm of the
    truth with no depth input."""
    k, z0, sem, radial, kpt = _planar_scene()
    center, overflow, count = port_eval.keypoint_from_maps_no_depth(
        torch.tensor(sem), torch.tensor(radial),
        torch.tensor(k, dtype=torch.float32), z0 - 0.004, 100.0, 0.5,
        n_points=2048, n_hyp=9, grid_l=128, mode="hier")
    assert int(count) == int(sem.sum())
    assert not bool(overflow)
    assert np.linalg.norm(center.numpy() - kpt * 1000.0) < 10.0
