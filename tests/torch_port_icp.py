"""ICP problems shared by the port's CPU and card tests (this module
imports neither JAX nor the JAX package)."""

import numpy as np


def rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def icp_problem(seed, t=(10.0, -20.0, 80.0)):
    """A CAD lattice (4 mm spacing, jitter under 1 mm, so neighbours stay
    at least 2 mm apart and no nearest-neighbour tie can flip), a scene of
    its transformed points (moved by ``t`` mm) with 0.3 mm noise and
    padding, and an init pose off by a few degrees and millimeters."""
    rng = np.random.default_rng(seed)
    g = np.arange(-5, 5) * 4.0
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    cad = lattice[np.linalg.norm(lattice, axis=1) < 20.0]
    cad = (cad + rng.uniform(-0.5, 0.5, size=cad.shape)).astype(np.float32)
    r = rot(rng.normal(size=3), 0.4)
    t = np.asarray(t)
    scene = cad @ r.T + t + rng.normal(size=cad.shape) * 0.3
    pad = np.zeros((37, 3))
    target = np.concatenate([scene, pad]).astype(np.float32)
    mask = np.arange(len(target)) < len(scene)
    init = np.eye(4)
    init[:3, :3] = rot(rng.normal(size=3), 0.05) @ r
    init[:3, 3] = t + rng.normal(size=3) * 1.5
    return cad, target, mask, init.astype(np.float32)
