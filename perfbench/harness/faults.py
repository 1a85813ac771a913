"""Faults planted under a run's timed path, to show that ``correct``
catches them: an answer altered where it is produced, the one fault a
serving cell on one chip can have. Each is a context manager that
patches the program's module for its duration."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def shifted_pose(mm=10.0):
    """Every pose fit moves its translation by ``mm``."""
    from rcvpose_tpu_torch import fit

    horn = fit.horn_fit

    def shifted(p1, p2, weights=None):
        rt = horn(p1, p2, weights)
        rt[:3, 3] += mm
        return rt

    return _patched(fit, "horn_fit", shifted)


FAULTS = {"shifted_pose": shifted_pose}
