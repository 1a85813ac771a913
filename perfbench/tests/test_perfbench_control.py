"""The control and the faults come out not correct.

The control is the reference, one precision step below the
configuration's, put in the program's place (fp8 convolutions, a
bfloat16 vote and fit, TF32 in the ICP). The fault breaks the timed path
underneath a run that otherwise proceeds as ``run.py`` drives it: an
answer altered where it is produced. The first test shows the unbroken
runs are correct at this size."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness import faults
from perfbench.tests import small


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["serve-fused-lm"])
def test_sound_runs_are_correct(name):
    assert small.run(name)[0]["correct"] is True


@pytest.mark.parametrize("name", ["serve-3net-lm", "refine-3net-lm"])
def test_control_is_not_correct(name):
    out, _, _ = small.run(name, control=True)
    assert out["correct"] is False


@pytest.mark.parametrize("name,fault,check", [
    ("serve-3net-lm", "shifted_pose", "pose_diff_mm")])
def test_fault_is_not_correct(name, fault, check):
    with faults.FAULTS[fault]():
        out, _, _ = small.run(name)
    assert out["correct"] is False
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]
