"""Small runs of each driver on the card, where K1 and K2 launch. Run
on the card with ``python -m pytest -o addopts="" -m cuda
perfbench/tests``; they skip without one."""

from __future__ import annotations

import pytest
import torch

from perfbench.tests import small


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name,trace", [
    ("serve-3net-lm", True), ("refine-3net-lm", False),
    ("serve-fused-lm", True)])
def test_small_runs_on_the_card(card, name, trace):
    out, _, run = small.run(name, trace=trace, device=card)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["metrics"]
