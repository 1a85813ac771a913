"""Torch's intra-op threads for the port's side of the CPU tests.

The suite's command in ROADMAP.md runs six xdist workers on the
machine's cores, and torch's default of one intra-op thread a core in
each of them oversubscribes the cores many times over: a module of
evaluator runs took about ten times as long under the six workers as
alone. A test module
whose time goes mostly to the port's tensor work imports ``port_threads``,
which gives it the workers' share of the cores for the module. The JAX
package's side keeps its own threads.
"""

import os

import pytest
import torch

WORKERS = 6   # that command's -n


@pytest.fixture(scope="module", autouse=True)
def port_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
    yield
    torch.set_num_threads(n)
