"""Seeds of the benchmark's streams, derived from the run's ``--seed``.

Each purpose (the weights of net i, the frames, the keypoints, the batch
order, ...) takes its own stream, so adding a draw to one stream moves no
other. Seeds may be any non-negative whole number, beyond 64 bits too.
"""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed, purpose, index=0):
    """A 63-bit seed for ``purpose`` (a short name) and ``index``."""
    tag = zlib.crc32(purpose.encode())
    words = [int(seed) >> (32 * i) & 0xFFFFFFFF
             for i in range(max(1, (int(seed).bit_length() + 31) // 32))]
    state = np.random.SeedSequence(words + [tag, int(index)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed, purpose, index=0):
    """A numpy ``Generator`` on the stream of ``purpose``."""
    return np.random.default_rng(derive(seed, purpose, index))
