"""Sweep K1's tile (threads per block x voxels per thread x points per
staged chunk) on the CUDA card, at the coarse stage's shapes:

    python -m rcvpose_tpu_torch.scripts.prof_vote_tiles

The counterpart of the JAX package's ``scripts/prof_vote_tiles.py``, at its
shapes (32768 coarse voxels of grid 128, 2048 points, slack 4.2, seed 0).
That sweep walked the TPU kernel's VOX_BLOCK x PT_CHUNK, which sized a
VMEM scratch of up to 4096 x 2048 f32; those tiles mean nothing on a GPU,
where a block holds at most 1024 threads and 48 KB of static shared
memory. Here the sweep walks Hopper's block instead: 128, 256 or 512
threads, each owning 1, 2 or 4 voxels, over chunks of 256 to 2048 points
staged in shared memory (``vote_cuda.TILES``).

Prints one line per tile with its device ms (CUDA events, median of
repeats) and ``ok`` or ``MISMATCH`` against the plain PyTorch version's
counts, then the fastest tile. Raises on a mismatch: every tile must give
the same counts, bit for bit.
"""

from __future__ import annotations

import torch

from rcvpose_tpu_torch.ops import vote_cuda
from rcvpose_tpu_torch.scripts import coarse_problem, device_ms
from rcvpose_tpu_torch.utils import resolve_device

N_POINTS = 8192 // 4   # the coarse stage's points after a stride of 4
N_VOXELS = 32768       # the coarse cells of grid 128
SLACK = 4.2


def main(reps=20, repeats=5, printer=print):
    """Run the sweep; returns ``{"tiles": {tile: (ms, ok)}, "best": tile,
    "lines": [...]}``."""
    dev = resolve_device(None)
    args = coarse_problem(N_POINTS, N_VOXELS, SLACK, seed=0, device=dev)
    ref = vote_cuda.vote_counts_plain(*args)
    tiles, lines = {}, []
    for tile in vote_cuda.TILES:
        ms = device_ms(lambda t=tile: vote_cuda.vote_counts_cuda(*args,
                                                                 tile=t),
                       reps=reps, repeats=repeats)
        ok = torch.equal(vote_cuda.vote_counts_cuda(*args, tile=tile), ref)
        tiles[tile] = (ms, ok)
        threads, vpt, chunk = tile
        lines.append(f"threads={threads:3d} vox/thread={vpt} "
                     f"chunk={chunk:4d}: {ms:8.4f} ms  "
                     f"({'ok' if ok else 'MISMATCH'})")
        printer(lines[-1])
    best = min(tiles, key=lambda t: tiles[t][0])
    lines.append(f"best tile {best}: {tiles[best][0]:.4f} ms; default "
                 f"{vote_cuda.DEFAULT_TILE}: "
                 f"{tiles[vote_cuda.DEFAULT_TILE][0]:.4f} ms; "
                 f"{N_VOXELS} voxels x {N_POINTS} points on "
                 f"{torch.cuda.get_device_name(dev)}")
    printer(lines[-1])
    bad = [t for t, (_, ok) in tiles.items() if not ok]
    if bad:
        raise AssertionError(f"tiles {bad} give other counts than the "
                             f"plain version")
    return {"tiles": tiles, "best": best, "lines": lines}


if __name__ == "__main__":
    main()
