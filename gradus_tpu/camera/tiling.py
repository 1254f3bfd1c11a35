"""Spatially-coherent ray ordering for block-resident integration.

The Pallas integrator (`integrate/pallas_solver.py`) advances one block of
``block_rays`` rays per program and exits the block when all its rays are
done, so executed work is Σ_blocks max(steps in block). Raster order is the
worst case: each block is a thin strip that crosses the image (shadow edge,
disc and far field in one block → every block pays the global max).
Re-ordering rays so each block is a compact pixel patch makes per-block step
counts coherent.

Reference analogue: dynamic per-thread scheduling in
`src/tracing/tracing.jl:151-196` (EnsembleEndpointThreads) — threads grabbing
rays one at a time never wait on a slow block; here coherence substitutes for
dynamic scheduling.
"""

from __future__ import annotations

import numpy as np

__all__ = ["block_permutation", "tile_permutation"]


def block_permutation(ny: int, nx: int, block: int = 32):
    """Permutation mapping block-major order to raster order.

    For an ``(ny, nx)`` raster-ravelled pixel grid, returns int32 arrays
    ``(perm, inv)`` such that ``rays[perm]`` groups each ``block × block``
    pixel tile contiguously (block-row-major over tiles), and
    ``out[inv]`` restores raster order. Grid dims that don't divide evenly
    fall back to padding-free greedy blocking via `tile_permutation`.
    """
    if ny % block == 0 and nx % block == 0:
        perm = (
            np.arange(ny * nx, dtype=np.int64)
            .reshape(ny // block, block, nx // block, block)
            .transpose(0, 2, 1, 3)
            .ravel()
        )
    else:
        perm = tile_permutation(ny, nx, block)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm.astype(np.int32), inv.astype(np.int32)


def tile_permutation(ny: int, nx: int, block: int = 32):
    """Blocking permutation for grids not divisible by ``block``: patches
    are clipped at the right/bottom edges (ragged patches stay contiguous)."""
    idx = np.arange(ny * nx, dtype=np.int64).reshape(ny, nx)
    out = []
    for by in range(0, ny, block):
        for bx in range(0, nx, block):
            out.append(idx[by : by + block, bx : bx + block].ravel())
    return np.concatenate(out)
