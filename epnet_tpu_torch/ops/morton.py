"""2-D Morton (Z-order) codes over the ground plane, for the loader's point
sort of the block-local configuration.

Copy of ``morton_code_np`` and ``morton_argsort_np`` of
``epnet_tpu/ops/morton.py`` (numpy; the port keeps its own copy). With the
cloud in Morton order and the FPS picks sorted ascending, a centroid's
in-radius neighbours lie in a short contiguous window of the array, which
``ops/block_local.py`` relies on. The codes interleave the quantized KITTI
rect x (lateral) and z (depth); the ~4 m vertical span is left out.
"""

from __future__ import annotations

import numpy as np

BITS = 16  # per-axis quantization bits; 2 axes * 16 = 32-bit codes


def _part1by1(x):
    """Spread the low 16 bits of x (uint32) to the even bit positions."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _quantize(v, lo, hi):
    span = np.maximum(hi - lo, 1e-6)
    q = (v - lo) / span * float(2 ** BITS - 1)
    return np.clip(q, 0, 2 ** BITS - 1)


def morton_code_np(xyz: np.ndarray) -> np.ndarray:
    """(..., N, 3) -> (..., N) uint32 codes over (x, z), quantized over
    each cloud's own min/max."""
    x, z = xyz[..., 0], xyz[..., 2]
    qx = _quantize(x, x.min(axis=-1, keepdims=True),
                   x.max(axis=-1, keepdims=True)).astype(np.uint32)
    qz = _quantize(z, z.min(axis=-1, keepdims=True),
                   z.max(axis=-1, keepdims=True)).astype(np.uint32)
    return _part1by1(qx) | (_part1by1(qz) << np.uint32(1))


def morton_argsort_np(xyz: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N,) int64 permutation into Morton order (stable: equal
    codes keep their input order)."""
    return np.argsort(morton_code_np(xyz), kind='stable').astype(np.int64)
