"""The design of the FPS kernel A (``epnet_tpu_torch/csrc/fps.cu``),
emulated on the CPU, since the kernel runs only on the card.

The emulation follows the kernel: a cloud cut into ``cs`` contiguous
slices, one per block of a thread-block cluster; thread t of block r holds
the points r * slice + t + k * threads, k < PPT, with their running
distances (f32, each operation rounded on its own); each thread's best
point is its first largest distance (strict >, k rising); the keys are
packed as (float bits of the distance << 32) | (0xFFFFFFFF - index), the
empty key 0; the max is taken over each warp's 32 lanes, then the block's
warps, then the cluster's blocks.

It gives the plain version's picks, index for index, for ``cs`` in {1, 2,
4, 16}: on clouds whose size ``cs`` does not divide, on exact ties across
the slice boundaries (duplicated points; a lattice of equal distances) and
on a batch; and the JAX Pallas kernel's on one small cloud (TPU interpret
mode, as ``tests/test_torch_fps_pallas.py`` runs it). A property test holds
the packed key's order to (largest value, lowest index).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental.pallas import tpu as pltpu

from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.fps_pallas import furthest_point_sample_pallas
from epnet_tpu_torch.ops.fps import furthest_point_sample_plain
from epnet_tpu_torch.utils.testing import structured_scene

EMPTY = np.uint64(0)


def pack_keys(value, index):
    """The kernel's keys: value (f32, >= 0, or -1 for no point) in the high
    word as its bits, 0xFFFFFFFF - index in the low; no point packs to 0."""
    value = np.asarray(value, np.float32)
    index = np.asarray(index, np.int64)
    hi = value.view(np.uint32).astype(np.uint64)
    lo = (np.uint64(0xFFFFFFFF) - index.astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    return np.where(value >= 0, (hi << np.uint64(32)) | lo, EMPTY)


def design_fps(xyz, npoint, cs, threads):
    """Kernel A's picks for (B, N, 3) f32 clouds with ``cs`` blocks of
    ``threads`` threads a cloud: (B, npoint) int64."""
    B, N, _ = xyz.shape
    sl = -(-N // cs)
    ppt = -(-sl // threads)
    r, t, k = np.meshgrid(np.arange(cs), np.arange(threads), np.arange(ppt), indexing='ij')
    first = r * sl + t                                     # a thread's first point
    idx = first + k * threads                              # (cs, threads, ppt)
    valid = idx < np.minimum(N, (r + 1) * sl)
    safe = np.where(valid, idx, 0)
    pts = xyz[:, safe]                                     # (B, cs, threads, ppt, 3)
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    mind = np.where(valid, np.float32(1e10), np.float32(-1))[None].repeat(B, 0)
    last = xyz[:, 0]                                       # (B, 3)
    picks = np.zeros((B, npoint), np.int64)
    for j in range(1, npoint):
        lx, ly, lz = (last[:, c, None, None, None] for c in range(3))
        dx, dy, dz = px - lx, py - ly, pz - lz
        d = (dx * dx + dy * dy) + dz * dz                  # f32, the kernel's order
        mind = np.minimum(mind, d)
        bk = np.argmax(mind, axis=-1)                      # each thread's first largest
        bv = np.take_along_axis(mind, bk[..., None], -1)[..., 0]
        key = pack_keys(bv, first[..., 0][None] + bk * threads)  # (B, cs, threads)
        lanes = key.reshape(B, cs, threads // 32, 32)
        best = lanes.max(-1).max(-1).max(-1)               # warp, block, cluster
        win = (np.uint64(0xFFFFFFFF) - (best & np.uint64(0xFFFFFFFF))).astype(np.int64)
        picks[:, j] = win
        last = xyz[np.arange(B), win]
    return picks


def _plain(xyz, npoint):
    return furthest_point_sample_plain(torch.from_numpy(xyz), npoint).numpy()


def _boundary_ties(n, cs, seed):
    """A random cloud whose first points of every slice are copied to the
    end of the previous one: equal points on both sides of each boundary."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(1, n, 3).astype(np.float32)
    sl = -(-n // cs)
    for r in range(1, cs):
        b = r * sl
        w = min(4, sl // 2, n - b)
        if w > 0:
            xyz[0, b - w:b] = xyz[0, b:b + w]
    return xyz


def _lattice(n):
    """n points of an integer lattice: many exactly equal distances."""
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing='ij'), -1).reshape(-1, 3)
    return g[None, :n].astype(np.float32)


CLOUDS = {
    'structured_1000': lambda: structured_scene(np.random.RandomState(0), 1000)[0][None],
    'boundary_ties_1000': lambda: _boundary_ties(1000, 16, 1),
    'lattice_1000': lambda: _lattice(1000),
    'batch3_random_515': lambda: np.random.RandomState(2).randn(3, 515, 3).astype(np.float32),
}


@pytest.mark.parametrize('cs', [1, 2, 4, 16])
@pytest.mark.parametrize('cloud', sorted(CLOUDS))
def test_design_picks_equal_plain(cloud, cs):
    """N = 1000 and 515: no cs above 1 divides them; two warps a block, one
    to sixteen points a thread."""
    xyz = CLOUDS[cloud]()
    npoint = 200
    np.testing.assert_array_equal(design_fps(xyz, npoint, cs, 64), _plain(xyz, npoint))


def test_ties_do_cross_slice_boundaries():
    """The tie cases are not vacuous: on the lattice, some steps pick a
    point that ties one of another slice (of 16) at the largest distance."""
    xyz = _lattice(1000)
    picks = _plain(xyz, 96)
    sl = -(-1000 // 16)
    x = torch.from_numpy(xyz[0])
    mind = torch.full((1000,), 1e10)
    crossings = 0
    for j in range(1, 96):
        mind = torch.minimum(mind, ((x - x[picks[0, j - 1]]) ** 2).sum(1))
        at_max = (mind == mind.max()).nonzero()[:, 0]
        crossings += int((at_max // sl != picks[0, j] // sl).any())
    assert crossings > 10


def test_design_matches_pallas_kernel(monkeypatch):
    """The Pallas TPU kernel (interpret mode), the design and the plain
    version pick the same points on a small cloud."""
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', 'residual')  # module state
    xyz = structured_scene(np.random.RandomState(3), 512)[0][None]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), 64, 0, False))
    np.testing.assert_array_equal(design_fps(xyz, 64, 4, 32), want)
    np.testing.assert_array_equal(_plain(xyz, 64), want)


values = st.one_of(st.sampled_from([0.0, 1.0, 2.5]),  # ties
                   st.floats(min_value=0.0, allow_nan=False, allow_infinity=False, width=32))
indices = st.integers(min_value=0, max_value=2 ** 31 - 1)


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.tuples(values, indices), min_size=1, max_size=40, unique_by=lambda p: p[1]))
def test_packed_key_orders_as_value_then_lowest_index(pairs):
    """For non-negative f32 values and distinct int indices, the largest
    packed key is the largest value's, and the lowest index among its
    ties."""
    v = np.array([p[0] for p in pairs], np.float32)
    i = np.array([p[1] for p in pairs], np.int64)
    best = pack_keys(v, i).max()
    top = v.max()
    assert best >> np.uint64(32) == np.float32(top).view(np.uint32)
    want = i[v == top].min()
    assert np.uint64(0xFFFFFFFF) - (best & np.uint64(0xFFFFFFFF)) == np.uint64(want)
    assert (pack_keys(v, i) > EMPTY).all()
