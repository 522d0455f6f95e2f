"""Block-local grouping and interpolation over Morton-sorted clouds: the
block-local configuration's neighbour queries.

Port of ``epnet_tpu/ops/block_local.py`` (``block_local_available``,
``block_local_fp_available``, ``bucket_ball_query``, ``window_starts``,
``to_window_relative``, ``block_local_window_query``,
``block_local_group_multi``, ``block_local_group_nested``,
``block_local_three_interp``). The JAX package computes all of it in XLA;
so does the port, in plain PyTorch. With the cloud in Morton order
(``ops/morton.py``, sorted by the loader) and the FPS picks sorted
ascending, the neighbours of a block of consecutive centroids lie in one
short window of consecutive points; each query looks only inside its
block's window, and in-radius points outside it are dropped. That is a
different function from the exact queries of ``ops/pointops.py``: the
configuration's own selection policy, which the port reproduces index for
index.

Where the JAX package selects rows with one-hot matmuls (exact f32
selections at HIGHEST precision), the port gathers by index, and where it
multiplies a (ublock, window) weight matrix holding three weights a row,
the port sums the three weighted rows. The distance fields are computed
in the order XLA rounds them: a broadcast subtract summed over (x, y, z)
for the bucket selects, and |a|^2 + |b|^2 - 2ab with XLA's FMA chain for
the cross term (``pointops._pairwise_d2``) for the interpolation.
Selections take the first index on ties, and searches are left-sided, as
``argmin`` and ``searchsorted`` are in JAX.

In f32 the port's interpolation holds the f32 function, which is what the
JAX package computes on the CPU. On a TPU JAX's weight matmul
(``block_local.py:126-127``) runs at default precision, which truncates
its f32 operands to bf16, so the same f32 configuration there computes a
bf16-rounded interpolation; the port does not reproduce that.

``block_local_group_nested`` is the nearest-first nested grouping inside
the same windows (``block_local.py:419-525``): its bf16 keys select through
``pointops.nested_nearest_select``, the stable top-k, for ``approx`` True
(JAX's ``approx_max_k``, which off the TPU computes that selection on
distinct keys) and False (JAX's ``lax.top_k``) alike.
``block_local_window_query`` is the single-scale window query of the
windowed fused kernel (``block_local.py:207-283``), returning
window-relative indices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .pointops import (_pairwise_d2, _scaled, _sq_norm, gather_points, group_points, in_radius,
                       nested_nearest_select, nested_thresholds, sq_dist)


def block_local_fp_available(n: int, m: int, ublock: int, window: int) -> bool:
    """Gate of the windowed FP interpolation: the unknown level tiles into
    ublocks and the known level holds at least one window."""
    return n % ublock == 0 and m >= window and window % 128 == 0


def block_local_available(n: int, m: int, window: int, block_c: int) -> bool:
    """Gate of the block-local SA grouping: clean tiling and a window
    smaller than the cloud, above 1024 points."""
    return n > window and n > 1024 and m % block_c == 0 and window % 128 == 0


def _windows(table: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """table (B, N, C), starts (B, K) -> (B, K, window, C): the K slices
    ``table[b, starts[b, k]:starts[b, k] + window]``."""
    B, K = starts.shape
    C = table.shape[-1]
    rows = (starts[..., None] + torch.arange(window, device=starts.device)).reshape(B, K * window)
    return torch.gather(table, 1, rows[..., None].expand(B, K * window, C)).reshape(
        B, K, window, C)


def _bucket_select(keys: torch.Tensor, nsample: int):
    """Strided-bucket pick over the last axis (length L, a multiple of
    nsample): slot j keeps the nearest finite key among lanes l with
    l % nsample == j. Returns (lane (..., nsample), valid (..., nsample))."""
    L = keys.shape[-1]
    kr = keys.reshape(*keys.shape[:-1], L // nsample, nsample)
    vmin, cstar = kr.min(dim=-2).values, kr.argmin(dim=-2)
    lane = cstar * nsample + torch.arange(nsample, device=keys.device)
    return lane, torch.isfinite(vmin)


def bucket_ball_query(radius: float, nsample: int, xyz: torch.Tensor,
                      new_xyz: torch.Tensor) -> torch.Tensor:
    """Strided-bucket ball query over a spatially ordered table, global
    indices (``block_local.py:133-171``): slot j of a centroid takes the
    nearest in-radius point among the points p with p % nsample == j; empty
    slots take the nearest point of the table, and a centroid with no point
    in its ball takes index 0.

    :param xyz: (T, N, 3) with N % nsample == 0; new_xyz: (T, M, 3)
    :return: (T, M, nsample) int64
    """
    T, N, _ = xyz.shape
    if N % nsample:
        raise ValueError(f'bucket_ball_query: {N} points do not tile into {nsample} buckets')
    d2 = sq_dist(new_xyz.detach()[:, :, None, :], xyz.detach()[:, None, :, :])  # (T, M, N)
    keys = torch.where(in_radius(d2, radius), d2, float('inf'))
    idx, valid = _bucket_select(keys, nsample)
    pad = d2.argmin(dim=-1, keepdim=True)  # the nearest point
    idx = torch.where(valid, idx, pad)
    return torch.where(valid.any(dim=-1, keepdim=True), idx, 0)


def window_starts(parent_idx: torch.Tensor, n: int, window: int, block_c: int,
                  align: int = 8) -> torch.Tensor:
    """Start of each block's window (``block_local.py:174-183``): centred on
    the midpoint of the block's first and last centroid position, clipped
    into [0, n - window] and rounded down to a multiple of ``align``.

    :param parent_idx: (B, M) ascending positions of the centroids
    :return: (B, M // block_c) int64
    """
    B, M = parent_idx.shape
    pb = parent_idx.detach().reshape(B, M // block_c, block_c)
    mid = (pb[:, :, 0] + pb[:, :, -1]) // 2
    starts = (mid - window // 2).clamp(0, n - window)
    return starts // align * align


def to_window_relative(idx: torch.Tensor, starts: torch.Tensor, window: int) -> torch.Tensor:
    """Global indices (T, M, S) to window-relative ones for the windowed
    fused kernel (``block_local.py:186-204``): an index outside its tile's
    window takes the smallest in-window relative index of its centroid, or
    0 when it has none.

    :param starts: (T, NB), NB dividing M
    """
    rel = idx - starts.repeat_interleave(idx.shape[1] // starts.shape[1], dim=1)[..., None]
    valid = (rel >= 0) & (rel < window)
    pad = torch.where(valid, rel, 2 * window).amin(dim=-1, keepdim=True)
    return torch.where(valid, rel, torch.where(pad < 2 * window, pad, 0))


def block_local_window_query(radius: float, nsample: int, xyz: torch.Tensor,
                             parent_idx: torch.Tensor, new_xyz: Optional[torch.Tensor] = None,
                             window: int = 256, block_c: int = 32, align: int = 8):
    """Single-scale ball query over each block's window, window-relative
    (``block_local.py:207-283``): each block of ``block_c`` centroids looks
    in the ``window`` points from its ``window_starts`` (aligned to
    ``align``); the field is the exact f32 broadcast-subtract over
    coordinates scaled by 1 / radius, the membership ``d2n < 1``; slot j
    keeps the nearest in-radius lane l with l % nsample == j (first on
    ties), an empty slot the nearest in-radius lane, a ball with none lane
    0.

    :param xyz: (T, N, 3) spatially ordered; parent_idx: (T, M) ascending
        centroid positions; new_xyz: (T, M, 3), gathered at parent_idx
        when None
    :return: (idx_rel (T, M, nsample) int64 in [0, window), starts (T, M //
        block_c) int64, cnt (T, M) int64 in-radius slots)
    """
    T, N, _ = xyz.shape
    M = parent_idx.shape[1]
    NB = M // block_c
    if window % nsample:
        raise ValueError(f'block_local_window_query: window {window} does not tile into '
                         f'{nsample}')
    starts = window_starts(parent_idx, N, window, block_c, align)
    if new_xyz is None:
        new_xyz = gather_points(xyz.detach(), parent_idx.detach())
    inv = torch.tensor(1.0 / radius, dtype=torch.float32, device=xyz.device)
    wx = _windows(xyz.detach(), starts, window)                        # (T, NB, W, 3)
    diff = (new_xyz.detach().reshape(T, NB, block_c, 1, 3) - wx[:, :, None]) * inv
    d2n = _sq_norm(diff)                                               # (T, NB, bc, W)
    keys = torch.where(d2n < 1.0, d2n, float('inf'))
    idx, valid = _bucket_select(keys, nsample)
    cnt = valid.sum(-1)
    idx = torch.where(valid, idx, keys.argmin(dim=-1, keepdim=True))
    idx = torch.where(cnt[..., None] > 0, idx, 0)
    return idx.reshape(T, M, nsample), starts, cnt.reshape(T, M)


def block_local_group_multi(radii: Sequence[float], nsamples: Sequence[int],
                            xyz: torch.Tensor, parent_idx: torch.Tensor,
                            new_xyz: torch.Tensor, window: int = 1024,
                            block_c: int = 128) -> List[torch.Tensor]:
    """Per-scale strided-bucket grouping over block-local windows
    (``block_local.py:294-416``), as global indices into ``xyz``.

    Each block of ``block_c`` consecutive (ascending) centroids shares the
    window of ``window`` points centred on the midpoint of its first and
    last centroid position (clipped, not aligned). Scale i keeps, in slot
    j, the nearest window point within radii[i] among the window lanes l
    with l % nsamples[i] == j; an empty slot takes the window's nearest
    point, and a centroid with no in-radius point takes the window's first
    point. ``group_points(xyz, idx)`` and ``group_points(feats, idx)`` then
    give the JAX function's rows exactly.

    :param xyz: (B, N, 3) Morton-sorted; parent_idx: (B, M) ascending
        centroid positions; new_xyz: (B, M, 3) the centroids
    :return: per scale, (B, M, nsamples[i]) int64
    """
    B, N, _ = xyz.shape
    M = parent_idx.shape[1]
    NB = M // block_c
    for s in nsamples:
        if window % s:
            raise ValueError(f'block_local_group_multi: window {window} does not tile into {s}')
    pb = parent_idx.detach().reshape(B, NB, block_c)
    starts = ((pb[:, :, 0] + pb[:, :, -1]) // 2 - window // 2).clamp(0, N - window)
    wx = _windows(xyz.detach(), starts, window)                        # (B, NB, W, 3)
    cen = new_xyz.detach().reshape(B, NB, block_c, 1, 3)
    d2 = sq_dist(cen, wx[:, :, None])                                  # (B, NB, bc, W)
    pad = d2.argmin(dim=-1, keepdim=True)  # the window's nearest lane
    out = []
    for r, ns in zip(radii, nsamples):
        lane, valid = _bucket_select(torch.where(in_radius(d2, r), d2, float('inf')), ns)
        lane = torch.where(valid, lane, pad)
        lane = torch.where(valid.any(dim=-1, keepdim=True), lane, 0)
        out.append((lane + starts[:, :, None, None]).reshape(B, M, ns))
    return out


def block_local_group_nested(radii: Sequence[float], nsamples: Sequence[int],
                             xyz: torch.Tensor, feats: Optional[torch.Tensor],
                             parent_idx: torch.Tensor, new_xyz: Optional[torch.Tensor] = None,
                             window: int = 1024, block_c: int = 128, approx: bool = True):
    """Nested nearest-first grouping over block-local windows
    (``block_local.py:419-525``): each block of ``block_c`` consecutive
    (ascending) centroids takes the ``window`` points centred on the
    midpoint of its first and last centroid position (clipped, not
    aligned); the field is ``_d2_normalized`` (the |a|^2 + |b|^2 - 2ab form
    over coordinates scaled by 1 / r_max) and the selection
    ``nested_nearest_select``'s, the same for ``approx`` True and False.
    The rows are gathered by index (no gradient reaches ``xyz``, as in
    JAX).

    :param xyz: (B, N, 3) Morton-sorted; feats: (B, N, Cf) or None;
        parent_idx: (B, M) ascending centroid positions; new_xyz: (B, M, 3),
        gathered at parent_idx when None
    :return: (gx (B, M, s_max, 3), gf (B, M, s_max, Cf) or None, cnts: per
        scale (B, M) int64, for ``nested_prefix_select``)
    """
    del approx  # one stable selection for both (see the module docstring)
    if list(radii) != sorted(radii) or list(nsamples) != sorted(nsamples):
        raise ValueError(f'block_local_group_nested: radii {tuple(radii)} and nsamples '
                         f'{tuple(nsamples)} must ascend')
    B, N, _ = xyz.shape
    M = parent_idx.shape[1]
    NB = M // block_c
    r_max, s_max = float(radii[-1]), int(nsamples[-1])
    pb = parent_idx.detach().reshape(B, NB, block_c)
    starts = ((pb[:, :, 0] + pb[:, :, -1]) // 2 - window // 2).clamp(0, N - window)
    if new_xyz is None:
        new_xyz = gather_points(xyz.detach(), parent_idx.detach())
    wx = _windows(xyz.detach(), starts, window)                        # (B, NB, W, 3)
    d2n = _pairwise_d2(_scaled(new_xyz, r_max).reshape(B * NB, block_c, 3),
                       _scaled(wx, r_max).reshape(B * NB, window, 3))
    loc, cnts = nested_nearest_select(d2n.reshape(B, NB, block_c, window), s_max,
                                      nested_thresholds(radii))
    rows = (loc + starts[:, :, None, None]).reshape(B, M, s_max)
    gx = group_points(xyz.detach(), rows)
    gf = group_points(feats, rows) if feats is not None else None
    return gx, gf, [c.reshape(B, M) for c in cnts]


def block_local_three_interp(unknown: torch.Tensor, known_xyz: torch.Tensor,
                             known_feats: torch.Tensor, known_idx: torch.Tensor,
                             ublock: int = 512, window: int = 256) -> torch.Tensor:
    """Windowed 3-NN inverse-distance interpolation for Morton-sorted levels
    (``block_local.py:47-130``): each block of ``ublock`` consecutive
    unknowns takes its 3 nearest knowns (exact top 3 of the clipped |a|^2 +
    |b|^2 - 2ab field, first index on ties) from the window of ``window``
    consecutive knowns centred where ``known_idx`` reaches the block's
    midpoint (left-sided search), weighted by 1 / (distance + 1e-8)
    normalized. Differentiable in ``known_feats`` only. With bf16 features
    the weights are cast to bf16 and the three products summed in f32, the
    sum rounded to bf16 once (JAX's weight matmul with f32 accumulation,
    ``block_local.py:126-127``).

    :param unknown: (B, N, 3), N % ublock == 0; known_xyz: (B, M, 3), the
        unknowns' ascending FPS subset; known_feats: (B, M, C);
        known_idx: (B, M) ascending positions of the knowns among the
        unknowns
    :return: (B, N, C)
    """
    B, N, _ = unknown.shape
    M, C = known_xyz.shape[1], known_feats.shape[-1]
    NBU = N // ublock
    mids = torch.arange(NBU, device=known_idx.device) * ublock + ublock // 2
    centers = torch.searchsorted(known_idx.detach().contiguous(),
                                 mids.expand(B, NBU).contiguous())
    starts = (centers - window // 2).clamp(0, M - window)              # (B, NBU)
    wx = _windows(known_xyz.detach(), starts, window)                   # (B, NBU, W, 3)
    d2 = _pairwise_d2(unknown.detach().reshape(B * NBU, ublock, 3),
                      wx.reshape(B * NBU, window, 3)).clamp_min(0.0)
    d2 = d2.reshape(B, NBU, ublock, window)
    d = d2
    lanes, recips = [], []
    for _ in range(3):
        v, i = d.min(dim=-1, keepdim=True).values, d.argmin(dim=-1, keepdim=True)
        lanes.append(i)
        recips.append(1.0 / (torch.sqrt(v) + 1e-8))
        d = d.scatter(-1, i, float('inf'))
    tot = recips[0] + recips[1] + recips[2]
    fdt = known_feats.dtype
    out = 0.0
    for i, r in zip(lanes, recips):
        rows = (i[..., 0] + starts[:, :, None]).reshape(B, N, 1)
        w = (r / tot).reshape(B, N, 1).to(fdt).float()
        out = out + torch.gather(known_feats, 1, rows.expand(B, N, C)).float() * w
    return out.to(fdt)
