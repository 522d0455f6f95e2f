"""Point-cloud primitives with the reference's exact semantics: FPS, ball
query, grouping, 3-NN interpolation.

Port of the exact paths of ``epnet_tpu/ops/pointops.py`` (reference CUDA:
``sampling_gpu.cu``, ``ball_query_gpu.cu:9-67``, ``group_points_gpu.cu``,
``interpolate_gpu.cu:9-160``). FPS runs the hand-written kernel of
``fps.py`` on the card. Indices are int64 (PyTorch's gather type); every
public function takes and returns the JAX package's channels-last layout.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fps import furthest_point_sample  # noqa: F401  (public entry point)


def _policy(exact_queries):
    if exact_queries not in (None, True, False, 'residual'):
        raise ValueError(f"EXACT_QUERIES {exact_queries!r}: True, False, 'residual' or None")
    return exact_queries


def block_local_allowed(exact_queries) -> bool:
    """Whether the query policy ``cfg.EXACT_QUERIES`` admits the block-local
    paths (``pointops.py:49-55``): yes under 'residual' (block-local
    grouping, every other query exact) and under False (the approximate
    family); no under True, and no under None, the JAX package's
    per-backend default, which is exact off the TPU."""
    return _policy(exact_queries) in ('residual', False)


def approx_allowed(exact_queries, op: str) -> bool:
    """Whether the policy admits the approximate query of ``op`` ('ball',
    'three_nn' or 'roipool'; ``pointops.py:108-113,133-152``): only under
    False. 'residual' keeps every query outside the block-local paths
    exact. The port has no approximate queries; ``EPNet`` refuses a policy
    that admits them."""
    if op not in ('ball', 'three_nn', 'roipool'):
        raise ValueError(f'unknown query op {op!r}')
    return _policy(exact_queries) is False


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    B, M = idx.shape
    C = points.shape[-1]
    return torch.gather(points, 1, idx[..., None].expand(B, M, C))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    C = points.shape[-1]
    flat = torch.gather(points, 1, idx.reshape(B, M * S, 1).expand(B, M * S, C))
    return flat.reshape(B, M, S, C)


def _chunk_size(total: int, budget: int) -> int:
    """Largest divisor of `total` that is <= budget (>=1)."""
    c = min(total, max(1, budget))
    while total % c:
        c -= 1
    return c


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor,
               max_block_elems: int = 8 * 1024 * 1024) -> torch.Tensor:
    """The first ``nsample`` points strictly inside ``radius`` of each
    centroid, in ascending index order; short balls repeat the first hit and
    empty balls return index 0 (``ball_query_gpu.cu:28-44``).

    The centroids are taken in chunks so the transient (B, c, N) field stays
    within ``max_block_elems`` elements.

    :param xyz: (B, N, 3); new_xyz: (B, M, 3)
    :return: (B, M, nsample) int64
    """
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    xyz = xyz.detach()
    new_xyz = new_xyz.detach()
    iota = torch.arange(N, device=xyz.device)
    slot = torch.arange(nsample, device=xyz.device)

    def block(centroids):  # (B, c, 3) -> (B, c, nsample)
        diff = centroids[:, :, None, :] - xyz[:, None, :, :]
        dx, dy, dz = diff.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz  # the reference's summation order
        mask = d2 < radius * radius  # strict <, like the CUDA kernel
        key = torch.where(mask, iota, N)  # N == "no hit" sentinel
        idx = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
        cnt = mask.sum(-1, keepdim=True)
        idx = torch.where(slot < cnt, idx, idx[..., 0:1])
        return torch.where(cnt > 0, idx, 0)

    chunk = _chunk_size(M, max_block_elems // max(B * N, 1))
    return torch.cat([block(new_xyz[:, c:c + chunk]) for c in range(0, M, chunk)], 1)


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def _pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) x (B, N, 3) -> (B, M, N) squared distances in the
    |a|^2 + |b|^2 - 2ab form of the JAX package.

    The cross term is the fused multiply-add chain ``fma(a2, b2, fma(a1, b1,
    a0 * b0))`` that XLA's f32 dot computes for a depth of 3. The form
    cancels: for a point that is also a known (every FPS pick) the field
    holds rounding noise instead of 0, and the inverse-distance weights
    amplify sqrt(noise), so the port reproduces the same rounding."""
    a = a[:, :, None, :]
    b = b[:, None, :, :]
    ab = a[..., 0] * b[..., 0]
    ab = torch.addcmul(ab, a[..., 1], b[..., 1])
    ab = torch.addcmul(ab, a[..., 2], b[..., 2])
    return _sq_norm(a) + _sq_norm(b) - 2.0 * ab


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             max_block_elems: int = 64 * 1024 * 1024
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 3 nearest neighbours (``interpolate_gpu.cu:9-75``): three masked
    argmins over the clipped squared-distance field, queries chunked to
    ``max_block_elems``.

    :param unknown: (B, N, 3) queries; known: (B, M, 3)
    :return: (dist, idx), both (B, N, 3); dist is euclidean
    """
    B, N, _ = unknown.shape
    M = known.shape[1]
    unknown = unknown.detach()
    known = known.detach()
    iota = torch.arange(M, device=known.device)

    def block(queries):
        d2 = _pairwise_d2(queries, known).clamp_min(0.0)
        d = d2
        ds, ids = [], []
        for _ in range(3):
            i = torch.argmin(d, dim=-1, keepdim=True)
            ds.append(torch.gather(d2, -1, i))
            ids.append(i)
            d = torch.where(iota == i, float('inf'), d)
        return torch.sqrt(torch.cat(ds, -1)), torch.cat(ids, -1)

    chunk = _chunk_size(N, max_block_elems // max(B * M, 1))
    parts = [block(unknown[:, c:c + chunk]) for c in range(0, N, chunk)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbour features: features (B, M, C), idx and
    weight (B, N, 3) -> (B, N, C)."""
    return (group_points(features, idx) * weight[..., None]).sum(2)
