"""Point-cloud primitives: FPS, ball query, grouping, 3-NN interpolation,
with the reference's exact semantics and the JAX package's approximate
query family.

Port of ``epnet_tpu/ops/pointops.py`` (reference CUDA: ``sampling_gpu.cu``,
``ball_query_gpu.cu:9-67``, ``group_points_gpu.cu``,
``interpolate_gpu.cu:9-160``). FPS runs the hand-written kernel of
``fps.py`` on the card. Indices are int64 (PyTorch's gather type); every
public function takes and returns the JAX package's channels-last layout.

The approximate queries (``EXACT_QUERIES`` false, ``pointops.py:365-368,
391-548,661-691``) change the membership test and the key dtype, not the
selection: the ball queries test ``d2 / r^2 < 1`` on the matmul-form field
of coordinates scaled by 1/r, and keep the first hits by index; ``three_nn``
takes the three smallest of the field rounded to bf16. On the TPU JAX
selects with ``approx_max_k`` / ``approx_min_k``; the port's selections are
those functions' stable form (``lax.top_k``: the lowest index first among
equal keys), which is what they compute off the TPU on distinct keys. Since
bf16 rounding of ``-index`` keys is monotone, the bf16-key first-hit
selection is the first-hit selection itself, and the port computes it with
the exact path's machinery (``first_hits``).

The nearest-first nested query (``ball_query_nested``, the ``nearest``
ball policy, ``pointops.py:551-626``) keys each outer-ball member by its
normalized distance rounded to bf16 and takes the largest keys, nearest
first; the port's selection is the stable top-k over those keys
(``nested_nearest_select``), which off the TPU is what JAX's
``approx_max_k`` computes on distinct keys.

The switches the JAX package reads from ``EPNET_EXACT_OPS``,
``EPNET_BALL_F32`` and ``EPNET_3NN_F32`` (``pointops.py:94-105,133-147,
669-681``), and the ball policy of ``EPNET_BALL_POLICY``, travel as one
``QueryOptions`` from ``EPNet`` down to the stages. ``exact_ops`` keeps
the named query families exact under the approximate policy
(``approx_allowed``). ``ball_f32`` keeps the nearest-first nested query's
keys in f32; the first-hit queries' ``-index`` keys order the hits by index
in either dtype, so under the stable selection it changes nothing there.
``three_nn_f32`` keeps the approximate 3-NN's field in f32, which under
the stable selection is the exact ``three_nn``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .fps import furthest_point_sample  # noqa: F401  (public entry point)


def _policy(exact_queries):
    if exact_queries not in (None, True, False, 'residual'):
        raise ValueError(f"EXACT_QUERIES {exact_queries!r}: True, False, 'residual' or None")
    return exact_queries


# The approximate multi-scale ball policies of ``pointops.py:58-91``; JAX
# reads the choice from ``EPNET_BALL_POLICY``, the port takes it as an
# argument (``EPNet(..., ball_policy=...)``).
BALL_POLICIES = ('first_nested', 'first_multi', 'nearest')


def check_ball_policy(policy: str) -> str:
    """``policy`` if it is one of ``BALL_POLICIES``, else ValueError:
    'first_nested' (JAX's default: the outer ball's first hits, each scale
    the rows inside its radius), 'first_multi' (a first-hit query a scale)
    and 'nearest' (``ball_query_nested`` + ``nested_prefix_select``, the
    nearest-first query the JAX package keeps for reproduction)."""
    if policy not in BALL_POLICIES:
        raise ValueError(f'ball_policy {policy!r}: one of {BALL_POLICIES}')
    return policy


# The query families ``exact_ops`` may name (``pointops.py:133-147``).
QUERY_OPS = ('ball', 'three_nn', 'roipool')


def check_exact_ops(ops) -> Tuple[str, ...]:
    """``ops`` (names, or one comma-separated string) as a tuple of
    distinct names of ``QUERY_OPS``, else ValueError."""
    if isinstance(ops, str):
        ops = [o for o in ops.split(',') if o]
    ops = tuple(dict.fromkeys(ops))
    bad = [o for o in ops if o not in QUERY_OPS]
    if bad:
        raise ValueError(f'exact_ops {bad}: each one of {QUERY_OPS}')
    return ops


@dataclass(frozen=True)
class QueryOptions:
    """The query switches a model is built with (JAX's ``EPNET_*``
    environment, read at trace time there, an argument here):
    ``ball_policy`` the approximate multi-scale ball policy
    (``check_ball_policy``); ``exact_ops`` the families of ``QUERY_OPS``
    kept exact under the approximate policy; ``ball_f32`` the
    nearest-first nested query's keys in f32; ``three_nn_f32`` the
    approximate 3-NN's field in f32. Each acts only where the policy
    ``cfg.EXACT_QUERIES`` is False."""

    ball_policy: str = 'first_nested'
    exact_ops: Tuple[str, ...] = ()
    ball_f32: bool = False
    three_nn_f32: bool = False

    def __post_init__(self):
        check_ball_policy(self.ball_policy)
        object.__setattr__(self, 'exact_ops', check_exact_ops(self.exact_ops))


def query_options(queries: Optional[QueryOptions] = None,
                  ball_policy: Optional[str] = None) -> QueryOptions:
    """``queries``, or the default options with ``ball_policy`` (the
    shorthand the model constructors keep); ValueError if both are given
    and disagree."""
    if queries is None:
        return QueryOptions(ball_policy or 'first_nested')
    if ball_policy is not None and ball_policy != queries.ball_policy:
        raise ValueError(f'ball_policy {ball_policy!r} against the options\' '
                         f'{queries.ball_policy!r}')
    return queries


def block_local_allowed(exact_queries) -> bool:
    """Whether the query policy ``cfg.EXACT_QUERIES`` admits the block-local
    paths (``pointops.py:49-55``): yes under 'residual' (block-local
    grouping, every other query exact) and under False (the approximate
    family); no under True, and no under None, the JAX package's
    per-backend default, which is exact off the TPU."""
    return _policy(exact_queries) in ('residual', False)


def approx_allowed(exact_queries, op: str, exact_ops=()) -> bool:
    """Whether the policy admits the approximate query of ``op`` ('ball',
    'three_nn' or 'roipool'; ``pointops.py:108-113,133-152``): only under
    False, and not for an op in ``exact_ops``. 'residual' keeps every query
    outside the block-local paths exact, and None is exact off the TPU."""
    if op not in QUERY_OPS:
        raise ValueError(f'unknown query op {op!r}')
    return _policy(exact_queries) is False and op not in check_exact_ops(exact_ops)


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


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum((a - b)^2) over the last axis, x then y then z, as the JAX
    package writes it (``jnp.sum(d ** 2, axis=-1)``, ``pointops.py:364``;
    ``block_local.py:160-161``): the difference and the squares round to
    the coordinates' dtype, and ``jnp.sum`` adds bf16 squares in f32 and
    rounds the sum back once."""
    dx, dy, dz = (a - b).unbind(-1)
    return ((dx * dx).float() + (dy * dy).float() + (dz * dz).float()).to(dx.dtype)


def in_radius(d2: torch.Tensor, radius: float) -> torch.Tensor:
    """``d2 < radius^2``, strict like the CUDA kernel, with radius^2 rounded
    to the dtype of ``d2`` as JAX rounds its weakly typed constant."""
    return d2 < torch.tensor(radius * radius, dtype=d2.dtype).item()


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor,
               max_block_elems: int = 8 * 1024 * 1024) -> torch.Tensor:
    """The first ``nsample`` points strictly inside ``radius`` of each
    centroid, in ascending index order; short balls repeat the first hit and
    empty balls return index 0 (``ball_query_gpu.cu:28-44``).

    The centroids are taken in chunks so the transient (B, c, N) field stays
    within ``max_block_elems`` elements. bf16 coordinates (the RCNN's under
    ``MIXED_PRECISION``) give a bf16 distance field (``sq_dist``), as in
    the JAX package.

    :param xyz: (B, N, 3); new_xyz: (B, M, 3)
    :return: (B, M, nsample) int64
    """
    xyz = xyz.detach()

    def block(centroids):  # (B, c, 3) -> (B, c, nsample)
        return first_hits(in_radius(sq_dist(centroids[:, :, None, :], xyz[:, None, :, :]),
                                    radius), nsample)

    return _by_centroids(block, new_xyz.detach(), xyz.shape[1], max_block_elems)


def first_hits(mask: torch.Tensor, nsample: int) -> torch.Tensor:
    """The first ``nsample`` True positions of ``mask`` (..., N) in
    ascending index order; a short ball repeats its first hit and an empty
    one takes index 0 (``ball_query_gpu.cu:28-44``). Also the selection of
    the approximate family's ``_ball_from_d2_approx`` (``pointops.py:
    391-418``) with the stable top-k: its ``-index`` keys, in f32 or
    rounded to bf16, order the hits by index, ties by index too."""
    N = mask.shape[-1]
    key = torch.where(mask, torch.arange(N, device=mask.device), N)  # N: "no hit"
    idx = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    cnt = mask.sum(-1, keepdim=True)
    idx = torch.where(torch.arange(nsample, device=mask.device) < cnt, idx, idx[..., 0:1])
    return torch.where(cnt > 0, idx, 0)


def _by_centroids(block, centroids: torch.Tensor, n: int, max_block_elems: int):
    """``block`` over chunks of the (B, M, 3) centroids, each chunk's
    (B, c, n) field within ``max_block_elems`` elements; the results
    concatenated along M."""
    B, M = centroids.shape[:2]
    chunk = _chunk_size(M, max_block_elems // max(B * n, 1))
    return torch.cat([block(centroids[:, c:c + chunk]) for c in range(0, M, chunk)], 1)


def _scaled(p: torch.Tensor, radius: float) -> torch.Tensor:
    """Coordinates times f32(1 / radius), in f32 (``pointops.py:366``:
    bf16 coordinates widen to f32 in the product)."""
    return p.detach().float() * torch.tensor(1.0 / radius, dtype=torch.float32,
                                             device=p.device)


def ball_query_approx(radius: float, nsample: int, xyz: torch.Tensor,
                      new_xyz: torch.Tensor,
                      max_block_elems: int = 64 * 1024 * 1024) -> torch.Tensor:
    """``ball_query``'s approximate branch and ``ball_query_multi``'s
    per-scale query (``pointops.py:365-368,421-464``): the membership test
    ``d2n < 1`` on the matmul-form field (``_pairwise_d2``) of coordinates
    scaled by 1/radius, then the first ``nsample`` hits by index, as
    ``first_hits`` (JAX's bf16 ``-index`` keys with the stable top-k).
    Centroids chunked to a field of ``max_block_elems`` elements, as
    ``ball_query_multi`` does (values do not depend on the chunk).

    :return: (B, M, nsample) int64
    """
    xs = _scaled(xyz, radius)

    def block(cs):
        return first_hits(_pairwise_d2(cs, xs) < 1.0, nsample)

    return _by_centroids(block, _scaled(new_xyz, radius), xyz.shape[1], max_block_elems)


def ball_query_nested_first_hit(radii: Sequence[float], nsamples: Sequence[int],
                                xyz: torch.Tensor, new_xyz: torch.Tensor,
                                max_block_elems: int = 64 * 1024 * 1024) -> torch.Tensor:
    """The nested first-hit multi-scale query (``pointops.py:467-518``):
    the first ``nsamples[-1]`` hits of the OUTER ball (f32 ``-index`` keys
    over ``d2 / r_max^2 < 1``), pad-resolved; each inner scale is derived
    from the gathered rows by ``nested_radius_select``.

    :return: (B, M, nsamples[-1]) int64
    """
    if list(radii) != sorted(radii):
        raise ValueError(f'ball_query_nested_first_hit: radii {tuple(radii)} not ascending')
    return ball_query_approx(float(radii[-1]), int(nsamples[-1]), xyz, new_xyz,
                             max_block_elems)


def nested_radius_select(full: torch.Tensor, d2: torch.Tensor, radius: float,
                         outer: bool) -> torch.Tensor:
    """Scale ``radius``'s rows from the outer ball's gathered rows
    (``pointops.py:521-548``): rows with ``d2 < radius^2`` stay, the others
    take the first in-radius row (moved by a gather), and a ball with no row
    inside keeps slot 0 everywhere; the outer scale's rows as they are.

    :param full: (B, M, S, C) rows at the nested query's indices (the
        indices themselves, as (B, M, S, 1), select the same rows)
    :param d2: (B, M, S) each row's squared distance to its centroid
    """
    if outer:
        return full
    mask = in_radius(d2, radius)
    first = mask.to(torch.uint8).argmax(dim=-1)  # the first in-radius slot
    C = full.shape[-1]
    pad = torch.gather(full, 2, first[..., None, None].expand(*first.shape, 1, C))
    sel = torch.where(mask[..., None], full, pad)
    return torch.where(mask.any(dim=-1)[..., None, None], sel, full[:, :, 0:1, :])


def _key_order(keys: torch.Tensor) -> torch.Tensor:
    """bf16 or f32 ``keys`` as int64 in (-2^(w-1), 2^(w-1)), w their bit
    width, with the same order as their values (-0 and +0 equal): the
    magnitude's bits, negated for a negative key."""
    w = 16 if keys.dtype == torch.bfloat16 else 32
    view = torch.int16 if w == 16 else torch.int32
    bits = (keys + 0.0).view(view).to(torch.int64) & ((1 << w) - 1)
    half = 1 << (w - 1)
    return torch.where(bits >= half, half - bits, bits)


def nested_nearest_select(d2n: torch.Tensor, s_max: int, thresholds: Sequence[float],
                          f32_keys: bool = False):
    """The nearest-first selection of ``ball_query_nested`` and
    ``block_local_group_nested`` (``pointops.py:602-614``,
    ``block_local.py:487-498``) from the field ``d2n`` (..., N) of squared
    distances over r_max^2: keys ``-d2n`` rounded to bf16 (kept f32 with
    ``f32_keys``, JAX's ``EPNET_BALL_F32``) where ``d2n < 1`` (exact f32),
    -4 elsewhere; the ``s_max`` largest keys, descending, the lowest index
    first among equal keys (``lax.top_k``'s order, through one int64 key of
    the keys' order and the index); slots with a key at or below -2 take
    slot 0 and a ball with none takes index 0; ``cnts[i]`` the slots whose
    key, widened to f32, exceeds ``thresholds[i]`` rounded to f32, and last
    the outer ball's count.

    :return: (idx (..., s_max) int64, [cnt (...) int64 for each threshold,
        then the outer count])
    """
    N = d2n.shape[-1]
    kdt = torch.float32 if f32_keys else torch.bfloat16
    keys = torch.where(d2n < 1.0, (-d2n).to(kdt),
                       torch.tensor(-4.0, dtype=kdt, device=d2n.device))
    iota = torch.arange(N, device=d2n.device)
    packed = _key_order(keys) * (1 << 32) + (N - 1 - iota)
    idx = N - 1 - (torch.topk(packed, s_max, dim=-1, sorted=True).values & 0xFFFFFFFF)
    vf = torch.gather(keys, -1, idx).float()
    valid = vf > -2.0
    cnt = valid.sum(-1)
    idx = torch.where(valid, idx, idx[..., 0:1])
    idx = torch.where(cnt[..., None] > 0, idx, 0)
    cnts = [(vf > torch.tensor(t, dtype=torch.float32, device=vf.device)).sum(-1)
            for t in thresholds]
    return idx, cnts + [cnt]


def nested_thresholds(radii: Sequence[float]):
    """The inner scales' thresholds on the keys: -(r_i / r_max)^2."""
    return [-(float(r) / float(radii[-1])) ** 2 for r in radii[:-1]]


def ball_query_nested(radii: Sequence[float], nsamples: Sequence[int], xyz: torch.Tensor,
                      new_xyz: torch.Tensor, max_block_elems: int = 64 * 1024 * 1024,
                      f32_keys: bool = False):
    """The nearest-first nested multi-scale query (``pointops.py:551-626``,
    the ``nearest`` ball policy): one field of the coordinates scaled by
    1 / r_max (``_pairwise_d2``), then ``nested_nearest_select`` (its keys
    f32 with ``f32_keys``, ``ball_f32``). Scale i
    takes the first ``nsamples[i]`` slots, those at or past ``cnts[i]``
    replaced by slot 0 (``nested_prefix_select``). Centroids chunked to a
    field of ``max_block_elems`` elements (values do not depend on the
    chunk).

    :return: (idx (B, M, nsamples[-1]) int64, cnts: per scale (B, M) int64)
    """
    if list(radii) != sorted(radii) or list(nsamples) != sorted(nsamples) \
            or len(radii) != len(nsamples):
        raise ValueError(f'ball_query_nested: radii {tuple(radii)} and nsamples '
                         f'{tuple(nsamples)} must ascend, one a scale')
    r_max, s_max = float(radii[-1]), int(nsamples[-1])
    thrs = nested_thresholds(radii)
    xs, cs = _scaled(xyz, r_max), _scaled(new_xyz, r_max)
    B, M = cs.shape[:2]
    chunk = _chunk_size(M, max_block_elems // max(B * xs.shape[1], 1))
    parts = [nested_nearest_select(_pairwise_d2(cs[:, c:c + chunk], xs), s_max, thrs, f32_keys)
             for c in range(0, M, chunk)]
    idx = torch.cat([p[0] for p in parts], 1)
    cnts = [torch.cat([p[1][i] for p in parts], 1) for i in range(len(radii))]
    return idx, cnts


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
             max_block_elems: int = 64 * 1024 * 1024, approx: bool = False,
             f32_keys: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest neighbours (``interpolate_gpu.cu:9-75``): three masked
    argmins over the clipped squared-distance field, queries chunked to
    ``max_block_elems``. With ``approx`` the approximate branch
    (``pointops.py:661-691``): the field rounded to bf16 before the
    selection (kept f32 with ``f32_keys``, JAX's ``EPNET_3NN_F32``), the
    distances the square roots of the bf16 values in f32, so the
    interpolation weights see bf16-rounded distances. ``argmin`` takes the
    first minimum, as ``approx_min_k``'s stable form (``lax.top_k``) takes
    the lowest index among equal keys, so the f32 branch is the exact
    one.

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
        if approx and not f32_keys:
            d2 = d2.to(torch.bfloat16)
        d = d2
        ds, ids = [], []
        for _ in range(3):
            i = torch.argmin(d, dim=-1, keepdim=True)
            ds.append(torch.gather(d2, -1, i))
            ids.append(i)
            d = torch.where(iota == i, float('inf'), d)
        return torch.sqrt(torch.cat(ds, -1).float()), torch.cat(ids, -1)

    chunk = _chunk_size(N, max_block_elems // max(B * M, 1))
    parts = [block(unknown[:, c:c + chunk]) for c in range(0, N, chunk)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbour features: features (B, M, C), idx and
    weight (B, N, 3) -> (B, N, C). With bf16 features and weights, as the
    JAX package computes it (``pointops.py:716-729``): the products in bf16,
    their sum in f32 (``jnp.sum`` widens bf16), rounded to bf16."""
    return (group_points(features, idx) * weight[..., None]).float().sum(2).to(features.dtype)
