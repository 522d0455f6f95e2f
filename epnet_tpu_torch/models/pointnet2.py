"""PointNet++ set abstraction (MSG) and feature propagation: the exact
dense paths and the block-local configuration's.

Port of ``epnet_tpu/models/pointnet2.py`` (reference
``pointnet2_modules.py``: SA :19-109, FP :133-173). Stages without BN whose
scale MLP has three layers (the RCNN tower) run their interior through the
fused kernel (``ops/sa_fused.py``), as the JAX package does on a TPU; the
port's gate keeps only the conditions of the algebra (no BN, three layers,
a sampled stage), not the TPU's lane and VMEM limits, so the fused path
also runs at test widths.

With ``block_local`` (``RPN.BLOCK_LOCAL`` / ``RCNN.BLOCK_LOCAL`` under a
query policy that admits it, see ``ops/pointops.block_local_allowed``) a
stage over a Morton-sorted cloud sorts its FPS picks ascending and groups
inside block-local windows (``ops/block_local.py``) where its shapes
allow; a single-scale fused stage over a small table (RCNN sa0) takes the
windowed fused kernel instead; and an FP stage given ``known_idx``
interpolates inside windows. The gates are the JAX package's
(``pointnet2.py:42-52,120-150,375-395``).

With ``approx`` (``EXACT_QUERIES`` false, ``pointnet2.py:197-256,397``)
the queries are the approximate family of ``ops/pointops.py``: under the
``first_nested`` ball policy a monotone multi-scale stage (the RPN's) takes
one nested first-hit query of the outer ball, and each scale keeps the
gathered rows inside its own radius (``nested_radius_select``), so every
scale's MLP sees ``nsamples[-1]`` rows (the duplicates pad its max, and
count in its BatchNorm's batch statistics); under ``first_multi`` and in
single-scale stages each scale takes its own approximate query; a
single-scale stage over a small spatially ordered table (RCNN sa1 under
``RCNN.BLOCK_LOCAL``) takes the bucket select; FP takes the approximate
``three_nn``. Under the ``nearest`` policy a monotone multi-scale stage
takes one nearest-first nested query (``ball_query_nested``) and scale i
its first ``nsamples[i]`` slots, those past its in-radius count replaced
by slot 0 (``nested_prefix_select``, ``pointnet2.py:70-86,317-331``).
The policy and the f32-key switches come in one ``QueryOptions``
(``queries``; ``ball_policy=`` is its shorthand): ``ball_f32`` keeps the
nearest-first query's keys in f32, ``three_nn_f32`` FP's approximate
field. The caller resolves ``approx`` per query family
(``approx_allowed`` with ``queries.exact_ops``): the ball queries' for SA,
the 3-NN's for FP.

The RPN's stages take the sampler knobs (``pointnet2.py:105-116,135-150``):
``sampler`` 'random' (``RPN.SAMPLING``) takes the first ``npoint`` points
of the loader's shuffled cloud instead of FPS; ``fps_groups``
(``RPN.FPS_GROUPS``) partitions FPS (``ops/fps.py``); ``sort_fps`` (the
``RPN.FP_WINDOW`` middle mode) sorts the picks ascending on the dense path
too, so that every level stays Morton-sorted for the windowed FP.

With ``dtype`` (bf16 under ``MIXED_PRECISION``) the stages cast as the JAX
package's do: SA casts its features to bf16 before grouping
(``pointnet2.py:169-170``) and the recentred xyz after
(``:340-341``); the fused stages compute ``y`` and ``o`` in bf16 and pass
bf16 ``w2``/``w3`` with f32 biases (``:271-289``); FP casts the known
features and the interpolation weights to bf16 (``:391-403``). JAX's
packing of bf16 feature pairs into f32 lanes (``:171-195``) is a TPU
gather layout: the port gathers the bf16 rows. Coordinates keep their
dtype (bf16 in the RCNN tower), and so do the ball queries' distance
fields; FPS takes them widened to f32, as the JAX package's FPS kernel
widens them on the TPU (``fps_pallas.py:140``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.block_local import (block_local_available, block_local_fp_available,
                               block_local_group_multi, block_local_three_interp,
                               bucket_ball_query, to_window_relative, window_starts)
from ..ops.pointops import (QueryOptions, ball_query, ball_query_approx, ball_query_nested,
                            ball_query_nested_first_hit, furthest_point_sample,
                            gather_points, group_points, nested_radius_select,
                            query_options, sq_dist, three_interpolate, three_nn)
from ..ops.sa_fused import fused_point_mlp_max, fused_point_mlp_max_win
from .layers import SharedMLP


def nested_prefix_select(full: torch.Tensor, s_i: int, cnt: torch.Tensor,
                         outer: bool) -> torch.Tensor:
    """Scale i's rows from the nearest-first nested query's
    (``pointnet2.py:70-86``): its first ``s_i`` slots, those at or past
    ``cnt`` (B, M), the scale's in-radius count, replaced by slot 0; the
    outer scale's rows as they are.

    :param full: (B, M, s_max, C) rows at ``ball_query_nested``'s indices
        (the indices themselves, as (B, M, s_max, 1), select the same rows)
    """
    if outer:
        return full
    keep = (torch.arange(s_i, device=full.device) < cnt[..., None])[..., None]
    return torch.where(keep, full[:, :, :s_i], full[:, :, 0:1])


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction.

    ``forward(xyz (B, N, 3), features (B, N, C) or None)`` returns
    ``(new_xyz (B, M, 3), new_features (B, M, sum(mlp[-1])), fps_idx (B, M))``;
    ``npoint=None`` is group-all (one centroid at the origin, xyz not
    recentred) and returns ``fps_idx=None``. ``approx`` selects the
    approximate ball queries and ``queries`` (or its shorthand
    ``ball_policy``: 'first_nested', 'first_multi' or 'nearest') their
    multi-scale policy and key dtype; ``sampler``
    ('fps' or 'random'), ``fps_groups`` and ``sort_fps`` the RPN's sampler
    knobs.
    """

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_features: int, bn: bool = True, block_local: bool = False,
                 block_window: int = 1024, block_c: int = 128, dtype=None, device=None,
                 approx: bool = False, ball_policy: Optional[str] = None,
                 sampler: str = 'fps', fps_groups: int = 1, sort_fps: bool = False,
                 queries: Optional[QueryOptions] = None):
        super().__init__()
        self.npoint = npoint
        self.sampler = sampler
        self.fps_groups = fps_groups
        self.sort_fps = sort_fps
        self.approx = approx
        self.queries = query_options(queries, ball_policy)
        self.ball_policy = self.queries.ball_policy
        self.dtype = dtype
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.bn = bn
        self.block_local = block_local
        self.block_window = block_window
        self.block_c = block_c
        cin = 3 + in_features
        for i, hidden in enumerate(mlps):
            self.add_module(f'SharedMLP_{i}', SharedMLP(cin, hidden, bn=bn, dtype=dtype,
                                                        device=device))
        self.n_scales = len(mlps)
        self.out_features = sum(h[-1] for h in mlps)

    def mlp(self, i: int) -> SharedMLP:
        return getattr(self, f'SharedMLP_{i}')

    def uses_fused(self, i: int) -> bool:
        """Scale ``i`` through the fused SA interior (kernel B or G, and C or
        H in training; in bf16 B-bf16 or G-bf16, and C-bf16 or H-bf16 in
        training, which take C and H's limits). B, G, C and H take S <= 64
        and C1, C2 <= 128, and C and H also C3 <= 256
        (``ops.sa_fused.check_rows_takes``, ``check_bwd_takes``); B-bf16 and
        G-bf16 take B's limits and C3 <= 256 (``check_bf16_takes``). A wider
        scale runs only on the CPU and raises on the card: at the forward
        kernel's launch, or in the first forward that records a graph."""
        return self.npoint is not None and not self.bn and self.mlp(i).depth == 3

    def uses_block_local(self, n: int) -> bool:
        """Block-local grouping over a cloud of ``n`` points: the SA gate of
        ``pointnet2.py:42-52`` (``block_local`` already includes the query
        policy); the backbone reads it to know which levels stay
        Morton-sorted."""
        return (bool(self.block_local) and self.npoint is not None
                and list(self.radii) == sorted(self.radii)
                and list(self.nsamples) == sorted(self.nsamples)
                and block_local_available(n, self.npoint, self.block_window, self.block_c))

    def uses_nested(self) -> bool:
        """A nested query (``pointnet2.py:221-239``): a monotone multi-scale
        stage under the approximate queries and the ``first_nested`` (first
        hits) or ``nearest`` (nearest first) policy."""
        return (self.approx and self.ball_policy != 'first_multi' and self.npoint is not None
                and self.n_scales > 1 and list(self.radii) == sorted(self.radii)
                and list(self.nsamples) == sorted(self.nsamples))

    def uses_bucket(self, n: int) -> bool:
        """The bucket select of a single-scale stage over a small spatially
        ordered table under the approximate queries (``pointnet2.py:
        240-249``): RCNN sa1 in the block-local configuration."""
        return (self.block_local and self.approx and self.n_scales == 1
                and self.npoint is not None and n % self.nsamples[0] == 0)

    def uses_window(self, n: int) -> bool:
        """The windowed fused kernel over a table of ``n`` points: JAX's
        ``fused_sa_win_available`` without the TPU's lane and VMEM limits
        (``pointnet2.py:127-134``, ``sa_fused.py:570-589``)."""
        m, s, w, bc = self.npoint, self.nsamples[0], self.block_window, self.block_c
        return (self.block_local and not self.uses_block_local(n) and self.n_scales == 1
                and self.uses_fused(0) and n % s == 0 and w < n and w % 8 == 0
                and m % bc == 0 and (bc * s) % 8 == 0 and (m * s) % 8 == 0)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                bn_momentum: float = 0.1):
        if features is not None and self.dtype is not None:
            features = features.to(self.dtype)
        if self.npoint is None:
            return self._group_all(xyz, features, bn_momentum)
        n = xyz.shape[1]
        use_bl, use_win = self.uses_block_local(n), self.uses_window(n)
        if self.sampler == 'random':
            # the loader's cloud is shuffled: its first npoint points are a
            # uniform sample
            fps_idx = torch.arange(self.npoint, device=xyz.device).expand(xyz.shape[0], -1)
        else:
            fps_idx = furthest_point_sample(xyz.float(), self.npoint, groups=self.fps_groups)
        if use_bl or use_win or self.sort_fps:
            # ascending picks keep the subset Morton-sorted for the next stage
            fps_idx = fps_idx.sort(dim=-1).values
        new_xyz = gather_points(xyz, fps_idx)
        if use_win:
            w = self.block_window
            starts = window_starts(fps_idx, n, w, self.block_c)
            idx_rel = to_window_relative(
                bucket_ball_query(self.radii[0], self.nsamples[0], xyz, new_xyz), starts, w)
            return new_xyz, self._fused(0, xyz, features, new_xyz, idx_rel, starts), fps_idx
        nested = False
        if use_bl:
            scale_idx = block_local_group_multi(self.radii, self.nsamples, xyz, fps_idx,
                                                new_xyz, self.block_window, self.block_c)
        elif self.uses_nested() and self.ball_policy == 'nearest':
            # each scale's rows are a prefix of the outer ball's, nearest
            # first: selected here as indices, then gathered once a scale
            nested = True
            idx, cnts = ball_query_nested(self.radii, self.nsamples, xyz, new_xyz,
                                          f32_keys=self.queries.ball_f32)
            scale_idx = [nested_prefix_select(idx[..., None], s, cnts[i],
                                              i == self.n_scales - 1)[..., 0]
                         for i, s in enumerate(self.nsamples)]
        elif self.uses_nested():
            # each scale's rows are the outer ball's rows inside its radius:
            # selected here as indices, then gathered once a scale
            nested = True
            idx = ball_query_nested_first_hit(self.radii, self.nsamples, xyz, new_xyz)
            d2 = sq_dist(group_points(xyz.detach(), idx), new_xyz.detach()[:, :, None, :])
            scale_idx = [nested_radius_select(idx[..., None], d2, r, i == self.n_scales - 1)[..., 0]
                         for i, r in enumerate(self.radii)]
        elif self.uses_bucket(n):
            scale_idx = [bucket_ball_query(self.radii[0], self.nsamples[0], xyz, new_xyz)]
        else:
            query = ball_query_approx if self.approx else ball_query
            scale_idx = [query(r, s, xyz, new_xyz) for r, s in zip(self.radii, self.nsamples)]
        outs = []
        for i, idx in enumerate(scale_idx):
            if self.uses_fused(i) and not nested:
                outs.append(self._fused(i, xyz, features, new_xyz, idx))
                continue
            grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if self.dtype is not None:
                grouped = grouped.to(self.dtype)
            if features is not None:
                gf = group_points(features, idx)
                grouped = torch.cat([grouped, gf], -1)
            outs.append(self.mlp(i)(grouped, bn_momentum).amax(dim=2))  # max over samples
        return new_xyz, torch.cat(outs, -1), fps_idx

    def _fused(self, i, xyz, features, new_xyz, idx, starts=None):
        """Layer 1 over the table (``Y``) and the centroids (``O``), then the
        fused gather + layers 2-3 + max (``pointnet2.py:261-289``); with
        ``starts``, ``idx`` is window-relative (the windowed kernel). In
        bf16 the table, W1, b1, W2 and W3 are cast to bf16 and b2, b3 stay
        f32."""
        mlp = self.mlp(i)
        l1, l2, l3 = (mlp.layer(k).Dense_0 for k in range(3))
        cdt = self.dtype or torch.float32
        parts = [xyz.to(cdt)] + ([features.to(cdt)] if features is not None else [])
        table = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        w1 = l1.weight.t().to(cdt)
        y = torch.matmul(table, w1) + l1.bias.to(cdt)
        o = torch.matmul(new_xyz.to(cdt), w1[:3])
        weights = (l2.weight.t().to(cdt), l2.bias, l3.weight.t().to(cdt), l3.bias)
        if starts is not None:
            return fused_point_mlp_max_win(y, o, idx, starts, *weights, self.block_window)
        return fused_point_mlp_max(y, o, idx, *weights)

    def _group_all(self, xyz, features, bn_momentum):
        """Reference GroupAll (``pointnet2_utils.py:283-306``)."""
        g = xyz[:, None, :, :].to(self.dtype or xyz.dtype)
        if features is not None:
            g = torch.cat([g, features[:, None]], -1)
        outs = [self.mlp(i)(g, bn_momentum).amax(dim=2) for i in range(self.n_scales)]
        new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        return new_xyz, torch.cat(outs, -1), None


class FPModule(nn.Module):
    """Feature propagation: inverse-distance 3-NN interpolation + skip MLP
    (``pointnet2_modules.py:133-173``). With ``block_local`` and the knowns'
    ascending positions ``known_idx`` among the unknowns, the windowed
    interpolation of ``ops/block_local.py`` where the shapes allow
    (``pointnet2.py:375-395``), ``window`` knowns for each ``ublock``
    unknowns; elsewhere ``three_nn``, approximate with ``approx``, its
    field f32 with ``queries.three_nn_f32``."""

    def __init__(self, cin: int, mlp: Sequence[int], bn: bool = True,
                 block_local: bool = False, ublock: int = 512, window: int = 256,
                 dtype=None, device=None, approx: bool = False,
                 queries: Optional[QueryOptions] = None):
        super().__init__()
        self.dtype = dtype
        self.approx = approx
        self.queries = query_options(queries)
        self.SharedMLP_0 = SharedMLP(cin, mlp, bn=bn, dtype=dtype, device=device)
        self.block_local = block_local
        self.ublock = ublock
        self.window = window

    def uses_block_local(self, n: int, m: int, known_idx) -> bool:
        return (self.block_local and known_idx is not None
                and block_local_fp_available(n, m, self.ublock, self.window))

    def forward(self, unknown, known, unknown_feats, known_feats, bn_momentum: float = 0.1,
                known_idx=None):
        if self.dtype is not None:
            known_feats = known_feats.to(self.dtype)
        if self.uses_block_local(unknown.shape[1], known.shape[1], known_idx):
            interp = block_local_three_interp(unknown, known, known_feats, known_idx,
                                              self.ublock, self.window)
        else:
            dist, idx = three_nn(unknown, known, approx=self.approx,
                                 f32_keys=self.queries.three_nn_f32)
            recip = 1.0 / (dist + 1e-8)
            weight = recip / recip.sum(-1, keepdim=True)
            interp = three_interpolate(known_feats, idx, weight.to(known_feats.dtype))
        x = torch.cat([interp, unknown_feats], -1) if unknown_feats is not None else interp
        return self.SharedMLP_0(x, bn_momentum)
