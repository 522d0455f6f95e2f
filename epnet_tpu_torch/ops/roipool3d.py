"""RoI-aware point pooling with static shapes, exact path.

Port of the exact path of ``epnet_tpu/ops/roipool3d.py`` (reference
``roipool3d_kernel.cu``: assign :97-120, pooled idx :123-160, gather
:163-195): the rotated (enlarged) box test for all (B, M, N), the first
``sampled_pt_num`` in-box indices of each box in index order, repeated
cyclically when a box holds fewer, and an empty flag. Features gather from
an f32 table.
"""

from __future__ import annotations

import torch

from .boxes import enlarge_box3d, points_in_boxes3d


def roipool3d(xyz: torch.Tensor, features: torch.Tensor, boxes3d: torch.Tensor,
              pool_extra_width: float, sampled_pt_num: int = 512):
    """
    :param xyz: (B, N, 3) points in rect coords
    :param features: (B, N, C)
    :param boxes3d: (B, M, 7)
    :return: pooled_xyz (B, M, S, 3), pooled_feats (B, M, S, C),
        empty_flag (B, M) int32, cnt (B, M) int32 in-box point count.
        Empty boxes pool zeros.
    """
    B, N, _ = xyz.shape
    M = boxes3d.shape[1]
    S = sampled_pt_num
    dev = xyz.device

    big = enlarge_box3d(boxes3d.reshape(-1, 7), pool_extra_width).reshape(B, M, 7)
    mask = points_in_boxes3d(xyz, big)  # (B, M, N)

    iota = torch.arange(N, device=dev)
    k = min(S, N)
    key = torch.where(mask, iota, N)
    first_k = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    cnt = mask.sum(-1)  # (B, M)
    if k < S:
        first_k = torch.cat([first_k, first_k.new_full((B, M, S - k), N)], -1)
    empty = cnt == 0

    # cyclic duplication for boxes with cnt < S (roipool3d_kernel.cu:144-153)
    slot = torch.arange(S, device=dev)
    wrapped = slot % cnt.clamp_min(1)[..., None]
    sel_slot = torch.where(slot >= cnt.clamp_max(S)[..., None], wrapped, slot)
    idx = torch.gather(first_k, -1, sel_slot)
    idx = torch.where(empty[..., None], 0, idx.clamp(0, N - 1))

    table = torch.cat([xyz, features.to(xyz.dtype)], -1)
    flat = idx.reshape(B, M * S, 1).expand(B, M * S, table.shape[-1])
    pooled = torch.gather(table, 1, flat).reshape(B, M, S, table.shape[-1])
    pooled = torch.where(empty[..., None, None], 0.0, pooled)
    return (pooled[..., :3], pooled[..., 3:].to(features.dtype),
            empty.to(torch.int32), cnt.to(torch.int32))
