"""RoI-aware point pooling with static shapes.

Port of ``epnet_tpu/ops/roipool3d.py`` (reference ``roipool3d_kernel.cu``:
assign :97-120, pooled idx :123-160, gather :163-195): the rotated
(enlarged) box test for all (B, M, N), the first ``sampled_pt_num`` in-box
indices of each box in index order, and an empty flag. The exact path
repeats a short box's points cyclically; the approximate one
(``roipool3d.py:62-111``, ``EXACT_QUERIES`` false) pads them with the first
point. Coordinates and features are gathered each in its own dtype (bf16
features stay bf16; JAX's bitcast packing of the two into one table is a
TPU gather layout and moves the same values).
"""

from __future__ import annotations

import torch

from .boxes import enlarge_box3d, points_in_boxes3d


def roipool3d(xyz: torch.Tensor, features: torch.Tensor, boxes3d: torch.Tensor,
              pool_extra_width: float, sampled_pt_num: int = 512, approx: bool = False):
    """
    :param xyz: (B, N, 3) points in rect coords
    :param features: (B, N, C)
    :param boxes3d: (B, M, 7)
    :param approx: the approximate path: JAX's f32 ``-index`` keys under
        the stable top-k, i.e. the first k hits; slots past them repeat
        slot 0 instead of cycling
    :return: pooled_xyz (B, M, S, 3), pooled_feats (B, M, S, C),
        empty_flag (B, M) int32, cnt (B, M) int32: the in-box point count,
        or under ``approx`` the points found, at most min(S, N).
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
    if approx:
        cnt = cnt.clamp_max(k)  # the points found
    if k < S:
        first_k = torch.cat([first_k, first_k.new_full((B, M, S - k), N)], -1)
    empty = cnt == 0

    slot = torch.arange(S, device=dev)
    if approx:  # pad with the first point (roipool3d.py:89-101)
        idx = torch.where(slot < cnt.clamp_max(S)[..., None], first_k, first_k[..., 0:1])
    else:  # cyclic duplication for boxes with cnt < S (roipool3d_kernel.cu:144-153)
        wrapped = slot % cnt.clamp_min(1)[..., None]
        sel_slot = torch.where(slot >= cnt.clamp_max(S)[..., None], wrapped, slot)
        idx = torch.gather(first_k, -1, sel_slot)
    idx = torch.where(empty[..., None], 0, idx.clamp(0, N - 1))

    def pool(table):
        flat = idx.reshape(B, M * S, 1).expand(B, M * S, table.shape[-1])
        pooled = torch.gather(table, 1, flat).reshape(B, M, S, table.shape[-1])
        return torch.where(empty[..., None, None], 0.0, pooled)

    return pool(xyz), pool(features), empty.to(torch.int32), cnt.to(torch.int32)
