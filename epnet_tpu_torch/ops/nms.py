"""Greedy BEV NMS with fixed-size padded outputs.

Port of ``epnet_tpu/ops/nms.py::nms_bev`` (reference ``iou3d_kernel.cu:
250-348`` + ``iou3d.cpp:105-116``): the axis-aligned overlap of the
proposal layer (the recipe's ``NMS_TYPE: normal``) or, with ``rotated``,
the exact rotated overlap of the final detections. The scan walks score-sorted candidates in 64-box
blocks on the device and computes each block's overlap columns on the fly,
so the N x N IoU matrix never exists; it stops once ``max_keep`` boxes are
kept, which leaves the kept prefix unchanged. Sorts are stable, as
``jnp.argsort`` is, so tied scores keep input order.
"""

from __future__ import annotations

import torch

from ..utils import trace
from .rotated_iou import boxes_iou_bev, iou_axis_aligned

_BLOCK = 64


def nms_bev(boxes_bev: torch.Tensor, scores: torch.Tensor, thresh: float,
            max_keep: int, rotated: bool = False, num_valid=None):
    """NMS over (N, 5) BEV boxes, sorted by score internally (descending);
    the overlap is ``boxes_iou_bev`` with ``rotated``, else the
    axis-aligned IoU.

    Returns ``(idx, count)``: (max_keep,) int64 indices into the input order,
    valid for the first ``count`` entries and padded; ``num_valid`` restricts
    the scan to the ``num_valid`` best inputs (callers that pad candidate
    sets with -inf-score dummies).
    """
    N = boxes_bev.shape[0]
    dev = boxes_bev.device
    order = torch.argsort(-scores, stable=True)
    sb = boxes_bev[order]
    num_valid = N if num_valid is None else int(num_valid)

    pad = (-N) % _BLOCK
    Np = N + pad
    if pad:
        # park padding far away with zero extent: overlaps nothing
        filler = torch.zeros((pad, 5), dtype=sb.dtype, device=dev)
        filler[:, 0:2] = 1e8
        sb = torch.cat([sb, filler], 0)
    iota_n = torch.arange(Np, device=dev)
    iota_k = torch.arange(_BLOCK, device=dev)
    later = iota_k[None, :] > iota_k[:, None]  # later[i, k]: k after i
    overlap = boxes_iou_bev if rotated else iou_axis_aligned

    kept = torch.zeros(Np, dtype=torch.bool, device=dev)
    kept_cnt = 0
    b = 0
    while b < Np // _BLOCK and kept_cnt < max_keep and b * _BLOCK < num_valid:
        start = b * _BLOCK
        blk = sb[start:start + _BLOCK]
        cols = overlap(sb, blk) > thresh  # (Np, K) streamed overlaps
        earlier = (iota_n < start)[:, None]
        s = (cols & kept[:, None] & earlier).any(0)
        blk_mat = cols[start:start + _BLOCK] & later
        for i in range(_BLOCK):  # greedy within the block, on the device
            s = s | (~s[i] & blk_mat[i])
        keep_blk = ~s & (start + iota_k < num_valid)
        kept[start:start + _BLOCK] = keep_blk
        kept_cnt += trace.host_int(keep_blk.sum())
        b += 1
    kept = kept[:N]
    count = trace.host_int(kept.sum())

    # first max_keep kept ranks, in score order
    k = min(max_keep, N)
    rank = torch.arange(N, device=dev)
    key = torch.where(kept, -rank, -(N + 1))
    sel_rank = -torch.topk(key, k, sorted=True).values  # ascending kept ranks
    sel_rank = torch.where(torch.arange(k, device=dev) < count, sel_rank, sel_rank[0])
    idx = order[sel_rank.clamp(0, N - 1)]
    if max_keep > N:
        idx = torch.cat([idx, idx[-1:].expand(max_keep - N)])
    return idx, min(count, max_keep)
