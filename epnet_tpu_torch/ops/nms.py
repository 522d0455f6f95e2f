"""Greedy BEV NMS with fixed-size padded outputs: the CUDA kernel
``csrc/nms.cu`` and the plain PyTorch loop.

Port of ``epnet_tpu/ops/nms.py::nms_bev`` (reference ``iou3d_kernel.cu:
250-348`` + ``iou3d.cpp:105-116``): the axis-aligned overlap of the
proposal layer (the recipe's ``NMS_TYPE: normal``) or, with ``rotated``,
the exact rotated overlap of the final detections. Sorts are stable, as
``jnp.argsort`` is, so tied scores keep input order.

``nms_bev`` takes the path by ``rotated`` and the device: the axis-aligned
overlap on a CUDA tensor launches the kernel (``nms_bev_kernel``: one block
walks the kept boxes with a removed-bitmap in shared memory, one launch and
one read of the kept count a call; its design is written at the top of
``csrc/nms.cu``); the rotated overlap on any device, and any CPU tensor,
take the plain loop (``nms_bev_plain``). There is no fallback between the
two: a CUDA call with ``rotated=False`` launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import cuda_build
from .rotated_iou import boxes_iou_bev, iou_axis_aligned

_BLOCK = 64
_MAX_BOXES = 48 * 1024 * 8  # csrc/nms.cu's kMaxBoxes: one bit a box in 48 KB


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
    if boxes_bev.is_cuda and not rotated:
        return nms_bev_kernel(boxes_bev, scores, thresh, max_keep, num_valid)
    return nms_bev_plain(boxes_bev, scores, thresh, max_keep, rotated, num_valid)


def nms_bev_plain(boxes_bev: torch.Tensor, scores: torch.Tensor, thresh: float,
                  max_keep: int, rotated: bool = False, num_valid=None):
    """``nms_bev`` as a loop of tensor ops, on any device. The scan walks
    score-sorted candidates in 64-box blocks and computes each block's
    overlap columns on the fly, so the N x N IoU matrix never exists; it
    stops once ``max_keep`` boxes are kept, which leaves the kept prefix
    unchanged."""
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


def keep_indices(order: torch.Tensor, ranks: torch.Tensor, count: int,
                 max_keep: int) -> torch.Tensor:
    """(max_keep,) indices into the input order from the ascending kept
    ranks ``ranks[:count]`` (``count <= max_keep``), padded as
    ``nms_bev_plain`` pads: slots past ``count`` repeat the first kept box,
    a call that keeps nothing gives ``order[N - 1]``, and ``max_keep > N``
    repeats the last of the first N slots."""
    N = order.shape[0]
    k = min(max_keep, N)
    if count == 0:
        sel = torch.full((k,), N - 1, dtype=torch.int64, device=order.device)
    else:
        sel = ranks[:k]
        if count < k:
            sel = torch.where(torch.arange(k, device=order.device) < count, sel, ranks[0])
    idx = order[sel]
    if max_keep > N:
        idx = torch.cat([idx, idx[-1:].expand(max_keep - N)])
    return idx


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library('nms')
    if not getattr(lib, '_epnet_typed', False):
        lib.epnet_nms_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p]
        lib.epnet_nms_launch.restype = ctypes.c_int
        lib._epnet_typed = True
    return lib


def nms_bev_kernel(boxes_bev: torch.Tensor, scores: torch.Tensor, thresh: float,
                   max_keep: int, num_valid=None):
    """``nms_bev`` with the axis-aligned overlap through ``csrc/nms.cu``:
    (N, 5) float32 CUDA boxes, (N,) scores. Sorts as the plain loop does,
    launches on the current stream, reads the kept count once. Raises on
    anything the kernel does not take."""
    if not boxes_bev.is_cuda:
        raise ValueError(f'nms_bev_kernel needs a CUDA tensor, got {boxes_bev.device}')
    if boxes_bev.dtype != torch.float32:
        raise TypeError(f'nms_bev_kernel takes float32 boxes, got {boxes_bev.dtype}')
    if boxes_bev.dim() != 2 or boxes_bev.shape[1] != 5 or boxes_bev.shape[0] == 0:
        raise ValueError(f'expected (N, 5) boxes with N >= 1, got {tuple(boxes_bev.shape)}')
    N = boxes_bev.shape[0]
    if scores.shape != (N,) or scores.device != boxes_bev.device:
        raise ValueError(f'expected ({N},) scores on {boxes_bev.device}, got '
                         f'{tuple(scores.shape)} on {scores.device}')
    if max_keep < 1:
        raise ValueError(f'max_keep must be at least 1, got {max_keep}')
    nv = N if num_valid is None else min(max(int(num_valid), 0), N)
    if nv > _MAX_BOXES:
        raise ValueError(f'nms_bev_kernel walks at most {_MAX_BOXES} boxes, got {nv}')
    order = torch.argsort(-scores, stable=True)
    sb = boxes_bev.detach()[order].contiguous()
    ranks = torch.empty((max_keep,), dtype=torch.int64, device=sb.device)
    count = torch.empty((1,), dtype=torch.int32, device=sb.device)
    lib = _lib()
    with torch.cuda.device(sb.device):
        stream = torch.cuda.current_stream(sb.device).cuda_stream
        err = lib.epnet_nms_launch(sb.data_ptr(), nv, thresh, max_keep, ranks.data_ptr(),
                                   count.data_ptr(), stream)
    cuda_build.check(lib, err, 'nms kernel launch')
    nms_bev_kernel.launches += 1
    cnt = trace.host_int(count)
    return keep_indices(order, ranks, cnt, max_keep), cnt


nms_bev_kernel.launches = 0
