"""Proposal generation: decode per-point boxes, distance-partitioned or
score-based NMS, fixed-size padded RoI output.

Port of ``epnet_tpu/models/proposal.py`` (reference
``lib/rpn/proposal_layer.py``: decode :23-31, distance-based proposals
:58-119, score-based :121-142). Each batch element goes through a Python
loop in place of ``lax.map``; every list is a padded tensor plus a count.
``RPN_DISTANCE_BASED_PROPOSE`` (per mode) takes the two distance ranges,
each through the axis-aligned NMS under ``RPN.NMS_TYPE: normal`` and the
rotated one under ``rotate``; the score-based proposals take the
``RPN_PRE_NMS_TOP_N`` best boxes through one rotated NMS
(``proposal.py:141-146``).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..ops.bbox_codec import decode_bbox_target
from ..ops.boxes import boxes3d_to_bev
from ..ops.nms import nms_bev
from ..utils import trace

NMS_RANGES = (0.0, 40.0, 80.0)  # proposal_layer.py:65


def _first_k_masked(mask: torch.Tensor, k: int):
    """Indices of the first k True positions (ascending), padded with 0,
    and the valid count (<= k)."""
    n = mask.shape[0]
    key = torch.where(mask, torch.arange(n, device=mask.device), n)
    idx = torch.topk(key, k, largest=False, sorted=True).values
    cnt = min(trace.host_int(mask.sum()), k)
    return torch.where(torch.arange(k, device=mask.device) < cnt, idx, 0), cnt


def _range_nms(props, scores, cand_idx, cand_cnt: int, nms_thresh, post_n, rotated: bool):
    """NMS over a fixed-size candidate set whose first cand_cnt entries are
    valid. Returns (boxes (post_n, 7), scores (post_n,), count)."""
    k = cand_idx.shape[0]
    dev = props.device
    valid = torch.arange(k, device=dev) < cand_cnt
    cboxes = props[cand_idx]
    cscores = torch.where(valid, scores[cand_idx], float('-inf'))
    # park invalid candidates far away so they can never suppress real ones
    dummy = torch.tensor([1e6, 0, 1e6, 1, 1, 1, 0], dtype=cboxes.dtype, device=dev)
    cboxes = torch.where(valid[:, None], cboxes, dummy)
    keep_idx, keep_cnt = nms_bev(boxes3d_to_bev(cboxes), cscores, nms_thresh,
                                 max_keep=post_n, rotated=rotated, num_valid=cand_cnt)
    slot_ok = torch.arange(post_n, device=dev) < keep_cnt
    return (torch.where(slot_ok[:, None], cboxes[keep_idx], 0.0),
            torch.where(slot_ok, cscores[keep_idx], 0.0), keep_cnt)


class ProposalLayer:
    """Proposal layer; ``mode`` selects the TRAIN/TEST budgets."""

    def __init__(self, cfg: Config, mode: str = 'TEST'):
        if cfg.RPN.NMS_TYPE not in ('normal', 'rotate'):
            raise ValueError(f"RPN.NMS_TYPE {cfg.RPN.NMS_TYPE!r}: 'normal' or 'rotate'")
        self.cfg = cfg
        self.mode = mode
        self.mcfg = cfg.get(mode)

    def __call__(self, rpn_scores, rpn_reg, xyz):
        """
        :param rpn_scores: (B, N) raw logits
        :param rpn_reg: (B, N, C)
        :param xyz: (B, N, 3)
        :return: rois (B, POST, 7), roi_scores_raw (B, POST), counts (B,) int64
        """
        cfg = self.cfg
        B, N = rpn_scores.shape
        mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=rpn_reg.dtype,
                                 device=rpn_reg.device)
        props = decode_bbox_target(
            xyz.reshape(-1, 3), rpn_reg.reshape(B * N, -1), mean_size,
            loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
            num_head_bin=cfg.RPN.NUM_HEAD_BIN, get_xz_fine=cfg.RPN.LOC_XZ_FINE,
            get_y_by_bin=False, get_ry_fine=False,
            bbox_avg_by_bin=cfg.TRAIN.BBOX_AVG_BY_BIN,
            ry_with_bin=self.mcfg.RY_WITH_BIN)
        # shift y to the box bottom (proposal_layer.py:31)
        props = torch.cat([props[:, 0:1], props[:, 1:2] + props[:, 3:4] / 2,
                           props[:, 2:]], 1).reshape(B, N, 7)
        outs = [self._single(rpn_scores[b], props[b]) for b in range(B)]
        rois = torch.stack([o[0] for o in outs])
        scores = torch.stack([o[1] for o in outs])
        counts = torch.tensor([o[2] for o in outs], device=rpn_scores.device)
        return rois, scores, counts

    def _single(self, scores, props):
        mcfg = self.mcfg
        dev = scores.device
        order = torch.argsort(-scores, stable=True)
        scores_o = scores[order]
        props_o = props[order]
        n = scores.shape[0]
        pre, post = mcfg.RPN_PRE_NMS_TOP_N, mcfg.RPN_POST_NMS_TOP_N
        thresh = mcfg.RPN_NMS_THRESH
        if not mcfg.RPN_DISTANCE_BASED_PROPOSE:  # proposal_layer.py:121-142
            k = min(pre, n)
            return _range_nms(props_o, scores_o, torch.arange(k, device=dev), k, thresh, post,
                              rotated=True)
        rotated = self.cfg.RPN.NMS_TYPE == 'rotate'
        pre_ns = (int(pre * 0.7), pre - int(pre * 0.7))
        post_ns = (int(post * 0.7), post - int(post * 0.7))
        dist = props_o[:, 2]
        m1 = (dist > NMS_RANGES[0]) & (dist <= NMS_RANGES[1])
        m2 = (dist > NMS_RANGES[1]) & (dist <= NMS_RANGES[2])

        idx1, cnt1 = _first_k_masked(m1, min(pre_ns[0], n))
        b1, s1, c1 = _range_nms(props_o, scores_o, idx1, cnt1, thresh, post_ns[0], rotated)

        # far range; when empty, reuse the near-range candidates ranked
        # [pre_n1 : pre_n1 + pre_n2] (proposal_layer.py:92-100)
        k2 = min(pre_ns[1], n)
        idx2, cnt2 = _first_k_masked(m2, k2)
        if cnt2 == 0:
            idx1_ext, cnt1_ext = _first_k_masked(m1, min(pre_ns[0] + pre_ns[1], n))
            pad = pre_ns[0] + k2 - idx1_ext.shape[0]
            if pad > 0:
                idx1_ext = torch.cat([idx1_ext, idx1_ext.new_zeros(pad)])
            idx2 = idx1_ext[pre_ns[0]:pre_ns[0] + k2]
            cnt2 = min(max(cnt1_ext - pre_ns[0], 0), k2)
        b2, s2, c2 = _range_nms(props_o, scores_o, idx2, cnt2, thresh, post_ns[1], rotated)

        # range 2 starts right after range 1's c1 entries, like torch.cat of
        # the reference's ragged lists
        boxes = torch.zeros((post, 7), dtype=props.dtype, device=dev)
        scr = torch.zeros((post,), dtype=scores.dtype, device=dev)
        boxes[:post_ns[0]] = b1
        scr[:post_ns[0]] = s1
        boxes[c1:c1 + c2] = b2[:c2]
        scr[c1:c1 + c2] = s2[:c2]
        return boxes, scr, c1 + c2
