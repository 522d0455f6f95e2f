"""The offline RCNN's evaluation: refine proposals read from files.

Port of ``epnet_tpu/eval/rcnn_offline_eval.py`` (reference
``tools/eval_rcnn.py``, ``eval_one_epoch_rcnn`` :278-495): each frame's
pooled RoIs come from the dataset's ``get_proposal_from_file`` (an RPN
eval's proposal txts and dumps); the RCNN scores them (its raw ``rcnn_cls``
alone, as the reference) and refines their boxes; then the score
threshold, the rotated NMS, the KITTI txt files and the KITTI AP. A frame
is padded to ``MAX_ROIS`` RoIs, as the JAX package pads it for one
compiled program.

``rcnn_offline_eval_step`` runs on the RCNN's device under
``torch.inference_mode()``; files and AP stay on the host.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from ..ops.bbox_codec import decode_bbox_target
from ..ops.boxes import boxes3d_to_bev
from ..ops.nms import nms_bev
from .kitti_ap import get_official_eval_result
from .kitti_common import get_label_annos, parse_label_file, save_kitti_format

MAX_ROIS = 128  # a frame's RoI budget (test-time proposals are <= 100)


def unwrap_rcnn(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The RCNN's own tensors (names relative to ``RCNNNet``) from either a
    bare ``RCNNNet`` state or a whole ``EPNet``'s (prefix ``rcnn.``), as
    ``_unwrap_rcnn`` takes bare RCNN variables or full EPNet ones."""
    if any(k.startswith('rcnn.') for k in state):
        return {k[len('rcnn.'):]: v for k, v in state.items() if k.startswith('rcnn.')}
    return dict(state)


def restore_rcnn(path: str, rcnn) -> int:
    """Load the RCNN's parameters into ``rcnn`` (an ``RCNNNet``) from a
    checkpoint of the port's trainer in any mode that trains it
    (``rcnn_offline``, ``rcnn_online``, ``rcnn``). Returns the epoch."""
    saved = torch.load(path, map_location='cpu', weights_only=True)
    rcnn.load_state_dict(unwrap_rcnn(saved['model']))
    return int(saved['epoch'])


def rcnn_offline_eval_step(cfg: Config, rcnn, pts_input: torch.Tensor, rois: torch.Tensor,
                           n_valid: int):
    """One frame: the RCNN (``RCNNNet`` in eval mode) on its (MAX_ROIS, S,
    C) pooled RoIs, of which the first ``n_valid`` are real; the boxes
    decoded from the RoIs, the ones above ``RCNN.SCORE_THRESH`` kept
    through the rotated NMS. Returns (boxes (MAX_ROIS, 7), raw scores,
    count), valid for the first ``count``."""
    with torch.inference_mode():
        out = rcnn(pts_input)
        if out['rcnn_cls'].shape[-1] > 1:
            # multi-class (People) head: objectness 1 - P(background) as a
            # logit, as in the joint eval
            prob_fg = 1.0 - torch.softmax(out['rcnn_cls'].reshape(MAX_ROIS, -1), dim=-1)[..., 0]
            prob_fg = torch.clamp(prob_fg, 1e-7, 1.0 - 1e-7)
            rcnn_cls = torch.log(prob_fg) - torch.log1p(-prob_fg)
        else:
            rcnn_cls = out['rcnn_cls'].reshape(-1)
        rcnn_reg = out['rcnn_reg']
        if cfg.USE_IOU_BRANCH:  # the joint eval's fusion (rcnn_offline_eval.py:53-55)
            rcnn_cls = torch.clamp(out['rcnn_iou_branch'].reshape(-1), min=1e-4) * rcnn_cls
        mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=rcnn_reg.dtype, device=rois.device)
        pred = decode_bbox_target(
            rois, rcnn_reg, mean_size, loc_scope=cfg.RCNN.LOC_SCOPE,
            loc_bin_size=cfg.RCNN.LOC_BIN_SIZE, num_head_bin=cfg.RCNN.NUM_HEAD_BIN,
            get_xz_fine=True, get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN,
            loc_y_scope=cfg.RCNN.LOC_Y_SCOPE, loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE,
            get_ry_fine=True, bbox_avg_by_bin=cfg.TEST.BBOX_AVG_BY_BIN,
            ry_with_bin=cfg.TEST.RY_WITH_BIN)
        valid = torch.arange(MAX_ROIS, device=rois.device) < n_valid
        mask = (torch.sigmoid(rcnn_cls) > cfg.RCNN.SCORE_THRESH) & valid
        scores = torch.where(mask, rcnn_cls, float('-inf'))
        idx, cnt = nms_bev(boxes3d_to_bev(pred), scores, cfg.RCNN.NMS_THRESH,
                           max_keep=MAX_ROIS, rotated=True, num_valid=int(mask.sum()))
        return pred[idx], scores[idx], cnt


def evaluate_rcnn_offline(cfg: Config, model, dataset, result_dir: str, logger=None,
                          run_ap: bool = True) -> Dict:
    """Every frame of ``dataset`` (an offline RCNN dataset in EVAL or TEST
    mode, ``RPN.ENABLED`` false) through ``rcnn_offline_eval_step``: the
    KITTI txt files under ``result_dir/final_result/data``,
    ``rcnn_avg_num`` (kept boxes a frame) and, with ``run_ap``, the AP.

    :param model: the RCNN: an ``RCNNNet``, or an ``EPNet`` holding one as
        ``.rcnn`` (the offline model or a joint one); its device takes the
        frames
    """
    rcnn = getattr(model, 'rcnn', model)
    rcnn.eval()
    device = next(rcnn.parameters()).device
    final_dir = os.path.join(result_dir, 'final_result', 'data')
    os.makedirs(final_dir, exist_ok=True)
    seen, total = [], 0
    for i in range(len(dataset)):
        s = dataset[i]
        sid = s['sample_id']
        seen.append(sid)
        m = min(len(s['roi_boxes3d']), MAX_ROIS)
        S, C = s['pts_input'].shape[1], s['pts_input'].shape[2]
        pts = np.zeros((MAX_ROIS, S, C), np.float32)
        rois = np.zeros((MAX_ROIS, 7), np.float32)
        pts[:m] = s['pts_input'][:m]
        rois[:m] = s['roi_boxes3d'][:m]
        pred, sc, cnt = rcnn_offline_eval_step(cfg, rcnn, torch.from_numpy(pts).to(device),
                                               torch.from_numpy(rois).to(device), m)
        total += cnt
        save_kitti_format(final_dir, sid, dataset.get_calib(sid), pred[:cnt].cpu().numpy(),
                          sc[:cnt].cpu().numpy(), dataset.get_image_shape(sid),
                          classes=(cfg.CLASSES,))
    ret = {'rcnn_avg_num': total / max(len(seen), 1)}
    if run_ap:
        gt_annos = get_label_annos(dataset.label_dir, seen)
        dt_annos = [parse_label_file(os.path.join(final_dir, '%06d.txt' % i)) for i in seen]
        report, ap = get_official_eval_result(gt_annos, dt_annos, cfg.CLASSES)
        ret['ap'] = ap
        ret['ap_report'] = report
        if logger:
            logger.info('\n%s', report)
    return ret
