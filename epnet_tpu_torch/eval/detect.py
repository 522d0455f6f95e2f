"""Joint two-stage inference and evaluation.

Port of ``epnet_tpu/eval/detect.py`` (reference ``tools/eval_rcnn.py``,
``eval_one_epoch_joint`` :498-745): the model's forward, the multi-class
head's objectness, the IoU-branch score fusion (:558-561), the RCNN box
decode (:568-575), recall against the gt (:598-632), the score threshold
and the rotated NMS of each image (:663-682), KITTI-format txt output and
the KITTI AP (:736-742).

``joint_eval_step`` runs on the model's device under
``torch.inference_mode()``; files and AP stay on the host.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..ops.bbox_codec import decode_bbox_target
from ..ops.boxes import boxes3d_to_bev
from ..ops.nms import nms_bev
from ..ops.rotated_iou import boxes_iou3d
from ..utils import trace
from .kitti_ap import get_official_eval_result
from .kitti_common import get_label_annos, parse_label_file, save_kitti_format

THRESH_LIST = (0.1, 0.3, 0.5, 0.7, 0.9)


def joint_eval_step(cfg: Config, model, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One batch through ``model`` (``EPNet`` in TEST mode, eval mode) and
    the detection head; the counterpart of ``make_joint_eval_step``'s step.

    :param batch: ``pts_input``, ``img``, ``pts_origin_xy`` tensors on the
        model's device; with ``gt_boxes3d`` (zero-padded) the recall counts,
        with ``rpn_cls_label`` the RPN's segmentation IoU
    :return: per image the decoded boxes and scores of all M RoIs
        (``pred_boxes3d``, ``raw_scores``, ``norm_scores``) and the kept
        ones after the threshold and NMS (``final_boxes``, ``final_scores``:
        (B, M, ...), valid for the first ``final_counts`` entries)
    """
    with torch.inference_mode(), trace.span('request'):
        out = model(batch)
        with trace.span('detect'):
            B = batch['pts_input'].shape[0]
            M = cfg.TEST.RPN_POST_NMS_TOP_N
            rois = out['rois']
            if out['rcnn_cls'].shape[-1] > 1:
                # multi-class (People) head: objectness = 1 - P(background),
                # mapped back to a logit so the sigmoid scoring below holds
                prob_fg = 1.0 - torch.softmax(out['rcnn_cls'].reshape(B, M, -1), dim=-1)[..., 0]
                prob_fg = torch.clamp(prob_fg, 1e-7, 1.0 - 1e-7)
                rcnn_cls = torch.log(prob_fg) - torch.log1p(-prob_fg)
            else:
                rcnn_cls = out['rcnn_cls'].reshape(B, M)
            rcnn_reg = out['rcnn_reg'].reshape(B, M, -1)
            if cfg.USE_IOU_BRANCH:
                iou_b = torch.clamp(out['rcnn_iou_branch'].reshape(B, M), min=1e-4)
                rcnn_cls = iou_b * rcnn_cls  # eval_rcnn.py:558-561

            mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=rcnn_reg.dtype, device=rois.device)
            pred = decode_bbox_target(
                rois.reshape(-1, 7), rcnn_reg.reshape(B * M, -1), mean_size,
                loc_scope=cfg.RCNN.LOC_SCOPE, loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
                num_head_bin=cfg.RCNN.NUM_HEAD_BIN, get_xz_fine=True,
                get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN, loc_y_scope=cfg.RCNN.LOC_Y_SCOPE,
                loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE, get_ry_fine=True,
                bbox_avg_by_bin=cfg.TEST.BBOX_AVG_BY_BIN,
                ry_with_bin=cfg.TEST.RY_WITH_BIN).reshape(B, M, 7)

            raw_scores = rcnn_cls
            norm_scores = torch.sigmoid(raw_scores)
            roi_valid = torch.any(rois != 0, dim=-1)  # zero-padded rois
            keep_mask = (norm_scores > cfg.RCNN.SCORE_THRESH) & roi_valid

            final_boxes, final_scores, final_counts = [], [], []
            for b in range(B):
                # nms_bev sorts by score; -inf dummies sort last and num_valid
                # stops the scan before them
                scores = torch.where(keep_mask[b], raw_scores[b], float('-inf'))
                idx, n = nms_bev(boxes3d_to_bev(pred[b]), scores, cfg.RCNN.NMS_THRESH, max_keep=M,
                                 rotated=True, num_valid=trace.host_int(keep_mask[b].sum()))
                final_boxes.append(pred[b][idx])
                final_scores.append(scores[idx])
                final_counts.append(n)

            res = {'pred_boxes3d': pred, 'raw_scores': raw_scores, 'norm_scores': norm_scores,
                   'rois': rois, 'roi_scores_raw': out['roi_scores_raw'],
                   'seg_result': out['seg_result'], 'final_boxes': torch.stack(final_boxes),
                   'final_scores': torch.stack(final_scores),
                   'final_counts': torch.tensor(final_counts, device=rois.device)}

        if 'gt_boxes3d' in batch:
            gt = batch['gt_boxes3d']
            gt_valid = torch.any(gt != 0, dim=-1)  # (B, G)
            rv = roi_valid.to(pred.dtype)
            rec_p, rec_r = [], []
            for b in range(B):
                # zero-padded roi slots decode to spurious mean-size boxes
                # near the origin: they are left out of the recall max
                for boxes, rec in ((pred[b], rec_p), (rois[b], rec_r)):
                    gt_max = (boxes_iou3d(boxes, gt[b]) * rv[b][:, None]).max(dim=0).values
                    rec.append(torch.stack([((gt_max > t) & gt_valid[b]).sum()
                                            for t in THRESH_LIST]))
            res['recall_pred'] = torch.stack(rec_p).sum(0)
            res['recall_roi'] = torch.stack(rec_r).sum(0)
            res['gt_count'] = gt_valid.sum()

        if 'rpn_cls_label' in batch:
            seg, fg = res['seg_result'] > 0, batch['rpn_cls_label'] > 0
            correct = (seg & fg).sum()
            union = fg.sum() + seg.sum() - correct
            res['rpn_iou'] = correct / torch.clamp(union, min=1)
        return res


def evaluate_joint(cfg: Config, model, dataset, loader, result_dir: str, logger=None,
                   run_ap: bool = True, save_result: bool = False) -> Dict:
    """A whole pass over ``loader``: detection, the KITTI txt files under
    ``result_dir/final_result/data``, recall and AP. With ``save_result``,
    also the RoIs and every refined box (eval_rcnn.py:639-660).

    :param model: ``EPNet`` in TEST mode; the batches go to its device
    """
    device = next(model.parameters()).device
    model.eval()
    final_dir = os.path.join(result_dir, 'final_result', 'data')
    os.makedirs(final_dir, exist_ok=True)
    if save_result:
        roi_dir = os.path.join(result_dir, 'roi_result', 'data')
        refine_dir = os.path.join(result_dir, 'refine_result', 'data')
        os.makedirs(roi_dir, exist_ok=True)
        os.makedirs(refine_dir, exist_ok=True)

    tot_recall_pred = np.zeros(len(THRESH_LIST))
    tot_recall_roi = np.zeros(len(THRESH_LIST))
    tot_gt = 0
    tot_rpn_iou, n_batches, final_total = 0.0, 0, 0
    seen_ids = []

    for batch in loader:
        dev = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
               if isinstance(v, np.ndarray) and k != 'sample_id'}
        res = {k: v.cpu().numpy() for k, v in joint_eval_step(cfg, model, dev).items()}
        n_batches += 1
        if 'recall_pred' in res:
            tot_recall_pred += res['recall_pred']
            tot_recall_roi += res['recall_roi']
            tot_gt += int(res['gt_count'])
        if 'rpn_iou' in res:
            tot_rpn_iou += float(res['rpn_iou'])

        for k, sid in enumerate(np.atleast_1d(batch['sample_id'])):
            sid = int(sid)
            seen_ids.append(sid)
            n = int(res['final_counts'][k])
            final_total += n
            calib = dataset.get_calib(sid)
            img_shape = dataset.get_image_shape(sid)
            save_kitti_format(final_dir, sid, calib, res['final_boxes'][k][:n],
                              res['final_scores'][k][:n], img_shape, classes=(cfg.CLASSES,))
            if save_result:
                save_kitti_format(roi_dir, sid, calib, res['rois'][k], res['roi_scores_raw'][k],
                                  img_shape, classes=(cfg.CLASSES,))
                save_kitti_format(refine_dir, sid, calib, res['pred_boxes3d'][k],
                                  res['raw_scores'][k], img_shape, classes=(cfg.CLASSES,))

    ret = {'rpn_iou': tot_rpn_iou / max(n_batches, 1),
           'rcnn_avg_num': final_total / max(len(seen_ids), 1)}
    for i, t in enumerate(THRESH_LIST):
        ret['rpn_recall(thresh=%.2f)' % t] = tot_recall_roi[i] / max(tot_gt, 1)
        ret['rcnn_recall(thresh=%.2f)' % t] = tot_recall_pred[i] / max(tot_gt, 1)
    if logger:
        for k, v in ret.items():
            logger.info('%s: %.4f', k, v)

    if run_ap:
        gt_annos = get_label_annos(dataset.label_dir, seen_ids)
        dt_annos = [parse_label_file(os.path.join(final_dir, '%06d.txt' % i)) for i in seen_ids]
        report, ap = get_official_eval_result(gt_annos, dt_annos, cfg.CLASSES)
        if logger:
            logger.info('\n%s', report)
        ret['ap'] = ap
        ret['ap_report'] = report
    return ret
