"""The RPN's evaluation: proposal recall, foreground segmentation IoU and
the feature dump of the two-phase flow.

Port of ``epnet_tpu/eval/rpn_eval.py`` (reference ``tools/eval_rcnn.py``,
``eval_one_epoch_rpn`` :120-275 and ``save_rpn_features`` :104-117): the
RPN's forward (``EPNet`` in TEST mode without the RCNN), the TEST
proposals, the recall of the gt boxes at 3D IoU {0.1, 0.3, 0.5, 0.7, 0.9}
and the seg IoU against the RPN labels. With ``save_rpn_feature`` each
frame's proposals go to ``<result_dir>/roi_result/data/%06d.txt`` (KITTI
format, for the offline RCNN) and its points, features, intensity, seg
mask and raw scores to ``<result_dir>/features/%06d{,_xyz,_intensity,
_seg,_rawscore}.npy``, which the offline RCNN samples read.

``rpn_eval_step`` runs on the model's device under
``torch.inference_mode()``; files stay on the host.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..models.proposal import ProposalLayer
from ..ops.rotated_iou import boxes_iou3d
from .kitti_common import save_kitti_format

THRESH_LIST = (0.1, 0.3, 0.5, 0.7, 0.9)


def rpn_eval_step(cfg: Config, model, proposal: ProposalLayer,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One batch through the RPN (``model``: ``EPNet`` in TEST mode without
    the RCNN, in eval mode) and the proposal layer; the counterpart of
    ``make_rpn_eval_step``'s step.

    :param batch: ``pts_input`` on the model's device; with ``gt_boxes3d``
        (zero-padded) the recall counts, with ``rpn_cls_label`` the seg IoU
    :return: ``rois`` (B, M, 7), ``roi_scores``, ``counts``, ``seg`` (B, N)
        bool, the backbone's ``backbone_xyz`` and ``backbone_features``,
        ``rpn_scores_raw``; ``recall`` (5,) and ``gt_count``; ``seg_iou``
    """
    with torch.inference_mode():
        out = model(batch)
        scores_raw = out['rpn_cls'][..., 0]
        rois, roi_scores, counts = proposal(scores_raw, out['rpn_reg'], out['backbone_xyz'])
        seg = torch.sigmoid(scores_raw) > cfg.RPN.SCORE_THRESH
        res = {'rois': rois, 'roi_scores': roi_scores, 'counts': counts, 'seg': seg,
               'backbone_xyz': out['backbone_xyz'],
               'backbone_features': out['backbone_features'], 'rpn_scores_raw': scores_raw}
        if 'gt_boxes3d' in batch:
            gt = batch['gt_boxes3d']
            gt_valid = torch.any(gt != 0, dim=-1)
            rec = []
            for b in range(gt.shape[0]):
                gt_max = boxes_iou3d(rois[b], gt[b]).max(dim=0).values
                rec.append(torch.stack([((gt_max > t) & gt_valid[b]).sum() for t in THRESH_LIST]))
            res['recall'] = torch.stack(rec).sum(0)
            res['gt_count'] = gt_valid.sum()
        if 'rpn_cls_label' in batch:
            fg = batch['rpn_cls_label'] > 0
            correct = (seg & fg).sum()
            union = fg.sum() + seg.sum() - correct
            res['seg_iou'] = correct / torch.clamp(union, min=1.0)
        return res


def save_rpn_features(feat_dir: str, sid: int, res: Dict[str, np.ndarray], k: int,
                      pts_input: np.ndarray) -> None:
    """Frame ``sid``'s dumps (batch row ``k``): features, points, intensity
    (the input's fourth channel, zeros without one), seg mask, raw scores."""
    np.save(os.path.join(feat_dir, '%06d.npy' % sid), res['backbone_features'][k])
    np.save(os.path.join(feat_dir, '%06d_xyz.npy' % sid), res['backbone_xyz'][k])
    inten = pts_input[k][:, 3] if pts_input.shape[-1] > 3 \
        else np.zeros(res['backbone_xyz'].shape[1], np.float32)
    np.save(os.path.join(feat_dir, '%06d_intensity.npy' % sid), inten)
    np.save(os.path.join(feat_dir, '%06d_seg.npy' % sid), res['seg'][k].astype(np.float32))
    np.save(os.path.join(feat_dir, '%06d_rawscore.npy' % sid), res['rpn_scores_raw'][k])


def evaluate_rpn(cfg: Config, model, dataset, loader, result_dir: str, logger=None,
                 save_rpn_feature: bool = False) -> Dict:
    """A whole pass over ``loader``: the mean seg IoU over batches and the
    recall at each IoU threshold over all gt boxes
    (``rpn_recall(thresh=0.50)`` and so on); with ``save_rpn_feature`` the
    dumps and proposal files of every frame.

    :param model: ``EPNet`` in TEST mode with ``RCNN.ENABLED`` false; the
        batches go to its device
    """
    device = next(model.parameters()).device
    model.eval()
    proposal = ProposalLayer(cfg, 'TEST')
    feat_dir = os.path.join(result_dir, 'features')
    roi_dir = os.path.join(result_dir, 'roi_result', 'data')
    if save_rpn_feature:
        os.makedirs(feat_dir, exist_ok=True)
        os.makedirs(roi_dir, exist_ok=True)

    tot_recall = np.zeros(len(THRESH_LIST))
    tot_gt, tot_iou, n = 0, 0.0, 0
    for batch in loader:
        dev = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
               if isinstance(v, np.ndarray) and v.dtype != object and k != 'sample_id'}
        res = {k: v.cpu().numpy() for k, v in rpn_eval_step(cfg, model, proposal, dev).items()}
        n += 1
        if 'recall' in res:
            tot_recall += res['recall']
            tot_gt += int(res['gt_count'])
        if 'seg_iou' in res:
            tot_iou += float(res['seg_iou'])
        if save_rpn_feature:
            for k, sid in enumerate(np.atleast_1d(batch['sample_id'])):
                sid = int(sid)
                n_roi = int(res['counts'][k])
                save_kitti_format(roi_dir, sid, dataset.get_calib(sid), res['rois'][k][:n_roi],
                                  res['roi_scores'][k][:n_roi], dataset.get_image_shape(sid),
                                  classes=(cfg.CLASSES,))
                save_rpn_features(feat_dir, sid, res, k, batch['pts_input'])

    ret = {'seg_iou': tot_iou / max(n, 1)}
    for i, t in enumerate(THRESH_LIST):
        ret['rpn_recall(thresh=%.2f)' % t] = tot_recall[i] / max(tot_gt, 1)
    if logger:
        for k, v in ret.items():
            logger.info('%s: %.4f', k, v)
    return ret
