"""Official-protocol KITTI AP evaluation (2D bbox / BEV / 3D / AOS),
R40 recall sampling.

Host-side numpy re-implementation of
the reference's ``tools/kitti_object_eval_python/eval.py`` (difficulty
gating :28-82, greedy TP matching :156-273, 41-point threshold selection,
R40 averaging :556-561, entry point :613-684). The numba.cuda rotated IoU
is replaced by the vectorized numpy clip in ``rotate_iou_np``.

Annotation format (one dict per frame, numpy fields):
  name (str,), truncated, occluded, alpha, bbox (N, 4),
  dimensions (N, 3) [l, h, w], location (N, 3), rotation_y, score.

The port's own copy of ``epnet_tpu/eval/kitti_ap.py`` (numpy only);
``tests/test_torch_eval.py`` holds its report and AP to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .rotate_iou_np import rotate_iou_bev

CLASS_NAMES = ('car', 'pedestrian', 'cyclist', 'van', 'person_sitting')
MIN_HEIGHT = (40, 25, 25)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
N_SAMPLE_PTS = 41
NO_DET = -1


def empty_anno() -> Dict:
    return {
        'name': np.array([]), 'truncated': np.array([]), 'occluded': np.array([]),
        'alpha': np.array([]), 'bbox': np.zeros((0, 4)),
        'dimensions': np.zeros((0, 3)), 'location': np.zeros((0, 3)),
        'rotation_y': np.array([]), 'score': np.array([]),
    }


def _clean(gt, dt, cls_name: str, difficulty: int):
    """Difficulty gating -> ignore codes {0 count, 1 ignore, -1 drop} and
    DontCare boxes (clean_data semantics)."""
    ignored_gt, ignored_dt, dc = [], [], []
    n_valid = 0
    for i in range(len(gt['name'])):
        name = str(gt['name'][i]).lower()
        height = gt['bbox'][i, 3] - gt['bbox'][i, 1]
        if name == cls_name:
            valid = 1
        elif (cls_name == 'pedestrian' and name == 'person_sitting') or \
                (cls_name == 'car' and name == 'van'):
            valid = 0
        else:
            valid = -1
        too_hard = (gt['occluded'][i] > MAX_OCCLUSION[difficulty]
                    or gt['truncated'][i] > MAX_TRUNCATION[difficulty]
                    or height <= MIN_HEIGHT[difficulty])
        if valid == 1 and not too_hard:
            ignored_gt.append(0)
            n_valid += 1
        elif valid == 0 or (too_hard and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt['name'][i]) == 'DontCare':
            dc.append(gt['bbox'][i])
    for j in range(len(dt['name'])):
        height = abs(dt['bbox'][j, 3] - dt['bbox'][j, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif str(dt['name'][j]).lower() == cls_name:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = np.stack(dc, 0) if dc else np.zeros((0, 4))
    return n_valid, np.array(ignored_gt), np.array(ignored_dt), dc


def image_box_overlap(boxes, qboxes, criterion=-1):
    """(N, 4) x (K, 4) axis-aligned xyxy overlap."""
    N, K = len(boxes), len(qboxes)
    if N == 0 or K == 0:
        return np.zeros((N, K))
    lx = np.maximum(boxes[:, None, 0], qboxes[None, :, 0])
    rx = np.minimum(boxes[:, None, 2], qboxes[None, :, 2])
    ly = np.maximum(boxes[:, None, 1], qboxes[None, :, 1])
    ry = np.minimum(boxes[:, None, 3], qboxes[None, :, 3])
    iw = np.clip(rx - lx, 0, None)
    ih = np.clip(ry - ly, 0, None)
    inter = iw * ih
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    if criterion == -1:
        ua = area(boxes)[:, None] + area(qboxes)[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area(boxes)[:, None], inter.shape)
    else:
        ua = np.broadcast_to(area(qboxes)[None, :], inter.shape)
    return np.where(inter > 0, inter / np.where(ua > 0, ua, 1.0), 0.0)


def _metric_overlap(dt, gt, metric: int):
    """Overlap matrix (n_dt, n_gt) for a frame at a given metric."""
    if metric == 0:
        return image_box_overlap(dt['bbox'], gt['bbox'])
    if metric == 1:
        a = np.concatenate([dt['location'][:, [0, 2]],
                            dt['dimensions'][:, [0, 2]],
                            dt['rotation_y'][:, None]], axis=1)
        b = np.concatenate([gt['location'][:, [0, 2]],
                            gt['dimensions'][:, [0, 2]],
                            gt['rotation_y'][:, None]], axis=1)
        if len(a) == 0 or len(b) == 0:
            return np.zeros((len(a), len(b)))
        return rotate_iou_bev(a, b, criterion=-1)
    # metric 2: 3D — rotated BEV overlap x vertical overlap over union volume
    a = np.concatenate([dt['location'][:, [0, 2]], dt['dimensions'][:, [0, 2]],
                        dt['rotation_y'][:, None]], axis=1)
    b = np.concatenate([gt['location'][:, [0, 2]], gt['dimensions'][:, [0, 2]],
                        gt['rotation_y'][:, None]], axis=1)
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ov_bev = rotate_iou_bev(a, b, criterion=2)
    ya, ha = dt['location'][:, 1], dt['dimensions'][:, 1]
    yb, hb = gt['location'][:, 1], gt['dimensions'][:, 1]
    iw = np.minimum(ya[:, None], yb[None, :]) - \
        np.maximum((ya - ha)[:, None], (yb - hb)[None, :])
    vol_a = np.prod(dt['dimensions'], axis=1)[:, None]
    vol_b = np.prod(gt['dimensions'], axis=1)[None, :]
    inter = np.where(iw > 0, iw * ov_bev, 0.0)
    return inter / np.clip(vol_a + vol_b - inter, 1e-8, None)


def _match_frame(ov, gt, dt, ig_gt, ig_dt, dc, metric, min_overlap,
                 thresh=0.0, compute_fp=False, compute_aos=False):
    """Greedy per-gt matching (compute_statistics_jit semantics).

    :param ov: (n_dt, n_gt) overlap
    :return: tp, fp, fn, similarity, matched tp scores
    """
    n_gt, n_dt = len(ig_gt), len(ig_dt)
    scores = dt['score']
    assigned = np.zeros(n_dt, bool)
    below = scores < thresh if compute_fp else np.zeros(n_dt, bool)
    tp = fp = fn = 0
    similarity = 0.0
    tp_scores: List[float] = []
    deltas: List[float] = []
    for i in range(n_gt):
        if ig_gt[i] == -1:
            continue
        det_idx = -1
        best_score = -np.inf
        best_ov = 0.0
        found = False
        assigned_ignored = False
        for j in range(n_dt):
            if ig_dt[j] == -1 or assigned[j] or below[j]:
                continue
            o = ov[j, i]
            if not compute_fp:
                if o > min_overlap and scores[j] > best_score:
                    det_idx, best_score = j, scores[j]
                    found = True
            else:
                if o > min_overlap and (o > best_ov or assigned_ignored) and ig_dt[j] == 0:
                    best_ov, det_idx = o, j
                    found, assigned_ignored = True, False
                elif o > min_overlap and not found and ig_dt[j] == 1:
                    det_idx = j
                    found, assigned_ignored = True, True
        if not found and ig_gt[i] == 0:
            fn += 1
        elif found and (ig_gt[i] == 1 or ig_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif found:
            tp += 1
            tp_scores.append(scores[det_idx])
            if compute_aos:
                deltas.append(gt['alpha'][i] - dt['alpha'][det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(n_dt):
            if not (assigned[j] or ig_dt[j] != 0 or below[j]):
                fp += 1
        # detections swallowed by DontCare regions don't count as fp
        if metric == 0 and len(dc):
            ov_dc = image_box_overlap(dt['bbox'], dc, criterion=0)
            for i in range(len(dc)):
                for j in range(n_dt):
                    if assigned[j] or ig_dt[j] != 0 or below[j]:
                        continue
                    if ov_dc[j, i] > min_overlap:
                        assigned[j] = True
                        fp -= 1
        if compute_aos:
            sim = np.zeros(fp + len(deltas))
            sim[fp:] = (1.0 + np.cos(deltas)) / 2.0
            similarity = sim.sum() if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, tp_scores


def _select_thresholds(scores: np.ndarray, num_gt: int) -> np.ndarray:
    """41 recall-spaced score thresholds (get_thresholds semantics)."""
    scores = np.sort(scores)[::-1]
    out = []
    current = 0.0
    for i, s in enumerate(scores):
        l_rec = (i + 1) / num_gt
        r_rec = (i + 2) / num_gt if i < len(scores) - 1 else l_rec
        if (r_rec - current) < (current - l_rec) and i < len(scores) - 1:
            continue
        out.append(s)
        current += 1.0 / (N_SAMPLE_PTS - 1.0)
    return np.asarray(out)


def eval_class(gt_annos, dt_annos, cls_name: str, difficulty: int, metric: int,
               min_overlap: float, compute_aos: bool = False, overlaps=None):
    """Precision/recall/AOS curves for one (class, difficulty, metric).

    ``overlaps`` optionally carries per-frame dt-gt overlap matrices —
    they depend only on the metric, so callers sweeping difficulties reuse
    one set instead of re-running the rotated-IoU sweep (the dominant host
    cost) three times.
    """
    assert len(gt_annos) == len(dt_annos)
    cls_name = cls_name.lower()
    frames = []
    total_valid_gt = 0
    for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
        n_valid, ig_gt, ig_dt, dc = _clean(gt, dt, cls_name, difficulty)
        ov = (overlaps[i] if overlaps is not None
              else _metric_overlap(dt, gt, metric))
        frames.append((ov, gt, dt, ig_gt, ig_dt, dc))
        total_valid_gt += n_valid

    all_tp_scores = []
    for ov, gt, dt, ig_gt, ig_dt, dc in frames:
        _, _, _, _, s = _match_frame(ov, gt, dt, ig_gt, ig_dt, dc, metric,
                                     min_overlap, compute_fp=False)
        all_tp_scores += s
    thresholds = _select_thresholds(np.asarray(all_tp_scores),
                                    max(total_valid_gt, 1))

    pr = np.zeros((len(thresholds), 4))
    for t, th in enumerate(thresholds):
        for ov, gt, dt, ig_gt, ig_dt, dc in frames:
            tp, fp, fn, sim, _ = _match_frame(ov, gt, dt, ig_gt, ig_dt, dc,
                                              metric, min_overlap, thresh=th,
                                              compute_fp=True,
                                              compute_aos=compute_aos)
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if sim != -1:
                pr[t, 3] += sim

    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for t in range(len(thresholds)):
        recall[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 2], 1e-9)
        precision[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-9)
        if compute_aos:
            aos[t] = pr[t, 3] / max(pr[t, 0] + pr[t, 1], 1e-9)
    # right-max smoothing
    for t in range(N_SAMPLE_PTS):
        precision[t] = precision[t:].max()
        recall[t] = recall[t:].max()
        if compute_aos:
            aos[t] = aos[t:].max()
    return {'precision': precision, 'recall': recall, 'aos': aos}


def map_r40(curve: np.ndarray) -> float:
    """R40: mean over sample positions 1..40 (eval.py:556-561)."""
    return float(curve[1:].sum() / 40.0 * 100.0)


MIN_OVERLAPS = {  # class -> (loose, strict) per metric (bbox, bev, 3d)
    'car': {'strict': (0.7, 0.7, 0.7), 'loose': (0.7, 0.5, 0.5)},
    'pedestrian': {'strict': (0.5, 0.5, 0.5), 'loose': (0.5, 0.25, 0.25)},
    'cyclist': {'strict': (0.5, 0.5, 0.5), 'loose': (0.5, 0.25, 0.25)},
}


def get_official_eval_result(gt_annos, dt_annos, classes, use_aos: bool = True):
    """AP R40 for every class x difficulty x metric at the official strict
    overlaps (get_official_eval_result :613-684). Returns (report str, dict)."""
    if isinstance(classes, str):
        classes = [classes]
    report = []
    out = {}
    for cls in classes:
        key = cls.lower()
        t = MIN_OVERLAPS[key]['strict']
        res = {}
        for metric, name in ((0, 'bbox'), (1, 'bev'), (2, '3d')):
            # overlaps are difficulty-independent: compute once per metric
            ovs = [_metric_overlap(dt, gt, metric)
                   for gt, dt in zip(gt_annos, dt_annos)]
            aps = []
            for diff in (0, 1, 2):
                r = eval_class(gt_annos, dt_annos, key, diff, metric,
                               t[metric], compute_aos=use_aos and metric == 0,
                               overlaps=ovs)
                aps.append(map_r40(r['precision']))
                if metric == 0 and use_aos:
                    res.setdefault('aos', []).append(map_r40(r['aos']))
            res[name] = aps
        out[cls] = res
        report.append(f'{cls} AP@{t[0]:.2f}, {t[1]:.2f}, {t[2]:.2f}:')
        report.append('bbox AP: {:.4f}, {:.4f}, {:.4f}'.format(*res['bbox']))
        report.append('bev  AP: {:.4f}, {:.4f}, {:.4f}'.format(*res['bev']))
        report.append('3d   AP: {:.4f}, {:.4f}, {:.4f}'.format(*res['3d']))
        if 'aos' in res:
            report.append('aos  AP: {:.2f}, {:.2f}, {:.2f}'.format(*res['aos']))
    return '\n'.join(report), out
