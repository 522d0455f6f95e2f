"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/``), stage by stage.

Eval cells (``judge_eval``), for each request sampled from the window:

- ``rpn_gap``: the reference's RPN run on the benchmark's own scenes and
  weights; the program's ``rpn_cls``, ``rpn_reg`` and backbone features.
- ``roi_gap``: the reference's proposal layer run on the program's RPN
  outputs; the program's RoIs, their scores and its seg mask.
- ``rcnn_gap``: the reference's RoI pooling and RCNN run on the program's
  RoIs and RPN features; the program's ``rcnn_cls`` and ``rcnn_reg``.
- ``det_gap``: the reference's detection head (decode, score threshold,
  rotated NMS) run on the program's RoIs and RCNN outputs; the program's
  decoded boxes and the detections that reached the host (boxes, scores
  and counts: a count that differs reads 1).

Each gap is ``max |program - reference| / max |reference|`` over the
stage's outputs. Every stage after the first starts from the program's own
outputs of the stage before: the proposal and NMS choices are discrete,
and rounding noise in the RPN's 16384 scores reorders near-ties, so a
reference run end to end would pick other boxes on most seeds. The first
stage is checked from the inputs, and each later stage by itself.

The train cell (``judge_train``): the reference follows the first three
steps that set-up took through the program's own ``train_step``, on the
same batches and weights, its RoIs and seg mask the program's (captured
from its forward) and its dropout masks and RoI sampling drawn from a
generator seeded as the program's. Compared:

- ``first_loss_gap``: the first step's loss, ``|L_p - L_r| / |L_r|``.
  The later steps' losses are read (``train_readings``) but not compared:
  Adam's first updates move each element by about the learning rate
  whatever the size of its gradient, so round-off in the smallest
  gradients moves the parameters by whole updates, and steps 2-3 part by
  up to 1e-2 where step 1 parts by 1e-7; where one foreground RoI carries
  the RCNN's loss, that drift reads 20% at step 3 (PERF.md).
- ``grad_gap``: the first step's gradient as the optimizer took it (after
  the clip; the program's worked out from its Adam first moment,
  ``mu / (1 - beta1)``), leaf by leaf, the worst:
  ``| |g_p| - |g_r| |`` over the larger of ``|g_r|`` and the median leaf's.
- ``delta_median_gap``: the parameters' change over the three steps, the
  median leaf's norm, ``| |d_p| - |d_r| | / |d_r|``, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (the
  others move by round-off alone). The worst leaf's (``delta_gap``) is
  read but not compared: the same drift moves it up to 0.54.
- ``roi_gap``: the proposal layer at TRAIN budgets, as the eval cells'
  ``roi_gap``: the reference's proposals made from each step's recorded
  RPN outputs, against the program's RoIs, their scores and its seg mask.

The control (``control.py``) puts the reference in the program's place in
a lower precision and has to fail one of the gaps.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights as weights_mod
from .reference import model as ref
from .reference import train as ref_train

RPN_KEYS = ('rpn_cls', 'rpn_reg', 'backbone_features')
RCNN_KEYS = ('rcnn_cls', 'rcnn_reg')
RCNN_BLOCK = 200  # RoIs of the reference's RCNN at a time


def gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """max |p - r| / max |r|; inf where the shapes differ."""
    if tuple(program.shape) != tuple(reference.shape):
        return float('inf')
    p, r = program.double(), reference.double().to(program.device)
    scale = r.abs().max().item() if r.numel() else 0.0
    return (p - r).abs().max().item() / max(scale, 1e-30) if r.numel() else 0.0


def build_reference(cfg_file: dict, seed: int, device) -> ref.EPNetReference:
    """The reference model with the benchmark's weights for ``seed``, in
    eval mode, TF32 off in every product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ref.EPNetReference(ref.Cfg(cfg_file['model'])).to(device)
    model.load_state_dict(benchmark_weights(cfg_file, seed, device))
    return model.eval()


def benchmark_weights(cfg_file: dict, seed: int, device) -> dict:
    """The weights of a run of ``seed`` (``weights.make``), named as the
    reference's state."""
    return weights_mod.make(reference_shapes(cfg_file['model']), cfg_file['weights_seed'], seed,
                            device)


def reference_shapes(cfg_tree: dict) -> dict:
    with torch.device('meta'):
        return weights_mod.shapes_of(ref.EPNetReference(ref.Cfg(cfg_tree)))


def rcnn_blocks(model: ref.EPNetReference, pooled: torch.Tensor) -> dict:
    """The eval RCNN over blocks of RoIs (each RoI is independent in eval)."""
    parts = [model.rcnn(pooled[i:i + RCNN_BLOCK]) for i in range(0, pooled.shape[0], RCNN_BLOCK)]
    return {k: torch.cat([p[k] for p in parts]) for k in RCNN_KEYS}


def eval_gaps(model: ref.EPNetReference, batch: dict, out: dict, final: dict) -> dict:
    """The four gaps of one request. ``out`` holds the program's model
    outputs (RPN, RoIs, RCNN), ``final`` its detection head's outputs:
    ``pred_boxes3d`` and, as they reached the host, ``final_boxes``,
    ``final_scores``, ``final_counts``."""
    cfg = model.cfg
    with torch.no_grad():
        r = model.rpn(batch['pts_input'], batch.get('img'), batch.get('pts_origin_xy'))
        g = {'rpn_gap': max(gap(out[k], r[k]) for k in RPN_KEYS)}
        del r
        xyz = out['backbone_xyz']
        rois, scores = ref.proposals(cfg, 'TEST', out['rpn_cls'][..., 0], out['rpn_reg'], xyz)
        seg, depth = model.seg_and_depth(out['rpn_cls'], xyz)
        g['roi_gap'] = max(gap(out['rois'], rois), gap(out['roi_scores_raw'], scores),
                           gap(out['seg_result'], seg))
        pooled = ref.pool_for_eval(cfg, out['rois'], xyz, out['backbone_features'], seg, depth)
        rc = rcnn_blocks(model, pooled)
        del pooled
        g['rcnn_gap'] = max(gap(out[k], rc[k]) for k in RCNN_KEYS)
        pred, raw, kept = ref.detections(cfg, out['rois'], out['rcnn_cls'], out['rcnn_reg'])
        det = [gap(final['pred_boxes3d'], pred)]
        for b, k in enumerate(kept):
            n = int(final['final_counts'][b])
            if n != k.numel():
                det.append(1.0)
                continue
            det.append(gap(final['final_boxes'][b][:n], pred[b][k]))
            det.append(gap(final['final_scores'][b][:n], raw[b][k]))
        g['det_gap'] = max(det)
    return g


def judge_eval(cfg_file: dict, seed: int, device, samples) -> dict:
    """The worst of each gap over ``samples``, a list of (batch, out,
    final) as ``eval_gaps`` takes them."""
    model = build_reference(cfg_file, seed, device)
    worst = {}
    for batch, out, final in samples:
        for k, v in eval_gaps(model, batch, out, final).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def leaf_gap(program: dict, reference: dict, names) -> float:
    """The worst leaf of ``| |p| - |r| | / max(|r|, median |r|)`` over
    ``names``."""
    pn = {n: program[n].double().norm().item() for n in names}
    rn = {n: reference[n].double().norm().item() for n in names}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names)


def follow_steps(model: ref.EPNetReference, rec: dict, device, forward=None):
    """The reference's three steps as ``rec`` recorded the program's:
    (losses, first clipped gradients {name: tensor}, changes {name: tensor})."""
    forward = forward or ref_train.train_forward
    model.train()
    named = list(model.named_parameters())
    opt = ref_train.AdamWOneCycle(named, model.cfg, rec['total_steps'])
    gen = torch.Generator(device=device).manual_seed(rec['generator_seed'])
    start = {n: p.detach().clone() for n, p in named}
    losses, grad1 = [], None
    for k, batch in enumerate(rec['batches']):
        for _, p in named:
            p.grad = None
        out = forward(model, batch, rec['rois'][k], rec['seg'][k], rec['bn_momentum'], gen)
        loss = ref_train.joint_loss(model.cfg, out, batch)
        loss.backward()
        del out
        g = opt.step()
        losses.append(loss.item())
        if k == 0:
            grad1 = {n: x.detach().clone() for (n, _), x in zip(named, g)}
    delta = {n: (p.detach() - start[n]) for n, p in named}
    return losses, grad1, delta


def train_roi_gap(model: ref.EPNetReference, rec: dict) -> float:
    """The proposal layer at TRAIN budgets: the reference's proposals and
    seg mask made from each followed step's recorded RPN outputs, against
    the program's RoIs, their scores and its seg mask."""
    worst = 0.0
    with torch.no_grad():
        for k, rois_p in enumerate(rec['rois']):
            cls, xyz = rec['rpn_cls'][k], rec['xyz'][k]
            rois, scores = ref.proposals(model.cfg, 'TRAIN', cls[..., 0], rec['rpn_reg'][k], xyz)
            seg, _ = model.seg_and_depth(cls, xyz)
            worst = max(worst, gap(rois_p, rois), gap(rec['roi_scores'][k], scores),
                        gap(rec['seg'][k], seg))
    return worst


def train_readings(model: ref.EPNetReference, rec: dict, device) -> dict:
    """Every reading of a train record against the reference: the compared
    gaps (``TRAIN_CHECKS``) and, for the look behind them, each step's loss
    gap and the gap of the median leaf's change."""
    out = {'roi_gap': train_roi_gap(model, rec)}
    losses, grad1, delta = follow_steps(model, rec, device)
    names = sorted(grad1)
    norms = {n: grad1[n].double().norm().item() for n in names}
    med = float(np.median(list(norms.values())))
    moved = [n for n in names if norms[n] >= 1e-3 * med]
    steps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(rec['loss'], losses)]
    med_p = float(np.median([rec['delta'][n].double().norm().item() for n in moved]))
    med_r = float(np.median([delta[n].double().norm().item() for n in moved]))
    out.update({'first_loss_gap': steps[0], 'grad_gap': leaf_gap(rec['grad1'], grad1, names),
                'delta_gap': leaf_gap(rec['delta'], delta, moved),
                'delta_median_gap': abs(med_p - med_r) / max(med_r, 1e-30)})
    out.update({f'loss_gap_step{k + 1}': v for k, v in enumerate(steps)})
    return out


TRAIN_CHECKS = ('first_loss_gap', 'grad_gap', 'delta_median_gap', 'roi_gap')


def judge_train(cfg_file: dict, seed: int, device, rec: dict) -> dict:
    if any(r.shape[0] != b['pts_input'].shape[0] for r, b in zip(rec['rois'], rec['batches'])):
        # the program proposed RoIs for another number of scans than it got
        return {k: float('inf') for k in TRAIN_CHECKS}
    r = train_readings(build_reference(cfg_file, seed, device), rec, device)
    return {k: r[k] for k in TRAIN_CHECKS}
