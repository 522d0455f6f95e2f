"""The control of the comparison: the reference put in the program's place
in the nearest precision below the configuration's, which ``judge.py`` has
to find wrong.

The configurations are float32 with TF32 off, so the control's products
(every Linear, matmul, convolution and transposed convolution) take TF32
operands: each operand rounded to 10 mantissa bits, to nearest even, and
summed in f32, which is what the tensor cores do with TF32 on
(``TF32Products``; the same rounding on the CPU, so the tests see it too).
The proposal layer and the detection head have no products: their box
arithmetic runs in bfloat16, the nearest precision below f32 there.

``control_outputs`` builds, for one batch, what the program's timed path
would hand the judge: the model's outputs (``out``) and the detection
head's (``final``), each stage fed by the control's own stage before.
``control_record`` takes the train cell's followed steps as the program's
set-up does, with TF32 products forward and backward (on the card the
TF32 switches of cuBLAS and cuDNN, on the CPU ``TF32Products`` in the
forward), each step's RoIs and seg mask its own proposals' (their box
arithmetic in bfloat16, as in eval).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .judge import rcnn_blocks
from .reference import model as ref
from .reference import train as ref_train

_PRODUCTS = {F.linear, torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.mm, torch.bmm, F.conv2d, F.conv_transpose2d, torch.einsum}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even; the
    gradient passes through unchanged."""
    if t.dtype != torch.float32:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return t + (bits.view(torch.float32) - t).detach()


class TF32Products(TorchFunctionMode):
    """Within the mode, both operands of every product are TF32-rounded
    (biases are added in f32, as after the tensor cores)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            if func is torch.einsum:
                args = (args[0],) + tuple(tf32_round(a) if torch.is_tensor(a) else a
                                          for a in args[1:])
            else:
                args = tuple(tf32_round(a) if torch.is_tensor(a) and i < 2 else a
                             for i, a in enumerate(args))
                if 'weight' in kwargs:
                    kwargs['weight'] = tf32_round(kwargs['weight'])
        return func(*args, **kwargs)


def _bf16(t):
    return t.to(torch.bfloat16)


def control_outputs(model: ref.EPNetReference, batch: dict):
    """(out, final) of the control on ``batch``, as ``judge.eval_gaps``
    takes the program's."""
    cfg = model.cfg
    with torch.no_grad():
        with TF32Products():
            out = dict(model.rpn(batch['pts_input'], batch.get('img'), batch.get('pts_origin_xy')))
        xyz = out['backbone_xyz']
        rois, scores = ref.proposals(cfg, 'TEST', _bf16(out['rpn_cls'][..., 0]),
                                     _bf16(out['rpn_reg']), _bf16(xyz))
        out['rois'], out['roi_scores_raw'] = rois.float(), scores.float()
        seg, depth = model.seg_and_depth(out['rpn_cls'], xyz)
        out['seg_result'] = seg
        with TF32Products():
            pooled = ref.pool_for_eval(cfg, out['rois'], xyz, out['backbone_features'], seg, depth)
            out.update(rcnn_blocks(model, pooled))
        pred, raw, kept = ref.detections(cfg, _bf16(out['rois']), _bf16(out['rcnn_cls']),
                                         _bf16(out['rcnn_reg']))
        pred, raw = pred.float(), raw.float()
        B, M = pred.shape[:2]
        boxes = torch.zeros((B, M, 7), device=pred.device)
        scores = torch.zeros((B, M), device=pred.device)
        for b, k in enumerate(kept):
            boxes[b, :k.numel()] = pred[b][k]
            scores[b, :k.numel()] = raw[b][k]
        final = {'pred_boxes3d': pred, 'final_boxes': boxes.cpu(), 'final_scores': scores.cpu(),
                 'final_counts': torch.tensor([k.numel() for k in kept])}
    return out, final


@contextlib.contextmanager
def tf32(device):
    """TF32 products in the block: the library switches on the card, the
    operand rounding of ``TF32Products`` on the CPU."""
    if torch.device(device).type != 'cuda':
        with TF32Products():
            yield
        return
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def control_record(model: ref.EPNetReference, batches, rec_template: dict, device) -> dict:
    """The train record (as ``entries/train.py``'s ``Entry.record``) of the
    control: the reference's own steps in TF32 on ``batches``, proposing its
    own RoIs in bfloat16."""
    cfg = model.cfg
    model.train()
    named = list(model.named_parameters())
    opt = ref_train.AdamWOneCycle(named, cfg, rec_template['total_steps'])
    gen = torch.Generator(device=device).manual_seed(rec_template['generator_seed'])
    start = {n: p.detach().clone() for n, p in named}
    rec = dict(rec_template, batches=batches, loss=[], rpn_cls=[], rpn_reg=[], xyz=[],
               rois=[], roi_scores=[], seg=[])
    for k, batch in enumerate(batches):
        for _, p in named:
            p.grad = None
        with tf32(device):
            out = dict(model.rpn(batch['pts_input'], batch.get('img'), batch.get('pts_origin_xy'),
                                 rec['bn_momentum'], gen))
            with torch.no_grad():
                xyz, cls = out['backbone_xyz'].detach(), out['rpn_cls'].detach()
                reg = out['rpn_reg'].detach()
                rois, scores = ref.proposals(cfg, 'TRAIN', _bf16(cls[..., 0]), _bf16(reg),
                                             _bf16(xyz))
                rois, scores = rois.float(), scores.float()
                seg, depth = model.seg_and_depth(cls, xyz)
                tgt = ref_train.proposal_target_layer(rois, batch['gt_boxes3d'], xyz,
                                                      out['backbone_features'].detach(), seg,
                                                      depth, cfg, gen)
            out.update(tgt)
            out.update(model.rcnn(torch.cat([tgt['sampled_pts'], tgt['pts_feature']], -1),
                                  rec['bn_momentum'], gen))
            loss = ref_train.joint_loss(cfg, out, batch)
            loss.backward()
        del out
        g = opt.step()
        rec['loss'].append(loss.item())
        for key, v in (('rpn_cls', cls), ('rpn_reg', reg), ('xyz', xyz), ('rois', rois),
                       ('roi_scores', scores), ('seg', seg)):
            rec[key].append(v)
        if k == 0:
            rec['grad1'] = {n: x.detach().clone() for (n, _), x in zip(named, g)}
    rec['delta'] = {n: p.detach() - start[n] for n, p in named}
    return rec
