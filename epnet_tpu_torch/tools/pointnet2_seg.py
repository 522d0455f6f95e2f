"""The PointNet++ foreground-segmentation harness of the port.

    python -m epnet_tpu_torch.tools.pointnet2_seg --data_root <root> [--epochs 10]
        [--batch_size 4] [--lr 0.002] [--device cpu]

Counterpart of ``tools/pointnet2_seg.py`` (the reference's kernel-validation
mini-project, ``pointnet2_lib/tools/``: model ``pointnet2_msg.py:21``,
train/eval loop ``train_and_eval.py:63-131``): a KITTI foreground
segmentation trained and evaluated without the detector, which runs FPS
(kernel A on the card), ball query, grouping and FP interpolation end to
end at the RPN's widths (SURVEY.md §4.2). The config is ``Config()`` with
``RPN.USE_INTENSITY`` false: f32, exact queries, no LI-Fusion in the net.
The net is the RPN's ``SAModuleMSG`` and ``FPModule`` stages (BatchNorm on,
as the JAX harness builds them) and two Linear layers, ``Dense_0`` (128,
ReLU) and ``Dense_1`` (one logit a point), named as the flax modules are,
so ``bridge.flax_to_state_dict`` maps the JAX harness's variables onto it.
Each epoch trains on ``KittiRCNNDataset`` TRAIN through the shuffled
loader with the dice loss (``losses.dice_loss``, ``train_and_eval.py:
45-61``) and Adam at optax's defaults, BatchNorm in train mode, then
prints the mean loss and the mean over EVAL batches of the foreground IoU
of ``logit > 0`` (the last partial batch dropped, as the JAX loader drops
it). It runs on the CUDA device, and raises without one, unless
``--device`` names another. ``run(cfg, args)`` is the loop, which the tests
call at tiny widths.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import Config
from ..models.pointnet2 import FPModule, SAModuleMSG


class SegNet(nn.Module):
    """``forward(pts (B, N, 3+))`` returns one logit a point, (B, N)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        sa = cfg.RPN.SA_CONFIG
        level_ch = [0]
        for i in range(len(sa.NPOINTS)):
            mod = SAModuleMSG(sa.NPOINTS[i], sa.RADIUS[i], sa.NSAMPLE[i], sa.MLPS[i],
                              in_features=level_ch[i], device=device)
            self.add_module(f'sa{i}', mod)
            level_ch.append(mod.out_features)
        self.n_fp = len(cfg.RPN.FP_MLPS)
        for k in range(self.n_fp):
            known = cfg.RPN.FP_MLPS[k + 1][-1] if k + 1 < self.n_fp else level_ch[self.n_fp]
            self.add_module(f'fp{k}', FPModule(known + level_ch[k], cfg.RPN.FP_MLPS[k],
                                               device=device))
        self.Dense_0 = nn.Linear(cfg.RPN.FP_MLPS[0][-1], 128, device=device)
        self.Dense_1 = nn.Linear(128, 1, device=device)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        l_xyz, l_feats = [pts[..., 0:3]], [None]
        for i in range(self.n_fp):
            xyz, feats, _ = getattr(self, f'sa{i}')(l_xyz[i], l_feats[i])
            l_xyz.append(xyz)
            l_feats.append(feats)
        for i in range(-1, -(self.n_fp + 1), -1):
            l_feats[i - 1] = getattr(self, f'fp{self.n_fp + i}')(
                l_xyz[i - 1], l_xyz[i], l_feats[i - 1], l_feats[i])
        return self.Dense_1(torch.relu(self.Dense_0(l_feats[0])))[..., 0]


def build_model(cfg: Config, device=None, generator: Optional[torch.Generator] = None) -> SegNet:
    """The seg net on ``device`` (the CUDA device when None), initialized as
    the port's models are (``layers.init_parameters``)."""
    from ..models.epnet import default_device
    from ..models.layers import init_parameters

    model = SegNet(cfg, device=default_device(device))
    init_parameters(model, generator)
    return model


def seg_config() -> Config:
    """The harness's config: ``Config()``, points without intensity."""
    return Config().merged({'RPN': {'USE_INTENSITY': False}})


def adam(params, lr: float) -> torch.optim.Adam:
    """Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8, no decay)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def fg_iou(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The batch's foreground IoU of ``logits > 0`` against ``label > 0``."""
    pred, fg = logits > 0, label > 0
    inter = (pred & fg).sum()
    return inter / ((pred.sum() + fg.sum() - inter).clamp_min(1))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='PointNet++ foreground segmentation (PyTorch port)')
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--epochs', type=int, default=10)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--lr', type=float, default=0.002)
    p.add_argument('--device', type=str, default=None,
                   help='torch device; default the CUDA device (raises without one)')
    return p.parse_args(argv)


def run(cfg: Config, args: argparse.Namespace, workers: int = 4) -> Dict:
    """Train and evaluate ``args.epochs`` epochs; returns the model and, a
    list each, the epochs' mean loss, mean val IoU and seconds, and each
    train step's milliseconds (the loss read included)."""
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset
    from ..data.loader import eval_loader, train_loader
    from ..losses import dice_loss
    from ..models.epnet import default_device

    device = default_device(args.device)
    train_ds = KittiRCNNDataset(args.data_root, cfg, split='train', classes='Car', mode='TRAIN')
    val_ds = KittiRCNNDataset(args.data_root, cfg, split='val', classes='Car', mode='EVAL')
    loader = train_loader(train_ds, args.batch_size, workers)
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(0))
    opt = adam(model.parameters(), args.lr)
    out = {'model': model, 'loss': [], 'iou': [], 'seconds': [], 'steps_ms': []}
    try:
        for epoch in range(args.epochs):
            t0, losses = time.time(), []
            model.train()
            for batch in loader:
                ts = time.perf_counter()
                pts = torch.as_tensor(batch['pts_input'], device=device)
                label = torch.as_tensor(batch['rpn_cls_label'], device=device)
                loss = dice_loss(model(pts), label)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                out['steps_ms'].append((time.perf_counter() - ts) * 1e3)
            model.eval()
            val_ds.epoch = epoch + 1  # the JAX val loader's pass
            ious = []
            with torch.no_grad():
                for batch in eval_loader(val_ds, args.batch_size, workers, drop_last=True):
                    logits = model(torch.as_tensor(batch['pts_input'], device=device))
                    ious.append(float(fg_iou(logits, torch.as_tensor(batch['rpn_cls_label'],
                                                                     device=device))))
            out['loss'].append(float(np.mean(losses)))
            out['iou'].append(float(np.mean(ious)))
            out['seconds'].append(time.time() - t0)
            print(f'epoch {epoch}: loss {out["loss"][-1]:.4f} val fg-IoU {out["iou"][-1]:.4f} '
                  f'({out["seconds"][-1]:.1f}s)', flush=True)
    finally:
        loader.close()
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    return run(seg_config(), args)


if __name__ == '__main__':
    main()
