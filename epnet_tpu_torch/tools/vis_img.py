"""The fusion projection check of the port.

    python -m epnet_tpu_torch.tools.vis_img --data_root <root> [--sample_id 0]
        [--out output/vis]

Counterpart of ``tools/vis_img.py`` (reference ``tools/vis_img.py:85-165``):
projects one frame's LiDAR points onto its image, samples the normalized
image bilinearly at each in-image point (``interpolate_img_by_xy``, the
projection and sampling LI-Fusion relies on), prints the in-image point
count and the mean |interpolated - nearest pixel|, and writes the sampled
colours painted on a blank canvas and the image itself, un-normalized, as
``<out>/<id>_points.png`` and ``<out>/<id>_image.png``. The PNGs are
written by the port's own encoder (``data/png.py``), not PIL. It runs on
the host alone. ``main(argv)`` returns the statistics.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import Config
from ..data import png
from ..data.kitti_dataset import PAD_H, PAD_W
from ..data.kitti_rcnn_dataset import KittiRCNNDataset, interpolate_img_by_xy


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='LiDAR-to-image projection check (PyTorch port)')
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--sample_id', type=int, default=0)
    p.add_argument('--out', type=str, default='output/vis')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    ds = KittiRCNNDataset(args.data_root, Config(), split='train', classes='Car', mode='EVAL')
    sid = args.sample_id
    calib = ds.get_calib(sid)
    img = ds.get_image_rgb_with_normal(sid)
    pts_rect = calib.lidar_to_rect(ds.get_lidar(sid)[:, 0:3])
    pts_img, depth = calib.rect_to_img(pts_rect)
    valid = ds.get_valid_flag(pts_rect, pts_img, depth, ds.get_image_shape(sid))
    pts_img = pts_img[valid]

    interp = interpolate_img_by_xy(img, pts_img, np.array([PAD_H, PAD_W], np.float64))
    ys = np.clip(pts_img[:, 1].astype(int), 0, PAD_H - 1)
    xs = np.clip(pts_img[:, 0].astype(int), 0, PAD_W - 1)
    err = np.abs(interp - img[ys, xs]).mean()
    print(f'sample {sid}: {valid.sum()} in-image points, '
          f'mean |interp - nearest-pixel| = {err:.4f} (should be small)')

    os.makedirs(args.out, exist_ok=True)
    canvas = np.zeros((PAD_H, PAD_W, 3), np.float32)
    canvas[ys, xs] = interp
    mean = np.array([0.485, 0.456, 0.406])  # f64, as the JAX tool un-normalizes
    std = np.array([0.229, 0.224, 0.225])
    paths = {}
    for name, arr in (('points', canvas), ('image', img)):
        viz = np.clip((arr * std + mean) * 255, 0, 255).astype(np.uint8)
        paths[name] = os.path.join(args.out, f'{sid:06d}_{name}.png')
        png.write_png(paths[name], viz)
    print(f'wrote visualizations to {args.out}')
    return {'in_image': int(valid.sum()), 'mean_abs_err': float(err), 'paths': paths}


if __name__ == '__main__':
    main()
