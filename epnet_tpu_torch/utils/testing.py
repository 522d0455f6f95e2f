"""Tiny configs, structured synthetic scenes and labelled train batches
(numpy only).

Carried over from ``epnet_tpu/utils/testing.py`` (``tiny_config``,
``structured_scene``, ``synthetic_batch``) and ``__graft_entry__.py``
(``full_batch``, its ``_full_batch(with_labels=True)``) so that the port
builds its test and smoke inputs without jax; ``tests/test_torch_config.py``
and ``tests/test_torch_train_step.py`` hold the copies to identical output.
The box tests come from ``epnet_tpu/data/box_np.py``, which is numpy-only
and is loaded by path (``epnet_tpu/__init__.py`` imports jax).
"""

import importlib.util
import pathlib
import sys

import numpy as np

from epnet_tpu_torch.config import Config

_BOX_NP = pathlib.Path(__file__).resolve().parents[2] / 'epnet_tpu' / 'data' / 'box_np.py'


def _box_np():
    name = 'epnet_tpu_torch._box_np'
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, _BOX_NP)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def tiny_config(li_fusion=True, rcnn=True, **over) -> Config:
    cfg = Config().merged({
        'CLS_MEAN_SIZE': ((1.52563191462, 1.62856739989, 3.88311640418),),
        'USE_IOU_BRANCH': False,
        'LI_FUSION': {
            'ENABLED': li_fusion,
            'ADD_Image_Attention': True,
            'IMG_FEATURES_CHANNEL': 32,
            'IMG_CHANNELS': (3, 8, 16, 24, 32),
            'POINT_CHANNELS': (24, 48, 96, 192),
            'DeConv_Reduce': (4, 4, 4, 4),
            'DeConv_Kernels': (2, 4, 8, 16),
            'DeConv_Strides': (2, 4, 8, 16),
        },
        'RPN': {
            'USE_INTENSITY': False,
            'LOC_XZ_FINE': True,
            'NUM_POINTS': 256,
            'LOSS_CLS': 'SigmoidFocalLoss',
            'SA_CONFIG': {
                'NPOINTS': (64, 32, 16, 8),
                'RADIUS': ((0.2, 1.0), (1.0, 2.0), (2.0, 4.0), (4.0, 8.0)),
                'NSAMPLE': ((8, 16), (8, 16), (8, 16), (8, 16)),
                'MLPS': (((8, 8, 12), (8, 8, 12)),
                         ((16, 16, 24), (16, 16, 24)),
                         ((24, 24, 48), (24, 24, 48)),
                         ((48, 48, 96), (48, 48, 96))),
            },
            'FP_MLPS': ((32, 32), (48, 48), (64, 64), (96, 96)),
            'CLS_FC': (32,),
            'REG_FC': (32,),
        },
        'RCNN': {
            'ENABLED': rcnn,
            'ROI_SAMPLE_JIT': True,
            'NUM_POINTS': 64,
            'POOL_EXTRA_WIDTH': 0.2,
            'ROI_PER_IMAGE': 16,
            'HARD_BG_RATIO': 0.8,
            'XYZ_UP_LAYER': (32, 32),
            'SA_CONFIG': {
                'NPOINTS': (32, 16, -1),
                'RADIUS': (0.2, 0.4, 100),
                'NSAMPLE': (16, 16, 16),
                'MLPS': ((32, 32, 32), (32, 32, 48), (48, 48, 64)),
            },
            'CLS_FC': (32, 32),
            'REG_FC': (32, 32),
        },
        'TRAIN': {
            'RPN_PRE_NMS_TOP_N': 128,
            'RPN_POST_NMS_TOP_N': 32,
            'RPN_NMS_THRESH': 0.85,
            'BBOX_AVG_BY_BIN': True,
            'IOU_LOSS_TYPE': 'cls_mask_with_bin',
        },
        'TEST': {
            'RPN_PRE_NMS_TOP_N': 128,
            'RPN_POST_NMS_TOP_N': 16,
            'RPN_NMS_THRESH': 0.8,
        },
    })
    if over:
        cfg = cfg.merged(over)
    return cfg


def structured_scene(rng, n_points, n_cars=8, img_hw=(384, 1280),
                     z_range=(1.5, 69.0), car_z_range=(6.0, 60.0)):
    """KITTI-like structured cloud: ground plane + car-surface clusters +
    wall/pole clutter, with LiDAR-style 1/z density falloff and a consistent
    pinhole projection for the image stream. Rect-camera frame: x right,
    y down (ground at y≈1.65), z forward.

    Returns (pts (N,3) f32, pts_xy (N,2) f32 image coords, gt (n_cars,7)).
    """
    H, W = img_hw
    fx = fy = 0.5625 * W  # KITTI-ish focal (720 px at W=1280), scale-free
    cx, cy = W / 2.0, H / 2.0 - H / 32.0

    def inv_z(n, lo=z_range[0], hi=z_range[1]):
        # p(z) ~ 1/z  (LiDAR rings thin out with range)
        u = rng.rand(n)
        return lo * (hi / lo) ** u

    n_ground = int(n_points * 0.50)
    n_car = int(n_points * 0.30)
    n_clutter = n_points - n_ground - n_car

    # ground plane with mild undulation
    zg = inv_z(n_ground)
    xg = rng.uniform(-0.45, 0.45, n_ground) * zg  # stay in the camera frustum
    yg = 1.65 + 0.03 * np.sin(zg) + rng.randn(n_ground) * 0.02
    ground = np.stack([xg, yg, zg], axis=-1)

    # cars: points on the surfaces of oriented boxes
    gt = np.zeros((n_cars, 7), np.float32)
    gt[:, 2] = np.sort(inv_z(n_cars, *car_z_range))          # z
    gt[:, 0] = rng.uniform(-0.35, 0.35, n_cars) * gt[:, 2]   # x
    gt[:, 1] = 1.65                                          # y (bottom)
    gt[:, 3] = rng.uniform(1.4, 1.7, n_cars)                 # h
    gt[:, 4] = rng.uniform(1.5, 1.7, n_cars)                 # w
    gt[:, 5] = rng.uniform(3.5, 4.2, n_cars)                 # l
    gt[:, 6] = rng.uniform(-np.pi, np.pi, n_cars)
    # nearer cars get more returns
    w_car = 1.0 / gt[:, 2]
    counts = rng.multinomial(n_car, w_car / w_car.sum())
    car_pts = []
    for g, cnt in zip(gt, counts):
        if cnt == 0:
            continue
        face = rng.randint(0, 3, cnt)  # 0: side, 1: front/back, 2: roof
        u, v = rng.rand(cnt) - 0.5, rng.rand(cnt) - 0.5
        lx = np.where(face == 1, np.sign(u) * 0.5, u) * g[5]
        lz = np.where(face == 0, np.sign(v) * 0.5, v) * g[4]
        ly = np.where(face == 2, -1.0, -rng.rand(cnt)) * g[3]
        c, s = np.cos(g[6]), np.sin(g[6])
        px = c * lx + s * lz + g[0]
        pz = -s * lx + c * lz + g[2]
        py = ly + g[1]
        car_pts.append(np.stack([px, py, pz], axis=-1)
                       + rng.randn(cnt, 3) * 0.015)
    cars = np.concatenate(car_pts, axis=0) if car_pts else np.zeros((0, 3))
    pad = n_car - len(cars)
    if pad > 0:
        cars = np.concatenate([cars, ground[:pad]], axis=0)

    # clutter: vertical poles/walls at the frustum edges
    zc = inv_z(n_clutter, min(3.0, z_range[1] / 2), z_range[1])
    side = np.sign(rng.randn(n_clutter))
    xc = side * (0.40 + 0.05 * rng.rand(n_clutter)) * zc
    yc = 1.65 - rng.rand(n_clutter) * 3.0
    clutter = np.stack([xc, yc, zc], axis=-1)

    pts = np.concatenate([ground, cars, clutter], axis=0).astype(np.float32)
    rng.shuffle(pts)  # the loader feeds shuffled clouds

    u = fx * pts[:, 0] / pts[:, 2] + cx
    v = fy * pts[:, 1] / pts[:, 2] + cy
    pts_xy = np.stack([np.clip(u, 0, W - 1), np.clip(v, 0, H - 1)],
                      axis=-1).astype(np.float32)
    return pts, pts_xy, gt


IMG_H, IMG_W = 32, 64


def synthetic_batch(rng, cfg, batch=2, with_gt=True, structured=False):
    """Random scene at ``tiny_config`` sizes: points in front of a camera,
    three gt cars, per-point cls/reg labels. ``structured=True`` puts
    points on the gt car surfaces (``structured_scene``)."""
    N = cfg.RPN.NUM_POINTS
    G = 3
    if structured:
        pts_l, xy_l, gt_l = [], [], []
        for _ in range(batch):
            p, u, g = structured_scene(rng, N, n_cars=G, img_hw=(IMG_H, IMG_W),
                                       z_range=(1.5, 25.0), car_z_range=(5.0, 16.0))
            pts_l.append(p)
            xy_l.append(u)
            gt_l.append(g)
        pts = np.stack(pts_l, axis=0)
        gt = np.stack(gt_l, axis=0)
        out = {'pts_input': pts,
               'img': rng.rand(batch, IMG_H, IMG_W, 3).astype(np.float32),
               'pts_origin_xy': np.stack(xy_l, axis=0)}
        if with_gt:
            out['gt_boxes3d'] = gt
    else:
        pts = np.stack([rng.uniform(-20, 20, (batch, N)), rng.uniform(-1, 2, (batch, N)),
                        rng.uniform(1, 69, (batch, N))], axis=-1).astype(np.float32)
        out = {'pts_input': pts,
               'img': rng.rand(batch, IMG_H, IMG_W, 3).astype(np.float32),
               'pts_origin_xy': np.stack([rng.uniform(0, 1279, (batch, N)),
                                          rng.uniform(0, 383, (batch, N))],
                                         axis=-1).astype(np.float32)}
        if with_gt:
            gt = np.stack([rng.uniform(-15, 15, (batch, G)), rng.uniform(0.8, 1.6, (batch, G)),
                           rng.uniform(5, 60, (batch, G)), rng.uniform(1.4, 1.7, (batch, G)),
                           rng.uniform(1.5, 1.7, (batch, G)), rng.uniform(3.5, 4.2, (batch, G)),
                           rng.uniform(-np.pi, np.pi, (batch, G))], axis=-1).astype(np.float32)
            out['gt_boxes3d'] = gt
    if with_gt:
        # fg if inside any gt; reg label: offsets to that gt's vertical center
        box_np = _box_np()
        inb = np.stack([np.stack([box_np.points_in_box3d(pts[b], g) for g in gt[b]])
                        for b in range(batch)], axis=0)  # (B, G, N)
        out['rpn_cls_label'] = inb.any(axis=1).astype(np.int32)
        gsel = np.take_along_axis(gt, inb.argmax(axis=1)[..., None], axis=1)  # (B, N, 7)
        reg = gsel.copy()
        reg[..., 1] -= reg[..., 3] / 2
        reg[..., 0:3] -= pts
        out['rpn_reg_label'] = reg.astype(np.float32)
    return out


def full_batch(cfg, batch_size=1, seed=0, with_labels=False):
    """Structured KITTI-like scenes at the recipe's full shapes (16384
    points, a 384x1280 image, 8 cars). ``with_labels=True`` adds the train
    tensors: gt boxes zero-padded to a 20-box budget, per-point cls labels
    (1 inside a gt, -1 in the 0.2 m ring around it, 0 elsewhere) and reg
    labels (offsets to the gt's vertical center, and its size and angle)."""
    rng = np.random.RandomState(seed)
    N = cfg.RPN.NUM_POINTS
    pts, xy, gts = [], [], []
    for _ in range(batch_size):
        p, u, g = structured_scene(rng, N, n_cars=8, img_hw=(384, 1280))
        pts.append(p)
        xy.append(u)
        gts.append(g)
    batch = {'pts_input': np.stack(pts, axis=0),
             'img': rng.rand(batch_size, 384, 1280, 3).astype(np.float32),
             'pts_origin_xy': np.stack(xy, axis=0)}
    if with_labels:
        box_np = _box_np()
        G = 20
        gt_pad = np.zeros((batch_size, G, 7), np.float32)
        cls_l = np.zeros((batch_size, N), np.int32)
        reg_l = np.zeros((batch_size, N, 7), np.float32)
        for b, g in enumerate(gts):
            gt_pad[b, :g.shape[0]] = g
            p = pts[b][:, :3]
            ext = box_np.enlarge_box3d(g, extra_width=0.2)
            for k in range(g.shape[0]):
                fg = box_np.points_in_box3d(p, g[k])
                cls_l[b][fg] = 1
                cls_l[b][np.logical_xor(fg, box_np.points_in_box3d(p, ext[k]))] = -1
                center = g[k][0:3].copy()
                center[1] -= g[k][3] / 2
                reg_l[b][fg, 0:3] = center - p[fg]
                reg_l[b][fg, 3:7] = g[k][3:7]
        batch.update(gt_boxes3d=gt_pad, rpn_cls_label=cls_l, rpn_reg_label=reg_l)
    return batch
