"""Tiny configs and structured synthetic scenes (numpy only).

Carried over from ``epnet_tpu/utils/testing.py`` so that the port can build
its test and smoke inputs without jax; ``tests/test_torch_config.py`` holds
both copies to byte-identical output.
"""

import numpy as np

from epnet_tpu_torch.config import Config


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
