"""Tiny configs, structured synthetic scenes, labelled train batches and
a synthetic on-disk KITTI tree (numpy only).

Carried over from ``epnet_tpu/utils/testing.py`` (``tiny_config``,
``structured_scene``, ``synthetic_batch``, ``make_fake_kitti``) and
``__graft_entry__.py`` (``full_batch``, its ``_full_batch(with_labels=True)``)
so that the port builds its test and smoke inputs without jax;
``tests/test_torch_config.py``, ``tests/test_torch_train_step.py`` and
``tests/test_torch_data.py`` hold the copies to identical output. The box
tests are the port's own ``utils/box_np.py``; the images are written by
``data/png.py``.
"""

import os

import numpy as np

from epnet_tpu_torch.config import Config
from epnet_tpu_torch.ops.morton import morton_argsort_np
from epnet_tpu_torch.utils import box_np


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


def proposal_inputs(cfg, seed, device, batch=2, n_points=16384, ties=False):
    """RPN-like outputs over ``batch`` structured scenes of ``n_points``, the
    ``ProposalLayer``'s inputs on ``device``: logits (B, N), regression
    (B, N, C) and points (B, N, 3); ``ties`` rounds the logits to a grid of
    1/4, so that many scores tie."""
    import torch

    rng = np.random.RandomState(seed)
    xyz = np.stack([structured_scene(rng, n_points)[0] for _ in range(batch)])
    logits = rng.normal(0, 2, (batch, n_points)).astype(np.float32)
    if ties:
        logits = np.round(logits * 4) / 4
    reg = rng.normal(0, 1, (batch, n_points, cfg.RPN.reg_channel)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (logits, reg, xyz)]


def proposal_nms_calls(cfg, mode, inputs):
    """The arguments ``(args, kwargs)`` of every ``nms_bev`` call that a
    ``mode`` ``ProposalLayer`` makes on ``inputs``, in order, and the layer's
    output with the plain loop (``nms_bev_plain``) in each call."""
    from epnet_tpu_torch.models import proposal
    from epnet_tpu_torch.ops import nms

    calls = []

    def plain(*args, **kw):
        calls.append((args, kw))
        return nms.nms_bev_plain(*args, **kw)

    real = proposal.nms_bev
    proposal.nms_bev = plain
    try:
        out = proposal.ProposalLayer(cfg, mode)(*inputs)
    finally:
        proposal.nms_bev = real
    return calls, out


# The block-local configuration at test widths (``EXACT_QUERIES`` 'residual',
# both BLOCK_LOCAL flags), each size the least that engages its gate: RPN sa0
# groups block-locally (2048 > 1024 points, 512 centroids in blocks of 64, a
# window of 256), fp0 interpolates in windows (512 knowns cover more than
# one window), and RCNN sa0 runs the windowed fused kernel (128 pooled
# points, windows of 64 for tiles of 8 centroids, 16 samples).
BLOCK_LOCAL_TINY = {
    'EXACT_QUERIES': 'residual',
    'RPN': {'NUM_POINTS': 2048, 'BLOCK_LOCAL': True, 'BLOCK_WINDOW': 256, 'BLOCK_C': 64,
            'SA_CONFIG': {'NPOINTS': (512, 128, 32, 8)}},
    'RCNN': {'BLOCK_LOCAL': True, 'NUM_POINTS': 128, 'BLOCK_WINDOW': 64, 'BLOCK_C': 8},
}

# The bf16 eval forward at test widths (``MIXED_PRECISION`` with exact
# queries): ``EPNet(tiny_config(**MIXED_TINY), 'TEST', device='cpu')``. The
# RCNN's fused stages (no BN, three layers) take B-bf16's function there.
MIXED_TINY = {'EXACT_QUERIES': True, 'MIXED_PRECISION': True}
# The bf16 eval forward in the block-local configuration: the RCNN's
# windowed stage takes G-bf16's function.
MIXED_BLOCK_LOCAL_TINY = {**BLOCK_LOCAL_TINY, 'MIXED_PRECISION': True}
# The bf16 train step at test widths, exact and block-local:
# ``EPNet(tiny_config(**MIXED_TRAIN_TINY), 'TRAIN', device='cpu')``; the
# RPN's dropout off (the parity tests draw no masks) and the recipe's
# optimizer. Its RCNN's fused stages take C-bf16's function in the
# backward (H-bf16's at the windowed stage), and the tower D-bf16's and
# E-bf16's: its first block's 12 channels put every stride-1 conv but the
# RGB stem on ``conv3x3_same`` (more than 8 input channels).
_TRAIN = {'RPN': {'DP_RATIO': 0.0}, 'TRAIN': {'OPTIMIZER': 'adam_onecycle'},
          'LI_FUSION': {'IMG_CHANNELS': (3, 12, 16, 24, 32)}}
MIXED_TRAIN_TINY = {**MIXED_TINY, **_TRAIN}
MIXED_BLOCK_LOCAL_TRAIN_TINY = {**MIXED_BLOCK_LOCAL_TINY, **_TRAIN,
                                'RPN': {**BLOCK_LOCAL_TINY['RPN'], **_TRAIN['RPN']}}

IMG_H, IMG_W = 32, 64


def synthetic_batch(rng, cfg, batch=2, with_gt=True, structured=False):
    """Random scene at ``tiny_config`` sizes: points in front of a camera,
    three gt cars, per-point cls/reg labels. ``structured=True`` puts
    points on the gt car surfaces (``structured_scene``). Under
    ``RPN.BLOCK_LOCAL`` the points and their labels are Morton-sorted."""
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
        inb = np.stack([np.stack([box_np.points_in_box3d(pts[b], g) for g in gt[b]])
                        for b in range(batch)], axis=0)  # (B, G, N)
        out['rpn_cls_label'] = inb.any(axis=1).astype(np.int32)
        gsel = np.take_along_axis(gt, inb.argmax(axis=1)[..., None], axis=1)  # (B, N, 7)
        reg = gsel.copy()
        reg[..., 1] -= reg[..., 3] / 2
        reg[..., 0:3] -= pts
        out['rpn_reg_label'] = reg.astype(np.float32)
    if cfg.RPN.BLOCK_LOCAL:
        # the loader's Morton sort (data/kitti_rcnn_dataset._maybe_morton_sort)
        for b in range(batch):
            perm = morton_argsort_np(out['pts_input'][b, :, :3])
            for k in ('pts_input', 'pts_origin_xy', 'rpn_cls_label', 'rpn_reg_label'):
                if k in out:
                    out[k][b] = out[k][b][perm]
    return out


def full_batch(cfg, batch_size=1, seed=0, with_labels=False):
    """Structured KITTI-like scenes at the recipe's full shapes (16384
    points, a 384x1280 image, 8 cars), Morton-sorted under
    ``RPN.BLOCK_LOCAL`` or ``RPN.FP_WINDOW > 0``. ``with_labels=True`` adds the train
    tensors: gt boxes zero-padded to a 20-box budget, per-point cls labels
    (1 inside a gt, -1 in the 0.2 m ring around it, 0 elsewhere) and reg
    labels (offsets to the gt's vertical center, and its size and angle)."""
    rng = np.random.RandomState(seed)
    N = cfg.RPN.NUM_POINTS
    pts, xy, gts = [], [], []
    for _ in range(batch_size):
        p, u, g = structured_scene(rng, N, n_cars=8, img_hw=(384, 1280))
        if cfg.RPN.BLOCK_LOCAL or cfg.RPN.FP_WINDOW > 0:  # the loader's Morton sort
            perm = morton_argsort_np(p[:, :3])
            p, u = p[perm], u[perm]
        pts.append(p)
        xy.append(u)
        gts.append(g)
    batch = {'pts_input': np.stack(pts, axis=0),
             'img': rng.rand(batch_size, 384, 1280, 3).astype(np.float32),
             'pts_origin_xy': np.stack(xy, axis=0)}
    if with_labels:
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


# rect = TR @ lidar: x_r = -y_l, y_r = -z_l, z_r = x_l
_TR_VELO2CAM = np.array([[0, -1, 0, 0],
                         [0, 0, -1, 0],
                         [1, 0, 0, 0]], np.float32)


def make_fake_kitti(root, n_samples=4, split='train', img_hw=(370, 1240),
                    n_points=6000, seed=0, n_val=0, max_cars=3):
    """A minimal KITTI object tree of synthetic scenes: ground points and
    1 to ``max_cars`` cars with points on them, random RGB images, calib,
    labels and road planes; the same files as the JAX package's
    ``make_fake_kitti`` for the same arguments (its images are written with
    PIL, so theirs match these pixel for pixel, not byte for byte).

    With ``n_val=0`` ``val.txt`` lists the train ids; with ``n_val > 0``
    ``n_val`` extra scenes are made and ``val.txt`` lists only those."""
    from epnet_tpu_torch.data import png

    rng = np.random.RandomState(seed)
    h, w = img_hw
    obj_dir = os.path.join(root, 'KITTI', 'object', 'training')
    for sub in ('velodyne', 'image_2', 'calib', 'label_2', 'planes'):
        os.makedirs(os.path.join(obj_dir, sub), exist_ok=True)
    os.makedirs(os.path.join(root, 'KITTI', 'ImageSets'), exist_ok=True)

    f, cu, cv = 700.0, w / 2.0, h / 2.0
    P2 = np.array([[f, 0, cu, 44.8], [0, f, cv, 0.1], [0, 0, 1, 0.003]], np.float32)

    ids = []
    for sid in range(n_samples + n_val):
        ids.append('%06d' % sid)
        # ground points + a couple of cars in the frustum
        z = rng.uniform(4, 60, n_points)
        x = rng.uniform(-0.7, 0.7, n_points) * z * (cu / f)
        y = rng.uniform(1.4, 1.7, n_points)  # ground plane ~1.55 below cam
        pts_rect = np.stack([x, y, z], 1)

        boxes = []
        for _ in range(rng.randint(1, max_cars + 1)):
            bz = rng.uniform(8, 45)
            bx = rng.uniform(-0.4, 0.4) * bz * (cu / f)
            ry = rng.uniform(-np.pi, np.pi)
            hh, ww, ll = (rng.uniform(1.4, 1.7), rng.uniform(1.5, 1.7),
                          rng.uniform(3.5, 4.3))
            boxes.append([bx, 1.55, bz, hh, ww, ll, ry])
            # add points on the car
            npts = 300
            local = np.stack([
                rng.uniform(-ll / 2, ll / 2, npts),
                rng.uniform(-hh, 0, npts),
                rng.uniform(-ww / 2, ww / 2, npts)], 1)
            c, s = np.cos(ry), np.sin(ry)
            gx = c * local[:, 0] + s * local[:, 2] + bx
            gz = -s * local[:, 0] + c * local[:, 2] + bz
            gy = local[:, 1] + 1.55
            pts_rect = np.concatenate([pts_rect, np.stack([gx, gy, gz], 1)], 0)

        # rect -> lidar: the inverse of the orthonormal TR is its transpose
        pts_lidar = pts_rect @ _TR_VELO2CAM[:, :3]
        intensity = rng.rand(len(pts_lidar), 1).astype(np.float32)
        np.concatenate([pts_lidar.astype(np.float32), intensity], 1).tofile(
            os.path.join(obj_dir, 'velodyne', f'{ids[-1]}.bin'))

        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        png.write_png(os.path.join(obj_dir, 'image_2', f'{ids[-1]}.png'), img)

        with open(os.path.join(obj_dir, 'calib', f'{ids[-1]}.txt'), 'w') as fo:
            fo.write('P0: ' + ' '.join('%.6e' % v for v in P2.reshape(-1)) + '\n')
            fo.write('P1: ' + ' '.join('%.6e' % v for v in P2.reshape(-1)) + '\n')
            fo.write('P2: ' + ' '.join('%.6e' % v for v in P2.reshape(-1)) + '\n')
            fo.write('P3: ' + ' '.join('%.6e' % v for v in P2.reshape(-1)) + '\n')
            fo.write('R0_rect: ' + ' '.join('%.6e' % v for v in np.eye(3).reshape(-1)) + '\n')
            fo.write('Tr_velo_to_cam: '
                     + ' '.join('%.6e' % v for v in _TR_VELO2CAM.reshape(-1)) + '\n')
            fo.write('Tr_imu_to_velo: '
                     + ' '.join('%.6e' % v for v in _TR_VELO2CAM.reshape(-1)) + '\n')

        with open(os.path.join(obj_dir, 'label_2', f'{ids[-1]}.txt'), 'w') as fo:
            for bx, by, bz, hh, ww, ll, ry in boxes:
                beta = np.arctan2(bz, bx)
                alpha = -np.sign(beta) * np.pi / 2 + beta + ry
                u = f * bx / bz + cu
                v = f * by / bz + cv
                x1, y1 = max(u - 60, 0), max(v - 50, 0)
                x2, y2 = min(u + 60, w - 1), min(v + 5, h - 1)
                fo.write(f'Car 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} '
                         f'{hh:.2f} {ww:.2f} {ll:.2f} {bx:.2f} {by:.2f} {bz:.2f} {ry:.2f}\n')

        with open(os.path.join(obj_dir, 'planes', f'{ids[-1]}.txt'), 'w') as fo:
            fo.write('# Plane\nWidth 4\nHeight 1\n0 -1 0 1.55\n')

    train_ids = ids[:n_samples]
    val_ids = ids[n_samples:] if n_val else ids
    with open(os.path.join(root, 'KITTI', 'ImageSets', split + '.txt'), 'w') as fo:
        fo.write('\n'.join(train_ids) + '\n')
    with open(os.path.join(root, 'KITTI', 'ImageSets', 'val.txt'), 'w') as fo:
        fo.write('\n'.join(val_ids) + '\n')
    return root


# ---------------------------------------------------------------------------
# holding one train step against another (data parallelism's tests and
# chip_smoke.py's phase 28)
# ---------------------------------------------------------------------------

def _f64(tree):
    return {k: np.asarray(v.detach().cpu() if hasattr(v, 'detach') else v, np.float64)
            for k, v in tree.items()}


def leaf_errors(ref, got):
    """Each leaf's max error over its scale, max(its max, 1e-2 x the global
    max), and the scales."""
    ref, got = _f64(ref), _f64(got)
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    scale = {k: max(float(np.abs(ref[k]).max()), 1e-2 * gmax) for k in ref}
    return {k: float(np.abs(got[k] - ref[k]).max()) / scale[k] for k in ref}, scale


def check_gradients(ref, got, tol, backbone_norm, where='gradients'):
    """Every leaf within ``tol(name)`` of its scale (``leaf_errors``) and the
    RPN backbone's gradient within ``backbone_norm`` of its norm; returns
    the worst leaf's error over its tolerance. Raises ``AssertionError``."""
    if set(ref) != set(got):
        raise AssertionError(f'{where}: leaves differ: {sorted(set(ref) ^ set(got))[:5]}')
    errs, _ = leaf_errors(ref, got)
    bad = {k: e for k, e in errs.items() if not e <= tol(k)}
    if bad:
        raise AssertionError(f'{where}: leaves beyond their tolerance: {bad}')
    ref, got = _f64(ref), _f64(got)
    keys = [k for k in ref if k.startswith('rpn.backbone.')]
    norm = np.sqrt(sum((ref[k] ** 2).sum() for k in keys))
    diff = np.sqrt(sum(((got[k] - ref[k]) ** 2).sum() for k in keys))
    if not diff <= backbone_norm * norm:
        raise AssertionError(f'{where}: the backbone off by {diff:.3e} of norm {norm:.3e}')
    return max(e / tol(k) for k, e in errs.items())


def check_adam_step(before, ref, got, grads, lr, tol, where='parameters'):
    """Parameters after one Adam(W) step from ``before``, the reference
    ``ref`` and ``got``: the first step moves an element by about ``lr *
    sign(g)``, so where the reference gradient ``grads`` lies beyond its
    tolerance of 0 (``tol(name)`` of the leaf's scale, as
    ``check_gradients``) the update's sign is sure and the two must agree
    within 1e-3 lr, and the reference must have moved; elsewhere the
    other run may have moved the other way, within 2 lr (1 + 1e-3). Returns
    the share of elements whose sign is not sure. Raises ``AssertionError``."""
    _, scale = leaf_errors(grads, grads)
    grads, before, ref, got = _f64(grads), _f64(before), _f64(ref), _f64(got)
    unsure = total = 0
    for k, g in grads.items():
        sure = np.abs(g) > tol(k) * scale[k]
        d = np.abs(got[k] - ref[k])
        moved = np.abs(ref[k] - before[k])
        if d[sure].max(initial=0.0) > 1e-3 * lr or d.max() > 2 * lr * (1 + 1e-3) \
                or not (moved[sure] > 0).all():
            raise AssertionError(f'{where}: {k} off by {d[sure].max(initial=0.0) / lr:.3e} lr '
                                 f'where the sign is sure, {d.max() / lr:.3e} lr anywhere')
        unsure += int((~sure).sum())
        total += sure.size
    return unsure / total
