"""The benchmark's scenes: KITTI-like structured clouds, their images and
their labels, made from a seed.

A frozen copy of the port's ``utils/testing.structured_scene`` and of the
labels of its ``full_batch(with_labels=True)`` (gt boxes zero-padded to 20,
per-point cls labels with the 0.2 m ignore ring, reg labels), so that the
yardstick does not move when the program's test helpers do. Three changes:
a configuration with ``RPN.USE_INTENSITY`` gets a fourth point channel,
an intensity drawn uniformly from [0, 1); the images are drawn on the
device from a ``torch.Generator`` instead of on the host; and a traffic
mix's scenes are one pool that every run deals in its own order.
"""

from __future__ import annotations

import numpy as np
import torch

IMG_HW = (384, 1280)
N_CARS = 8
GT_BUDGET = 20


def structured_scene(rng, n_points, n_cars=N_CARS, img_hw=IMG_HW,
                     z_range=(1.5, 69.0), car_z_range=(6.0, 60.0)):
    """Ground plane + car-surface clusters + wall/pole clutter with a
    LiDAR-like 1/z density, projected by a pinhole camera. Rect-camera
    frame: x right, y down (ground at y = 1.65), z forward.

    Returns (pts (N, 3) f32, pts_xy (N, 2) f32 image coordinates,
    gt (n_cars, 7))."""
    H, W = img_hw
    fx = fy = 0.5625 * W
    cx, cy = W / 2.0, H / 2.0 - H / 32.0

    def inv_z(n, lo=z_range[0], hi=z_range[1]):
        return lo * (hi / lo) ** rng.rand(n)

    n_ground = int(n_points * 0.50)
    n_car = int(n_points * 0.30)
    n_clutter = n_points - n_ground - n_car

    zg = inv_z(n_ground)
    xg = rng.uniform(-0.45, 0.45, n_ground) * zg
    yg = 1.65 + 0.03 * np.sin(zg) + rng.randn(n_ground) * 0.02
    ground = np.stack([xg, yg, zg], axis=-1)

    gt = np.zeros((n_cars, 7), np.float32)
    gt[:, 2] = np.sort(inv_z(n_cars, *car_z_range))
    gt[:, 0] = rng.uniform(-0.35, 0.35, n_cars) * gt[:, 2]
    gt[:, 1] = 1.65
    gt[:, 3] = rng.uniform(1.4, 1.7, n_cars)
    gt[:, 4] = rng.uniform(1.5, 1.7, n_cars)
    gt[:, 5] = rng.uniform(3.5, 4.2, n_cars)
    gt[:, 6] = rng.uniform(-np.pi, np.pi, n_cars)
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
        car_pts.append(np.stack([px, py, pz], axis=-1) + rng.randn(cnt, 3) * 0.015)
    cars = np.concatenate(car_pts, axis=0) if car_pts else np.zeros((0, 3))
    pad = n_car - len(cars)
    if pad > 0:
        cars = np.concatenate([cars, ground[:pad]], axis=0)

    zc = inv_z(n_clutter, min(3.0, z_range[1] / 2), z_range[1])
    side = np.sign(rng.randn(n_clutter))
    xc = side * (0.40 + 0.05 * rng.rand(n_clutter)) * zc
    yc = 1.65 - rng.rand(n_clutter) * 3.0
    clutter = np.stack([xc, yc, zc], axis=-1)

    pts = np.concatenate([ground, cars, clutter], axis=0).astype(np.float32)
    rng.shuffle(pts)

    u = fx * pts[:, 0] / pts[:, 2] + cx
    v = fy * pts[:, 1] / pts[:, 2] + cy
    pts_xy = np.stack([np.clip(u, 0, W - 1), np.clip(v, 0, H - 1)], axis=-1).astype(np.float32)
    return pts, pts_xy, gt


def _in_box(pts, box):
    cx, cy, cz, h, w, l, ry = box
    px, py, pz = pts[:, 0] - cx, pts[:, 1] - cy, pts[:, 2] - cz
    c, s = np.cos(ry), np.sin(ry)
    return ((np.abs(py + h / 2.0) <= h / 2.0) & (np.abs(px * c - pz * s) <= l / 2.0)
            & (np.abs(px * s + pz * c) <= w / 2.0))


def labels(pts, gts):
    """Train labels of one batch: gt boxes zero-padded to ``GT_BUDGET``,
    per-point cls labels (1 inside a gt, -1 in the 0.2 m ring around it, 0
    elsewhere) and reg labels (offsets to the gt's vertical centre, its
    size and angle)."""
    B, N = len(pts), pts[0].shape[0]
    gt_pad = np.zeros((B, GT_BUDGET, 7), np.float32)
    cls_l = np.zeros((B, N), np.int32)
    reg_l = np.zeros((B, N, 7), np.float32)
    for b, g in enumerate(gts):
        gt_pad[b, :g.shape[0]] = g
        p = pts[b][:, :3]
        for k in range(g.shape[0]):
            fg = _in_box(p, g[k])
            ext = g[k].copy()
            ext[3:6] += 0.4
            ext[1] += 0.2
            cls_l[b][fg] = 1
            cls_l[b][np.logical_xor(fg, _in_box(p, ext))] = -1
            center = g[k][0:3].copy()
            center[1] -= g[k][3] / 2
            reg_l[b][fg, 0:3] = center - p[fg]
            reg_l[b][fg, 3:7] = g[k][3:7]
    return gt_pad, cls_l, reg_l


def make_batches(cfg_tree: dict, batch: int, count: int, scenes_seed: int, order_seed: int,
                 device, with_labels: bool = False, img_hw=IMG_HW):
    """``count`` distinct batches of ``batch`` scenes each, on ``device``:
    ``pts_input`` (B, N, 3 or 4), ``img`` (B, H, W, 3), ``pts_origin_xy``
    (B, N, 2), and with ``with_labels`` ``gt_boxes3d``, ``rpn_cls_label``,
    ``rpn_reg_label``. The ``count * batch`` scenes are the pool of
    ``scenes_seed`` (the traffic's); ``order_seed`` (the run's) deals them
    into the batches in an order of its own, so every run sees the same
    scenes."""
    ss = np.random.SeedSequence(scenes_seed)
    pts_seed, img_seed = ss.generate_state(2)
    rng = np.random.RandomState(np.random.MT19937(int(pts_seed)))
    gen = torch.Generator(device=device).manual_seed(int(img_seed))
    n = cfg_tree['RPN']['NUM_POINTS']
    total = count * batch
    pool = []
    for _ in range(total):
        p, u, g = structured_scene(rng, n, img_hw=img_hw)
        if cfg_tree['RPN']['USE_INTENSITY']:
            p = np.concatenate([p, rng.rand(n, 1).astype(np.float32)], -1)
        pool.append((p, u, g))
    imgs = torch.rand((total, *img_hw, 3), generator=gen, device=device)
    order = np.random.default_rng(np.random.SeedSequence(order_seed)).permutation(total)
    out = []
    for k in range(count):
        idx = order[k * batch:(k + 1) * batch]
        pts = [pool[i][0] for i in idx]
        b = {'pts_input': torch.from_numpy(np.stack(pts)).to(device),
             'img': imgs[torch.as_tensor(idx, device=device)],
             'pts_origin_xy': torch.from_numpy(np.stack([pool[i][1] for i in idx])).to(device)}
        if with_labels:
            gt, cls_l, reg_l = labels(pts, [pool[i][2] for i in idx])
            b.update(gt_boxes3d=torch.from_numpy(gt).to(device),
                     rpn_cls_label=torch.from_numpy(cls_l).to(device),
                     rpn_reg_label=torch.from_numpy(reg_l).to(device))
        out.append(b)
    return out
