"""Plain PyTorch point, image and box operations of the reference model.

Frozen copies of the plain arithmetic that the EPNet recipe states, written
for any device and any float dtype: furthest point sampling, the exact ball
query, the 3-NN interpolation, the bilinear image gather, RoI pooling, the
bin-based box decode, the axis-aligned and rotated BEV overlaps and a
greedy NMS. Nothing here is a hand-written kernel or imports the program:
each function is the loop or the tensor expression that defines the
operation.

Two forms follow the JAX package that the port mirrors, because the
configuration states them: the 3-NN field is ``|a|^2 + |b|^2 - 2ab`` with
the cross term as a chain of fused multiply-adds (a point that is also a
known gets rounding noise instead of 0), and the radius test compares with
radius^2 rounded to the coordinates' dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
EPS = 1e-8
MARGIN = 1e-5


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------

def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx[..., None].expand(*idx.shape, points.shape[-1]))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    flat = gather_points(points, idx.reshape(B, M * S))
    return flat.reshape(B, M, S, points.shape[-1])


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64: index 0 first, then each step the
    point furthest from the picks so far (the lowest index on ties); each
    squared distance written out term by term."""
    B, N, _ = xyz.shape
    xyz = xyz.detach()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    min_d = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        min_d = torch.minimum(min_d, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(min_d, dim=1, keepdim=True)
        idxs[:, j] = last[:, 0]
    return idxs


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               max_elems: int = 1 << 25) -> torch.Tensor:
    """The first ``nsample`` points strictly inside ``radius`` of each
    centroid in index order; a short ball repeats its first hit, an empty
    one takes index 0. (B, M, nsample) int64."""
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    r2 = torch.tensor(radius * radius, dtype=xyz.dtype).item()
    iota = torch.arange(N, device=xyz.device)
    chunk = max(1, max_elems // max(B * N, 1))
    out = []
    for c in range(0, M, chunk):
        d = new_xyz[:, c:c + chunk, None, :] - xyz[:, None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        hit = d2 < r2
        key = torch.where(hit, iota, N)
        idx = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
        cnt = hit.sum(-1, keepdim=True)
        idx = torch.where(torch.arange(nsample, device=xyz.device) < cnt, idx, idx[..., 0:1])
        out.append(torch.where(cnt > 0, idx, 0))
    return torch.cat(out, 1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor, max_elems: int = 1 << 26):
    """The three nearest knowns of each unknown: (dist, idx), both
    (B, N, 3), dist euclidean; the first minimum on ties."""
    unknown, known = unknown.detach(), known.detach()
    B, N, _ = unknown.shape
    M = known.shape[1]
    iota = torch.arange(M, device=known.device)
    kb = known[:, None, :, :]
    k2 = kb[..., 0] * kb[..., 0] + kb[..., 1] * kb[..., 1] + kb[..., 2] * kb[..., 2]
    chunk = max(1, max_elems // max(B * M, 1))
    ds, ids = [], []
    for c in range(0, N, chunk):
        a = unknown[:, c:c + chunk, None, :]
        ab = a[..., 0] * kb[..., 0]
        ab = torch.addcmul(ab, a[..., 1], kb[..., 1])
        ab = torch.addcmul(ab, a[..., 2], kb[..., 2])
        a2 = a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]
        d2 = (a2 + k2 - 2.0 * ab).clamp_min(0.0)
        d = d2
        cd, ci = [], []
        for _ in range(3):
            i = torch.argmin(d, dim=-1, keepdim=True)
            cd.append(torch.gather(d2, -1, i))
            ci.append(i)
            d = torch.where(iota == i, float('inf'), d)
        ds.append(torch.sqrt(torch.cat(cd, -1)))
        ids.append(torch.cat(ci, -1))
    return torch.cat(ds, 1), torch.cat(ids, 1)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """sum_k weight[..., k] * features[idx[..., k]]: (B, N, C)."""
    return (group_points(features, idx) * weight[..., None]).sum(2)


def grid_sample(feature_map: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an NHWC map at (B, N, 2) points in [-1, 1]
    (``align_corners=True``: -1 is pixel 0, +1 pixel W-1), zero outside:
    the clipped 2x2 window weighted by the hat ``max(0, 1 - |t|)``."""
    B, H, W, C = feature_map.shape
    N = xy_norm.shape[1]
    xy_norm = xy_norm.detach()
    x = (xy_norm[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (xy_norm[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(x), 0, max(W - 2, 0)).long()
    y0 = torch.clamp(torch.floor(y), 0, max(H - 2, 0)).long()
    flat = feature_map.reshape(B, H * W, C)
    out = None
    for dy in range(min(2, H)):
        wy = torch.clamp(1.0 - torch.abs(y - (y0 + dy)), min=0.0)
        for dx in range(min(2, W)):
            wx = torch.clamp(1.0 - torch.abs(x - (x0 + dx)), min=0.0)
            rows = (y0 + dy) * W + (x0 + dx)
            tap = torch.gather(flat, 1, rows[..., None].expand(B, N, C)) \
                * (wy * wx).to(feature_map.dtype)[..., None]
            out = tap if out is None else out + tap
    return out


# ---------------------------------------------------------------------------
# boxes: (..., 7) = [x, y, z, h, w, l, ry], rect camera frame, y down
# ---------------------------------------------------------------------------

def rotate_points_along_y(pts: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate x (col 0) and z (col 2) of (..., P, 3+C) points about the
    camera's y axis by ``angle`` (...)."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, z = pts[..., 0], pts[..., 2]
    if c.dim() == x.dim() - 1:
        c, s = c[..., None], s[..., None]
    return torch.cat([(c * x - s * z)[..., None], pts[..., 1:2], (s * x + c * z)[..., None],
                      pts[..., 3:]], dim=-1)


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 5) [x1, z1, x2, z2, ry]."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2.0, boxes3d[..., 4] / 2.0
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes3d[..., 6]], -1)


def enlarge_box3d(boxes3d: torch.Tensor, extra_width: float) -> torch.Tensor:
    return torch.cat([boxes3d[..., 0:1], boxes3d[..., 1:2] + extra_width, boxes3d[..., 2:3],
                      boxes3d[..., 3:6] + 2.0 * extra_width, boxes3d[..., 6:]], dim=-1)


def points_in_boxes3d(pts: torch.Tensor, boxes3d: torch.Tensor,
                      max_dis: float = 10.0) -> torch.Tensor:
    """(..., N, 3) points in (..., M, 7) rotated boxes -> (..., M, N) bool."""
    cx, cy, cz = boxes3d[..., 0], boxes3d[..., 1], boxes3d[..., 2]
    h, w, l, ry = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5], boxes3d[..., 6]
    px = pts[..., None, :, 0] - cx[..., None]
    py = pts[..., None, :, 1] - cy[..., None]
    pz = pts[..., None, :, 2] - cz[..., None]
    h_ = h[..., None]
    in_y = torch.abs(py + h_ / 2.0) <= h_ / 2.0
    near = (torch.abs(px) < max_dis) & (torch.abs(pz) < max_dis)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x_rot = px * c - pz * s
    z_rot = px * s + pz * c
    in_xz = (torch.abs(x_rot) <= l[..., None] / 2.0) & (torch.abs(z_rot) <= w[..., None] / 2.0)
    return in_y & near & in_xz


def roipool3d(xyz: torch.Tensor, features: torch.Tensor, boxes3d: torch.Tensor,
              extra_width: float, sampled_pt_num: int):
    """The first ``sampled_pt_num`` points (in index order) inside each
    enlarged box, repeated cyclically when a box holds fewer; an empty box
    pools zeros. Returns (xyz (B, M, S, 3), features (B, M, S, C))."""
    B, N, _ = xyz.shape
    M = boxes3d.shape[1]
    S = sampled_pt_num
    dev = xyz.device
    mask = points_in_boxes3d(xyz, enlarge_box3d(boxes3d, extra_width))
    iota = torch.arange(N, device=dev)
    k = min(S, N)
    first = torch.topk(torch.where(mask, iota, N), k, dim=-1, largest=False, sorted=True).values
    if k < S:
        first = torch.cat([first, first.new_full((B, M, S - k), N)], -1)
    cnt = mask.sum(-1)
    empty = cnt == 0
    slot = torch.arange(S, device=dev)
    wrapped = slot % cnt.clamp_min(1)[..., None]
    idx = torch.gather(first, -1, torch.where(slot >= cnt.clamp_max(S)[..., None], wrapped, slot))
    idx = torch.where(empty[..., None], 0, idx.clamp(0, N - 1)).reshape(B, M * S)

    def pool(table):
        pooled = gather_points(table, idx).reshape(B, M, S, table.shape[-1])
        return torch.where(empty[..., None, None], 0.0, pooled).to(table.dtype)

    return pool(xyz), pool(features)


def _pick(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, i[:, None])[:, 0]


def decode_bbox_target(roi_box3d, pred_reg, anchor_size, loc_scope, loc_bin_size, num_head_bin,
                       get_xz_fine=True, get_y_by_bin=False, loc_y_scope=0.5,
                       loc_y_bin_size=0.25, get_ry_fine=False, bbox_avg_by_bin=False,
                       ry_with_bin=False) -> torch.Tensor:
    """Decode (N, C) bin-based regressions against (N, 3|7) anchors into
    (N, 7) boxes (EPNet ``bbox_transform.decode_bbox_target``, with its
    bin-expectation decode ``bbox_avg_by_bin`` and the left/right heading
    decode ``ry_with_bin``)."""
    n_bin = int(loc_scope / loc_bin_size) * 2
    y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    dtype, dev = pred_reg.dtype, pred_reg.device
    start = n_bin * 2
    if not bbox_avg_by_bin:
        x_bin = torch.argmax(pred_reg[:, 0:n_bin], dim=1)
        z_bin = torch.argmax(pred_reg[:, n_bin:2 * n_bin], dim=1)
        pos_x = x_bin.to(dtype) * loc_bin_size + loc_bin_size / 2 - loc_scope
        pos_z = z_bin.to(dtype) * loc_bin_size + loc_bin_size / 2 - loc_scope
        if get_xz_fine:
            pos_x = pos_x + _pick(pred_reg[:, start:start + n_bin], x_bin) * loc_bin_size
            pos_z = pos_z + _pick(pred_reg[:, start + n_bin:start + 2 * n_bin], z_bin) \
                * loc_bin_size
            start += 2 * n_bin
    else:
        if not get_xz_fine:
            raise ValueError('bbox_avg_by_bin needs the fine (bin + residual) format')
        px_bin = torch.softmax(pred_reg[:, 0:n_bin], dim=1)
        pz_bin = torch.softmax(pred_reg[:, n_bin:2 * n_bin], dim=1)
        centers = (torch.arange(n_bin, dtype=dtype, device=dev) * loc_bin_size
                   + loc_bin_size / 2 - loc_scope)
        pos_x = ((centers + pred_reg[:, start:start + n_bin] * loc_bin_size) * px_bin).sum(1)
        pos_z = ((centers + pred_reg[:, start + n_bin:start + 2 * n_bin] * loc_bin_size)
                 * pz_bin).sum(1)
        start += 2 * n_bin
    if get_y_by_bin:
        y_bin = torch.argmax(pred_reg[:, start:start + y_bin_num], dim=1)
        y_res = _pick(pred_reg[:, start + y_bin_num:start + 2 * y_bin_num], y_bin)
        pos_y = (y_bin.to(dtype) * loc_y_bin_size + loc_y_bin_size / 2 - loc_y_scope
                 + y_res * loc_y_bin_size) + roi_box3d[:, 1]
        start += 2 * y_bin_num
    else:
        pos_y = roi_box3d[:, 1] + pred_reg[:, start]
        start += 1
    H = num_head_bin
    ry_logits = pred_reg[:, start:start + H]
    ry_res_all = pred_reg[:, start + H:start + 2 * H]
    if not ry_with_bin:
        ry_bin = torch.argmax(ry_logits, dim=1)
        ry_res = _pick(ry_res_all, ry_bin)
        if get_ry_fine:
            apc = (PI / 2) / H
            ry = (ry_bin.to(dtype) * apc + apc / 2) + ry_res * (apc / 2) - PI / 4
        else:
            apc = (2 * PI) / H
            ry = torch.remainder(ry_bin.to(dtype) * apc + ry_res * (apc / 2), 2 * PI)
            ry = torch.where(ry > PI, ry - 2 * PI, ry)
    else:
        p = torch.softmax(ry_logits, dim=1)
        bins = torch.arange(H, dtype=dtype, device=dev)
        if get_ry_fine:
            apc = (PI / 2) / H
            ry_all = (bins * apc + apc / 2) + ry_res_all * (apc / 2) - PI / 4
            right = ry_all >= 0
        else:
            apc = (2 * PI) / H
            ry_all = torch.remainder(bins * apc + ry_res_all * (apc / 2), 2 * PI)
            right = ry_all <= PI
        zero = torch.zeros((), dtype=dtype, device=dev)
        pr, pl = torch.where(right, p, zero), torch.where(right, zero, p)
        p_r = pr.sum(1, keepdim=True) + 1e-7
        p_l = pl.sum(1, keepdim=True) + 1e-7
        ry_r = (torch.where(right, ry_all, zero) * pr / p_r).sum(1)
        ry_l = (torch.where(right, zero, ry_all) * pl / p_l).sum(1)
        ry = torch.where(p_r[:, 0] >= p_l[:, 0], ry_r, ry_l)
        if not get_ry_fine:
            ry = torch.where(ry > PI, ry - 2 * PI, ry)
    start += 2 * H
    hwl = pred_reg[:, start:start + 3] * anchor_size + anchor_size
    shifted = torch.cat([pos_x[:, None], pos_y[:, None], pos_z[:, None], hwl, ry[:, None]], 1)
    if roi_box3d.shape[1] == 7:
        roi_ry = roi_box3d[:, 6]
        shifted = rotate_points_along_y(shifted[:, None, :], -roi_ry)[:, 0, :]
        shifted = torch.cat([shifted[:, :6], shifted[:, 6:7] + roi_ry[:, None]], 1)
    return torch.cat([shifted[:, 0:1] + roi_box3d[:, 0:1], shifted[:, 1:2],
                      shifted[:, 2:3] + roi_box3d[:, 2:3], shifted[:, 3:]], 1)


# ---------------------------------------------------------------------------
# overlaps and NMS
# ---------------------------------------------------------------------------

def iou_axis_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV IoU of (N, 5) x (M, 5) boxes, the angle ignored."""
    lx = torch.maximum(a[:, None, 0], b[None, :, 0])
    rx = torch.minimum(a[:, None, 2], b[None, :, 2])
    ly = torch.maximum(a[:, None, 1], b[None, :, 1])
    ry = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(rx - lx, min=0.0) * torch.clamp(ry - ly, min=0.0)
    sa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    sb = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / torch.clamp(sa[:, None] + sb[None, :] - inter, min=EPS)


def _bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2, ang = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    xs = torch.stack([x1, x2, x2, x1], -1)
    ys = torch.stack([y1, y1, y2, y2], -1)
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    dx, dy = xs - cx[..., None], ys - cy[..., None]
    return torch.stack([dx * c + dy * s + cx[..., None], -dx * s + dy * c + cy[..., None]], -1)


def _cross(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - \
        (b[..., 0] - o[..., 0]) * (a[..., 1] - o[..., 1])


def _point_in_box(boxes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2, ang = (boxes[..., i, None] for i in range(5))
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    c, s = torch.cos(-ang), torch.sin(-ang)
    rx = (pts[..., 0] - cx) * c + (pts[..., 1] - cy) * s + cx
    ry = -(pts[..., 0] - cx) * s + (pts[..., 1] - cy) * c + cy
    return (rx > x1 - MARGIN) & (rx < x2 + MARGIN) & (ry > y1 - MARGIN) & (ry < y2 + MARGIN)


def rotated_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated BEV rectangles, pair by pair (broadcast
    (..., 5) x (..., 5) -> (...)): the edge crossings and the contained
    corners, sorted by angle about their mean, and the shoelace sum."""
    a, b = torch.broadcast_tensors(a, b)
    ca, cb = _bev_corners(a), _bev_corners(b)
    p0, p1 = ca[..., :, None, :], torch.roll(ca, -1, dims=-2)[..., :, None, :]
    q0, q1 = cb[..., None, :, :], torch.roll(cb, -1, dims=-2)[..., None, :, :]

    def lohi(u, v, k):
        return torch.minimum(u[..., k], v[..., k]), torch.maximum(u[..., k], v[..., k])

    pxl, pxh = lohi(p0, p1, 0)
    qxl, qxh = lohi(q0, q1, 0)
    pyl, pyh = lohi(p0, p1, 1)
    qyl, qyh = lohi(q0, q1, 1)
    rect_ok = (pxl <= qxh) & (qxl <= pxh) & (pyl <= qyh) & (qyl <= pyh)
    s1, s2 = _cross(p0, q0, p1), _cross(p0, p1, q1)
    s3, s4 = _cross(q0, p0, q1), _cross(q0, q1, p1)
    inter_valid = rect_ok & (s1 * s2 > 0) & (s3 * s4 > 0)
    s5 = _cross(p0, q1, p1)
    denom = s5 - s1
    primary = torch.abs(denom) > EPS
    safe = torch.where(primary, denom, 1.0)
    ix1 = (s5 * q0[..., 0] - s1 * q1[..., 0]) / safe
    iy1 = (s5 * q0[..., 1] - s1 * q1[..., 1]) / safe
    a0c, b0c = p0[..., 1] - p1[..., 1], p1[..., 0] - p0[..., 0]
    c0c = p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]
    a1c, b1c = q0[..., 1] - q1[..., 1], q1[..., 0] - q0[..., 0]
    c1c = q0[..., 0] * q1[..., 1] - q1[..., 0] * q0[..., 1]
    D = a0c * b1c - a1c * b0c
    safe_D = torch.where(torch.abs(D) > 0, D, 1.0)
    ix = torch.where(primary, ix1, (b0c * c1c - b1c * c0c) / safe_D)
    iy = torch.where(primary, iy1, (a1c * c0c - a0c * c1c) / safe_D)
    lead = a.shape[:-1]
    pts = torch.cat([torch.stack([ix, iy], -1).reshape(*lead, 16, 2), cb, ca], -2)
    valid = torch.cat([inter_valid.reshape(*lead, 16), _point_in_box(a, cb),
                       _point_in_box(b, ca)], -1)
    cnt = valid.sum(-1)
    center = (pts * valid[..., None].to(pts.dtype)).sum(-2) / cnt.clamp_min(1)[..., None]
    ang = torch.atan2(pts[..., 1] - center[..., None, 1], pts[..., 0] - center[..., None, 0])
    order = torch.argsort(torch.where(valid, ang, float('inf')), dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    in_poly = torch.arange(pts.shape[-2], device=pts.device) < cnt[..., None]
    anchor = sp[..., 0:1, :]
    v0 = torch.where(in_poly[..., None], sp, anchor) - anchor
    v1 = torch.roll(v0, -1, dims=-2)
    area = torch.abs((v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0])[..., :-1].sum(-1)) / 2.0
    return torch.where(cnt > 0, area, 0.0)


def iou_bev_rotated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU of (N, 5) x (M, 5) boxes."""
    sa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    sb = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    ov = rotated_overlap(a[:, None, :], b[None, :, :])
    return ov / torch.clamp(sa[:, None] + sb[None, :] - ov, min=EPS)


def iou3d_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D IoU of (..., 7) x (..., 7) boxes, pair by pair (broadcast)."""
    ov_bev = rotated_overlap(boxes3d_to_bev(a), boxes3d_to_bev(b))
    ov_h = torch.clamp(torch.minimum(a[..., 1], b[..., 1])
                       - torch.maximum(a[..., 1] - a[..., 3], b[..., 1] - b[..., 3]), min=0.0)
    ov3d = ov_bev * ov_h
    vol_a = a[..., 3] * a[..., 4] * a[..., 5]
    vol_b = b[..., 3] * b[..., 4] * b[..., 5]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-7)


def nms(boxes_bev: torch.Tensor, scores: torch.Tensor, thresh: float, max_keep: int,
        rotated: bool) -> torch.Tensor:
    """Greedy NMS: walk the boxes by descending score (ties in index
    order), keep a box unless a kept one overlaps it by more than
    ``thresh``, stop at ``max_keep``. Returns the kept indices into the
    input, in score order (int64, on the boxes' device)."""
    n = boxes_bev.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=boxes_bev.device)
    order = torch.argsort(-scores, stable=True)
    sb = boxes_bev[order]
    overlap = iou_bev_rotated if rotated else iou_axis_aligned
    over = (overlap(sb, sb) > thresh).cpu().numpy()
    suppressed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) == max_keep:
            break
        suppressed |= over[i]
    return order[torch.tensor(keep, dtype=torch.int64, device=order.device)]
