"""Train-time target assignment (``epnet_tpu_torch/models/target_assign.py``)
and the rotated IoU (``ops/rotated_iou.py``) against the JAX package.

``jax.random`` streams cannot be reproduced in PyTorch, so the port draws
all of the layer's random numbers up front into a ``TargetDraws``. Here the
JAX package's own draws (its key tree, replayed) are packed into one, and
the whole port layer (IoU assignment, fg/easy/hard masks, the fg/bg slot
arithmetic, first-success noise selection, per-RoI rotate/scale/flip, the
canonical transform and the labels) is held against the JAX layer on
identical arrays: indices and labels identical, floats within 1e-5. Then
invariants of the layer under a ``torch.Generator``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import target_assign as jta
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops import rotated_iou as jri
from epnet_tpu_torch.models import target_assign as tta
from epnet_tpu_torch.ops import rotated_iou as tri
from epnet_tpu_torch.utils.testing import tiny_config

ATOL = 1e-5


def _boxes():
    """Rotated, touching, nested, identical and disjoint pairs (x, y, z, h, w, l, ry)."""
    rng = np.random.RandomState(0)
    a = [[0, 1, 10, 1.5, 1.6, 3.9, 0.3], [5, 1, 20, 1.5, 1.6, 3.9, 0.0],
         [0, 1, 30, 2.0, 2.0, 2.0, 0.0], [9, 1, 40, 1.5, 1.6, 3.9, 1.2],
         [-5, 1, 15, 1.5, 1.6, 3.9, -2.0]]
    b = [[0.4, 1.2, 10.3, 1.4, 1.7, 4.1, -0.2],   # rotated overlap
         [5, 1, 23.9, 1.5, 1.6, 3.9, 0.0],         # touching along z (w side)
         [0, 0.8, 30, 1.0, 1.0, 1.0, 0.7],         # nested, rotated
         [9, 1, 40, 1.5, 1.6, 3.9, 1.2],           # identical
         [50, 1, 15, 1.5, 1.6, 3.9, 0.5]]          # disjoint
    rand = np.concatenate([rng.uniform(-3, 3, (20, 1)), rng.uniform(0.5, 1.5, (20, 1)),
                           rng.uniform(10, 16, (20, 1)), rng.uniform(1, 2, (20, 3)),
                           rng.uniform(-np.pi, np.pi, (20, 1))], 1)
    return (np.concatenate([a, rand[:10]]).astype(np.float32),
            np.concatenate([b, rand[10:]]).astype(np.float32))


def test_boxes_iou3d_and_bev():
    from epnet_tpu.ops.boxes import boxes3d_to_bev as j_bev
    from epnet_tpu_torch.ops.boxes import boxes3d_to_bev as t_bev
    a, b = _boxes()
    want3d = np.asarray(jri.boxes_iou3d(jnp.asarray(a), jnp.asarray(b)))
    got3d = tri.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got3d, want3d, atol=ATOL)
    wantbev = np.asarray(jri.boxes_iou_bev(j_bev(jnp.asarray(a)), j_bev(jnp.asarray(b))))
    gotbev = tri.boxes_iou_bev(t_bev(torch.from_numpy(a)), t_bev(torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(gotbev, wantbev, atol=ATOL)
    d = np.diagonal(want3d)
    assert d[3] > 0.999 and d[4] == 0 and d[1] < 1e-4 and 0 < d[2] < 0.2 and 0.3 < d[0] < 0.99
    # aligned pairs are the diagonal, without the rest of the matrix
    aligned = tri.boxes_iou3d_aligned(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(aligned, np.diagonal(got3d), atol=1e-6)


def _jax_draws(key, cfg, B, M):
    """The random numbers the JAX package's proposal_target_layer draws from
    ``key`` (replaying its key tree), as a ``TargetDraws``."""
    R = cfg.RCNN.ROI_PER_IMAGE
    T = max(cfg.RCNN.ROI_FG_AUG_TIMES, 1)
    keys = jax.random.split(key, B + 2)
    fields = {k: [] for k in tta.TargetDraws._fields}

    def cand(ck):
        k1, k2, k3, k4 = jax.random.split(ck, 4)
        return (jax.random.uniform(k1, (3,)), jax.random.uniform(k2, (3,)),
                jax.random.uniform(k3, (1,)), jax.random.randint(k4, (), 0, 5))

    for b in range(B):
        k_fg, k_fgwr, k_hard, k_easy, k_aug = jax.random.split(keys[b], 5)
        fields['fg_u'].append(jax.random.uniform(k_fg, (M,)))
        fields['fg_wr'].append(jax.random.randint(k_fgwr, (R,), 0, 1 << 30))
        fields['hard_r'].append(jax.random.randint(k_hard, (R,), 0, 1 << 30))
        fields['easy_r'].append(jax.random.randint(k_easy, (R,), 0, 1 << 30))
        kk, kp = jax.random.split(k_aug)
        fields['keep_u'].append(jax.random.uniform(kp, (R, T)))
        pos, hwl, ang, lvl = jax.vmap(jax.vmap(cand))(
            jax.random.split(kk, R * T).reshape(R, T, -1))
        for k, x in zip(('pos', 'hwl_u', 'ang_u', 'level'), (pos, hwl, ang, lvl)):
            fields[k].append(x)
    k_rot, k_scale, k_flip = jax.random.split(keys[B], 3)
    out = {k: torch.from_numpy(np.stack([np.array(x) for x in v])) for k, v in fields.items()
           if v}
    for k, kk in (('rot_u', k_rot), ('scale_u', k_scale), ('flip_u', k_flip)):
        out[k] = torch.from_numpy(np.array(jax.random.uniform(kk, (B, R))))
    return tta.TargetDraws(**{k: v.long() if v.dtype == torch.int32 else v
                              for k, v in out.items()})


def _scene(seed, B=2, M=32, N=256, G=4):
    """RoIs scattered around gt boxes (some fg, some hard and easy bg),
    points in and around the boxes; the last gt of each image is padding."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, G, 7), np.float32)
    gt[:, :G - 1] = np.concatenate([
        rng.uniform(-8, 8, (B, G - 1, 1)), np.full((B, G - 1, 1), 1.6),
        rng.uniform(8, 30, (B, G - 1, 1)), rng.uniform(1.4, 1.7, (B, G - 1, 1)),
        rng.uniform(1.5, 1.7, (B, G - 1, 1)), rng.uniform(3.5, 4.2, (B, G - 1, 1)),
        rng.uniform(-np.pi, np.pi, (B, G - 1, 1))], -1)
    which = rng.randint(0, G - 1, (B, M))
    rois = np.take_along_axis(gt, which[..., None], 1).copy()
    jitter = rng.rand(B, M) * 3.0  # 0: on the gt, 3: metres away
    rois[..., 0] += rng.randn(B, M) * jitter
    rois[..., 2] += rng.randn(B, M) * jitter
    rois[..., 3:6] *= rng.uniform(0.85, 1.15, (B, M, 3))
    rois[..., 6] += rng.randn(B, M) * 0.2
    rois[:, -3:, 0] += 25.0  # far from everything: easy bg
    centers = np.take_along_axis(gt, rng.randint(0, G - 1, (B, N))[..., None], 1)
    xyz = centers[..., 0:3] + rng.randn(B, N, 3).astype(np.float32) * [1.5, 0.4, 1.5]
    xyz[..., 1] -= 0.7
    feats = rng.randn(B, N, 8).astype(np.float32)
    seg = (rng.rand(B, N) > 0.5).astype(np.float32)
    depth = np.linalg.norm(xyz, axis=-1).astype(np.float32)
    return [a.astype(np.float32) for a in (rois, gt, xyz, feats, seg, depth)]


@pytest.fixture(scope='module')
def layer():
    cfg = tiny_config(EXACT_QUERIES=True)
    args = _scene(0)
    key = jax.random.PRNGKey(7)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # the exact mask_score and pool
    try:
        fn = jax.jit(lambda k, *a: jta.proposal_target_layer(k, *a, cfg))
        want = {k: np.asarray(v) for k, v in fn(key, *(jnp.asarray(a) for a in args))
                ._asdict().items()}
    finally:
        mp.undo()
    draws = _jax_draws(key, cfg, *args[0].shape[:2])
    got = tta.proposal_target_layer(*(torch.from_numpy(a) for a in args), cfg, draws=draws)
    return cfg, want, {k: v.numpy() for k, v in got._asdict().items()}


@pytest.mark.parametrize('key', ['cls_label', 'reg_valid_mask'])
def test_labels_identical(layer, key):
    _, want, got = layer
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['sampled_pts', 'pts_feature', 'mask_score', 'gt_of_rois',
                                 'gt_iou', 'roi_boxes3d'])
def test_targets_match(layer, key):
    _, want, got = layer
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=ATOL)


def test_layer_is_not_vacuous(layer):
    _, want, _ = layer
    labels = want['cls_label']
    assert (labels == 1).any() and (labels == 0).any()
    assert want['reg_valid_mask'].sum() > 0
    assert (want['mask_score'] > 0).any()


def test_list_of_and_rand_subset_match_jax():
    rng = np.random.RandomState(3)
    mask = rng.rand(40) > 0.6
    jl, jc = jta._list_of(jnp.asarray(mask), 40)
    tl, tc = tta.list_of(torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl))
    assert int(tc[0]) == int(jc)
    key = jax.random.PRNGKey(5)
    ji, jn = jta._rand_subset(key, jnp.asarray(mask), 8)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (40,))))
    ti, tn = tta.rand_subset(u[None], torch.from_numpy(mask)[None], 8)
    n = int(jn)
    assert int(tn[0]) == n
    np.testing.assert_array_equal(ti[0, :n].numpy(), np.asarray(ji)[:n])


@pytest.mark.parametrize('method', ['single', 'multiple', 'normal'])
def test_random_aug_box3d_matches_jax(method):
    """Each noise method given the JAX package's own draws for one box."""
    cfg = tiny_config(RCNN={'REG_AUG_METHOD': method})
    box = jnp.asarray([1.0, 1.6, 20.0, 1.5, 1.6, 3.9, 0.4])
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jta._random_aug_box3d(key, box, cfg))
        k1, k2, k3, k4 = jax.random.split(key, 4)
        pos = (jax.random.normal(k1, (6,)) if method == 'normal'
               else jax.random.uniform(k1, (3,)))
        got = tta.random_aug_box3d(torch.tensor(np.asarray(box)),
                                   *(torch.from_numpy(np.array(v)) for v in (
                                       pos, jax.random.uniform(k2, (3,)),
                                       jax.random.uniform(k3, (1,)))),
                                   torch.tensor(int(jax.random.randint(k4, (), 0, 5))), method)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# invariants under a torch.Generator
# ---------------------------------------------------------------------------

def _run(cfg, args, seed):
    return tta.proposal_target_layer(*(torch.from_numpy(a) for a in args), cfg,
                                     generator=torch.Generator().manual_seed(seed))


def _fg_count(cfg, rois, gt):
    t = [torch.from_numpy(a) for a in (rois, gt)]
    iou = tri.boxes_iou3d_aligned(t[0][:, :, None], t[1][:, None])
    iou = torch.where((t[1] != 0).any(-1)[:, None], iou, -1.0)
    fg_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
    return (iou.max(-1).values >= fg_thresh).sum(-1)


@pytest.mark.parametrize('case', ['mixed', 'fg_only', 'bg_only'])
def test_fg_slots(case):
    """fg slots = min(round(FG_RATIO * R), #fg); all R with fg but no bg;
    0 without fg. Noise off, so a fg slot keeps its RoI's IoU."""
    cfg = tiny_config(EXACT_QUERIES=True, RCNN={'ROI_FG_AUG_TIMES': 0}, AUG_DATA=False)
    rois, gt, *rest = _scene(1)
    if case == 'fg_only':
        rois = np.take_along_axis(gt, np.zeros((2, rois.shape[1], 1), np.int64), 1).copy()
        rois[..., 0] += np.linspace(0, 0.2, rois.shape[1], dtype=np.float32)
    elif case == 'bg_only':
        rois[..., 0] += 60.0
    R = cfg.RCNN.ROI_PER_IMAGE
    n_fg = _fg_count(cfg, rois, gt)
    out = _run(cfg, [rois, gt] + rest, 0)
    fg_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
    slots = (out.gt_iou.reshape(2, R) >= fg_thresh).sum(-1)
    for b in range(2):
        if case == 'fg_only':
            assert int(n_fg[b]) > 0 and int(slots[b]) == R
        elif case == 'bg_only':
            assert int(n_fg[b]) == 0 and int(slots[b]) == 0
        else:
            assert int(slots[b]) == min(int(round(cfg.RCNN.FG_RATIO * R)), int(n_fg[b]))


def test_bg_picks_and_labels_follow_thresholds():
    cfg = tiny_config(EXACT_QUERIES=True)
    args = _scene(2)
    out = _run(cfg, args, 0)
    rc = cfg.RCNN
    iou, labels, reg = out.gt_iou, out.cls_label, out.reg_valid_mask
    assert torch.equal(labels == 1, (iou > rc.CLS_FG_THRESH) & (labels != -1))
    assert ((labels == -1) | (iou <= rc.CLS_BG_THRESH) | (iou >= rc.CLS_FG_THRESH)).all()
    assert not ((reg == 1) & (iou <= rc.REG_FG_THRESH)).any()
    assert ((reg == 1) | (iou <= rc.REG_FG_THRESH) | (labels == -1)).all()
    # noise off: every bg slot holds a RoI of its mask (IoU below CLS_BG_THRESH)
    cfg0 = tiny_config(EXACT_QUERIES=True, RCNN={'ROI_FG_AUG_TIMES': 0}, AUG_DATA=False)
    out0 = _run(cfg0, args, 0)
    fg_thresh = min(rc.REG_FG_THRESH, rc.CLS_FG_THRESH)
    bg = out0.gt_iou < fg_thresh
    assert bg.any() and (out0.gt_iou[bg] < rc.CLS_BG_THRESH).all()
    rois = torch.from_numpy(args[0]).reshape(-1, 7)
    picked = out0.roi_boxes3d
    assert all(bool((rois == r).all(-1).any()) for r in picked)  # every pick is a RoI


def test_same_seed_same_output():
    cfg = tiny_config(EXACT_QUERIES=True)
    args = _scene(3)
    a, b, c = _run(cfg, args, 5), _run(cfg, args, 5), _run(cfg, args, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.roi_boxes3d, c.roi_boxes3d)


def test_rotation_angles_keep_the_reference_quirk():
    """(rand - 1.0) * pi / AUG_ROT_RANGE: angles in [-pi/range, 0]."""
    cfg = tiny_config()
    pts = torch.tensor([[[[1.0, 0.0, 0.0]]]])
    box = torch.tensor([[[0.0, 0.0, 10.0, 1.5, 1.6, 3.9, 0.0]]])
    for u in (0.0, 0.5, 1.0):
        d = tta.draw_target_noise(cfg, 1, 1)
        d = d._replace(rot_u=torch.tensor([[u]]), scale_u=torch.tensor([[0.5]]),
                       flip_u=torch.tensor([[1.0]]))
        p, _, _ = tta.per_roi_augmentation(pts, box, box, d, cfg)
        ang = (u - 1.0) * math.pi / cfg.AUG_ROT_RANGE
        np.testing.assert_allclose(p[0, 0, 0, [0, 2]].numpy(), [math.cos(ang), math.sin(ang)],
                                   atol=1e-6)
