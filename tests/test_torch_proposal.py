"""Box decode, BEV NMS, the proposal layer and RoI pooling of the port
against the JAX package, on the CPU.

Keep lists, RoI order, counts, pooled slots and empty flags must be
identical; decoded boxes agree within rtol=atol=1e-5 (f32 softmax and
trigonometry on both sides), and decode also matches the reference's own
golden values (tests/golden_codec.json) within 1e-4, the JAX test's bound.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from epnet_tpu.models.proposal import ProposalLayer as JProposal
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.bbox_codec import decode_bbox_target as j_decode
from epnet_tpu.ops.nms import nms_bev as j_nms
from epnet_tpu.ops.roipool3d import roipool3d as j_roipool
from epnet_tpu_torch.models.proposal import ProposalLayer as TProposal
from epnet_tpu_torch.ops.bbox_codec import decode_bbox_target as t_decode
from epnet_tpu_torch.ops.nms import nms_bev as t_nms
from epnet_tpu_torch.ops.roipool3d import roipool3d as t_roipool
from epnet_tpu_torch.utils.testing import tiny_config

from test_torch_bridge import t

CASES = json.loads((pathlib.Path(__file__).parent / 'golden_codec.json').read_text())
DECODE_CASES = sorted(k for k in CASES if k.startswith(('rpn_', 'rcnn_')))


@pytest.fixture(autouse=True)
def exact_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', True)


@pytest.mark.parametrize('name', DECODE_CASES)
def test_decode_matches_golden_and_jax(name):
    case = CASES[name]
    p = case['params']
    kw = dict(loc_scope=p['loc_scope'], loc_bin_size=p['loc_bin_size'],
              num_head_bin=p['num_head_bin'], get_xz_fine=p['get_xz_fine'],
              get_y_by_bin=p['get_y_by_bin'], loc_y_scope=p['loc_y_scope'],
              loc_y_bin_size=p['loc_y_bin_size'], get_ry_fine=p['get_ry_fine'],
              bbox_avg_by_bin=p['bbox_avg_by_bin'], ry_with_bin=p['ry_with_bin'])
    roi, reg, anchor = (np.asarray(case[k], np.float32) for k in ('roi', 'pred_reg', 'anchor'))
    got = t_decode(t(roi), t(reg), t(anchor), **kw).numpy()
    want = np.asarray(j_decode(jnp.asarray(roi), jnp.asarray(reg), jnp.asarray(anchor), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    expected = np.asarray(case['expected'], np.float32)
    np.testing.assert_allclose(got[:, :6], expected[:, :6], rtol=1e-4, atol=1e-4)
    dry = np.abs(got[:, 6] - expected[:, 6])
    assert np.minimum(dry, 2 * np.pi - dry).max() < 1e-4


def _boxes(rng, n):
    ctr = rng.uniform(-10, 10, (n, 2))
    size = rng.uniform(1.0, 4.0, (n, 2))
    bev = np.concatenate([ctr - size / 2, ctr + size / 2, rng.uniform(-3, 3, (n, 1))], 1)
    return bev.astype(np.float32)


@pytest.mark.parametrize('n,thresh,max_keep,num_valid', [
    (150, 0.3, 40, None),   # several blocks, early exit
    (100, 0.1, 100, 70),    # padded candidates, keep everything left
    (20, 0.5, 64, None),    # max_keep > N: edge padding
])
def test_nms_keep_lists_identical(n, thresh, max_keep, num_valid):
    rng = np.random.RandomState(n)
    bev = _boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    scores[5:15] = scores[5]  # ties keep input order (stable sort)
    j_idx, j_cnt = j_nms(jnp.asarray(bev), jnp.asarray(scores), thresh, max_keep,
                         num_valid=num_valid)
    t_idx, t_cnt = t_nms(t(bev), t(scores), thresh, max_keep, num_valid=num_valid)
    assert t_cnt == int(j_cnt)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def _rpn_outputs(seed, far):
    """Scores, regression and points as the RPN would hand them over; the
    regression is scaled up so the decoded boxes differ visibly."""
    cfg = tiny_config(EXACT_QUERIES=True)
    rng = np.random.RandomState(seed)
    B, N = 2, cfg.RPN.NUM_POINTS
    z_hi = 70.0 if far else 30.0  # decoded z stays below the 40 m split
    xyz = np.stack([rng.uniform(-15, 15, (B, N)), rng.uniform(0.5, 2, (B, N)),
                    rng.uniform(2, z_hi, (B, N))], -1).astype(np.float32)
    reg = (rng.randn(B, N, cfg.RPN.reg_channel) * 0.5).astype(np.float32)
    scores = rng.randn(B, N).astype(np.float32)
    return cfg, scores, reg, xyz


@pytest.mark.parametrize('far', [True, False])  # False: far-range fallback
def test_proposal_layer(far):
    cfg, scores, reg, xyz = _rpn_outputs(10, far)
    j_rois, j_scores, j_cnt = JProposal(cfg, 'TEST')(jnp.asarray(scores), jnp.asarray(reg),
                                                     jnp.asarray(xyz))
    t_rois, t_scores, t_cnt = TProposal(cfg, 'TEST')(t(scores), t(reg), t(xyz))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_allclose(t_rois.numpy(), np.asarray(j_rois), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_scores.numpy(), np.asarray(j_scores))


def test_roipool3d_exact():
    rng = np.random.RandomState(11)
    B, N, M, S = 2, 400, 6, 32
    xyz = np.stack([rng.uniform(-5, 5, (B, N)), rng.uniform(0, 2, (B, N)),
                    rng.uniform(5, 15, (B, N))], -1).astype(np.float32)
    feats = rng.randn(B, N, 7).astype(np.float32)
    rois = np.stack([rng.uniform(-4, 4, (B, M)), rng.uniform(1.5, 2, (B, M)),
                     rng.uniform(6, 14, (B, M)), rng.uniform(1, 2, (B, M)),
                     rng.uniform(0.5, 3, (B, M)), rng.uniform(0.5, 4, (B, M)),
                     rng.uniform(-3, 3, (B, M))], -1).astype(np.float32)
    rois[0, 0, 2] = 100.0  # an empty box
    jx, jf, je, jc = j_roipool(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(rois),
                               0.2, sampled_pt_num=S, exact=True)
    tx, tf, te, tc = t_roipool(t(xyz), t(feats), t(rois), 0.2, sampled_pt_num=S)
    cnt = np.asarray(jc)
    assert cnt[0, 0] == 0 and ((cnt > 0) & (cnt < S)).any() and (cnt > S).any()
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), cnt)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
