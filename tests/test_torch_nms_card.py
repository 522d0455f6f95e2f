"""The NMS kernel (``epnet_tpu_torch/csrc/nms.cu``) on the card against the
plain loop (``nms_bev_plain``) on the card: index for index and count for
count. Run on a machine with a card: ``python -m pytest
tests/test_torch_nms_card.py -m cuda``; without one every test skips.

The cases are the proposal layer's own calls (near and far range, TEST and
TRAIN budgets and thresholds) on boxes decoded from KITTI-like structured
scenes and on random boxes with tied scores; a walk of 20000 boxes; the
longest walk the kernel takes and the one it refuses; the ``ProposalLayer``
output with the kernel against the same layer with the plain loop; and the
launches: two a scan in the proposal layer, none for the rotated overlap.
"""

import numpy as np
import pytest
import torch

from epnet_tpu_torch.config import parity_config
from epnet_tpu_torch.models.proposal import ProposalLayer
from epnet_tpu_torch.ops import nms
from epnet_tpu_torch.utils import trace
from epnet_tpu_torch.utils.testing import proposal_inputs, proposal_nms_calls


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the NMS kernel runs only on the card')
    return torch.device('cuda:0')


def _same(args, kw):
    """The kernel's and the plain loop's keep lists of one axis-aligned call
    are identical; returns the kept count."""
    kw = dict(kw)
    assert not kw.pop('rotated', False)
    k_idx, k_cnt = nms.nms_bev_kernel(*args, **kw)
    p_idx, p_cnt = nms.nms_bev_plain(*args, **kw)
    assert k_cnt == p_cnt
    torch.testing.assert_close(k_idx, p_idx, rtol=0, atol=0)
    return k_cnt


@pytest.mark.cuda
@pytest.mark.parametrize('ties', [False, True])
@pytest.mark.parametrize('mode', ['TEST', 'TRAIN'])
def test_kernel_keeps_as_plain_in_the_proposal_layers_calls(dev, mode, ties):
    cfg = parity_config()
    calls, _ = proposal_nms_calls(cfg, mode, proposal_inputs(cfg, 7, dev, ties=ties))
    mcfg = cfg.get(mode)
    pre, post = mcfg.RPN_PRE_NMS_TOP_N, mcfg.RPN_POST_NMS_TOP_N
    near, far = int(pre * 0.7), pre - int(pre * 0.7)
    assert [c[0][0].shape[0] for c in calls] == [near, far] * 2
    assert [c[1]['max_keep'] for c in calls] == [int(post * 0.7), post - int(post * 0.7)] * 2
    assert all(c[0][1].is_cuda and c[0][2] == mcfg.RPN_NMS_THRESH for c in calls)
    kept = [_same(*c) for c in calls]
    assert max(kept) > 1


@pytest.mark.cuda
@pytest.mark.parametrize('n,thresh,max_keep', [(6300, 0.85, 358), (2700, 0.85, 154),
                                               (6300, 0.8, 70), (2700, 0.8, 30),
                                               (20000, 0.3, 500)])
def test_kernel_keeps_as_plain_on_random_boxes_with_ties(dev, n, thresh, max_keep):
    """Random boxes, a third of the scores tied, a tenth of the candidates
    past num_valid."""
    rng = np.random.RandomState(n + max_keep)
    ctr = rng.uniform(-20, 20, (n, 2))
    wh = rng.uniform(1.0, 4.0, (n, 2))
    bev = np.concatenate([ctr - wh / 2, ctr + wh / 2, rng.uniform(-3, 3, (n, 1))], 1)
    scores = rng.rand(n).astype(np.float32)
    scores[: n // 3] = np.round(scores[: n // 3] * 8) / 8
    nv = n - n // 10
    scores[nv:] = -np.inf
    args = (torch.from_numpy(bev.astype(np.float32)).to(dev), torch.from_numpy(scores).to(dev),
            thresh)
    assert _same(args, {'max_keep': max_keep, 'num_valid': nv}) > 1


@pytest.mark.cuda
def test_kernel_raises_above_its_bitmap(dev):
    """The bitmap of 393,216 boxes fills a block's 48 KB of shared memory: a
    longer walk raises before the launch, a walk of that many runs."""
    n = 48 * 1024 * 8
    boxes = torch.zeros(n + 1, 5, device=dev)
    boxes[:, 0] = torch.arange(n + 1, device=dev, dtype=torch.float32) * 2
    boxes[:, 2] = boxes[:, 0] + 1
    boxes[:, 3] = 1
    scores = torch.rand(n + 1, device=dev)
    with pytest.raises(ValueError, match='at most 393216 boxes'):
        nms.nms_bev_kernel(boxes, scores, 0.5, 8)
    _, cnt = nms.nms_bev_kernel(boxes, scores, 0.5, 8, num_valid=n)
    assert cnt == 8  # none overlaps: the first 8 by score are kept


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['TEST', 'TRAIN'])
def test_proposal_layer_with_the_kernel_equals_the_plain_loop(dev, mode):
    cfg = parity_config()
    inputs = proposal_inputs(cfg, 11, dev)
    _, want = proposal_nms_calls(cfg, mode, inputs)
    got = ProposalLayer(cfg, mode)(*inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int(got[2].min()) > 0


@pytest.mark.cuda
def test_launches_two_a_scan_and_none_rotated(dev):
    cfg = parity_config()
    inputs = proposal_inputs(cfg, 3, dev)
    with trace.recording() as rec:
        ProposalLayer(cfg, 'TEST')(*inputs)
    assert rec.snapshot()['counts'][(None, 'launches.nms_bev_kernel')] == 2 * 2
    boxes = torch.rand(300, 5, device=dev) * 10
    boxes[:, 2:4] += boxes[:, 0:2]
    with trace.recording() as rec:
        nms.nms_bev(boxes, torch.rand(300, device=dev), 0.3, 50, rotated=True)
    assert rec.snapshot()['counts'][(None, 'launches.nms_bev_kernel')] == 0
