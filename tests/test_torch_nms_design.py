"""The design of the NMS kernel (``epnet_tpu_torch/csrc/nms.cu``), emulated
on the CPU, since the kernel runs only on the card.

The emulation follows the kernel: the score-sorted (N, 5) boxes read where
they lie at any N; a removed-bitmap of ceil(num_valid / 64)
uint64 words whose bits past num_valid start set; the next kept box found
as the first clear bit above the last one, 32 words a ballot, the first
word with a clear bit, then its lowest clear bit; each kept box's pass over
the 32-aligned chunks from the one holding i + 1, each chunk's hits (IoU >
thresh in f32, every operation rounded on its own, j > i) packed into 32
bits and ORed into their word at bit 0 or 32; the walk stops at max_keep
kept or when no clear bit is left.

It gives the plain loop's keep lists (``nms_bev_plain``) and the JAX
package's (``epnet_tpu/ops/nms.py::nms_bev``), index for index and count
for count, through the wrapper's padding (``keep_indices``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.ops.nms import nms_bev as j_nms
from epnet_tpu_torch.ops.nms import keep_indices, nms_bev, nms_bev_plain

ALL = (1 << 64) - 1


def iou_f32(a, b):
    """``iou_axis_aligned`` of box a against the rows of b, in f32, each
    operation rounded; np.maximum / np.minimum propagate NaN as the
    kernel's tmax / tmin do."""
    zero, eps = np.float32(0), np.float32(1e-8)
    lx, rx = np.maximum(a[0], b[:, 0]), np.minimum(a[2], b[:, 2])
    ly, ry = np.maximum(a[1], b[:, 1]), np.minimum(a[3], b[:, 3])
    inter = np.maximum(rx - lx, zero) * np.maximum(ry - ly, zero)
    sa = (a[2] - a[0]) * (a[3] - a[1])
    sb = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum((sa + sb) - inter, eps)


def design_nms(sb, num_valid, thresh, max_keep):
    """The kernel's walk over score-sorted (N, 5) f32 boxes: (ranks, count)."""
    n = num_valid
    thresh = np.float32(thresh)
    nw = -(-n // 64)
    removed = [0] * nw
    if n % 64:
        removed[-1] = (ALL << (n % 64)) & ALL
    ranks, i = [], -1
    with np.errstate(invalid='ignore', divide='ignore'):
        while len(ranks) < max_keep:
            s, nxt = i + 1, n
            for base in range(s >> 6, nw, 32):  # one ballot over 32 words
                free = [~removed[w] & ALL for w in range(base, min(base + 32, nw))]
                if base == s >> 6:
                    free[0] &= (ALL << (s & 63)) & ALL
                lanes = [lane for lane, f in enumerate(free) if f]
                if lanes:
                    g = free[lanes[0]]
                    nxt = ((base + lanes[0]) << 6) + (g & -g).bit_length() - 1
                    break
            if nxt >= n:
                break
            i = nxt
            ranks.append(i)
            if len(ranks) == max_keep:
                break
            start = int(i + 1) & ~31
            j = np.arange(start, -(-n // 32) * 32)
            live = (j > i) & (j < n)
            over = np.zeros(j.shape, bool)
            over[live] = iou_f32(sb[i], sb[j[live]]) > thresh
            for c, bits in enumerate(over.reshape(-1, 32)):  # a warp's ballot a chunk
                m = sum(1 << int(lane) for lane in np.flatnonzero(bits))
                jb = start + 32 * c
                removed[jb >> 6] |= m << (jb & 32)
    return ranks, len(ranks)


def design_nms_bev(boxes, scores, thresh, max_keep, num_valid=None):
    """``nms_bev_kernel``'s result with the walk emulated: (idx, count)."""
    order = torch.argsort(-torch.from_numpy(scores), stable=True)
    sb = boxes[order.numpy()]
    n = len(boxes)
    nv = n if num_valid is None else min(max(int(num_valid), 0), n)
    ranks, count = design_nms(sb, nv, thresh, max_keep)
    r = torch.zeros(max_keep, dtype=torch.int64)
    r[:count] = torch.tensor(ranks, dtype=torch.int64)
    return keep_indices(order, r, count, max_keep).numpy(), count


def _boxes(rng, n, spread=10.0, size=(1.0, 4.0)):
    ctr = rng.uniform(-spread, spread, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    bev = np.concatenate([ctr - wh / 2, ctr + wh / 2, rng.uniform(-3, 3, (n, 1))], 1)
    return bev.astype(np.float32)


def _proposal_like(rng, n, num_valid):
    """Clusters of jittered boxes around a few cars, as the RPN decodes
    them, with the candidates past ``num_valid`` parked as the proposal
    layer parks them (-inf score, far away)."""
    cars = rng.uniform(-30, 30, (24, 2))
    ctr = cars[rng.randint(0, 24, n)] + rng.normal(0, 0.3, (n, 2))
    wh = np.array([3.9, 1.6]) * rng.uniform(0.85, 1.15, (n, 2))
    bev = np.concatenate([ctr - wh / 2, ctr + wh / 2, rng.uniform(-3, 3, (n, 1))], 1)
    scores = rng.rand(n).astype(np.float32)
    bev[num_valid:] = [1e6 - 0.5, 1e6 - 0.5, 1e6 + 0.5, 1e6 + 0.5, 0.0]
    scores[num_valid:] = -np.inf
    return bev.astype(np.float32), scores


def _on_thresh(thresh):
    """Pairs whose IoU is exactly f32(thresh) (a box of width w inside one
    of width W, w / W = thresh), each beside a pair just above it: the
    first are kept (IoU > thresh is false in f32), the second suppressed."""
    w, W = {0.5: (2, 4), 0.8: (4, 5), 0.85: (17, 20)}[thresh]
    rows, scores = [], []
    for k in range(6):
        x = 40.0 * k
        rows += [[x, 0, x + W, 1, 0], [x, 0, x + w, 1, 0], [x, 5, x + W, 6, 0],
                 [x, 5, x + w + 0.01 * W, 6, 0]]
        scores += [4 * k + 3, 4 * k + 2, 4 * k + 1, 4 * k + 0.5]
    return np.array(rows, np.float32), np.array(scores, np.float32)


def _case(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == 'tied_scores':
        bev, s = _boxes(rng, 300), rng.rand(300).astype(np.float32)
        s[10:120] = s[10]  # ties keep input order (stable sort)
        s[200:] = 0.25
        return bev, s, 0.3, 90, None
    if name == 'num_valid_mid_word':
        bev, s = _proposal_like(rng, 256, 100)  # 100 = a word and 36 bits
        return bev, s, 0.1, 256, 100
    if name == 'max_keep_mid_word_and_block':
        bev, s = _boxes(rng, 400, spread=40.0), rng.rand(400).astype(np.float32)
        return bev, s, 0.5, 37, None  # 37 kept of a first block that keeps more
    if name == 'n_203':
        bev, s = _boxes(rng, 203), rng.rand(203).astype(np.float32)
        return bev, s, 0.2, 150, None
    if name == 'nothing_kept':
        bev, s = _proposal_like(rng, 128, 0)
        return bev, s, 0.85, 50, 0
    if name == 'max_keep_above_n':
        bev, s = _boxes(rng, 20), rng.rand(20).astype(np.float32)
        return bev, s, 0.5, 64, None
    if name.startswith('on_thresh_'):
        t = float(name.rsplit('_', 1)[1])
        bev, s = _on_thresh(t)
        return bev, s, t, 100, None
    if name == 'nan_box':
        bev, s = _boxes(rng, 150), rng.rand(150).astype(np.float32)
        bev[7, 2] = np.nan
        bev[40, 0] = np.nan
        return bev, s, 0.2, 150, None
    if name == 'train_budget_near':
        bev, s = _proposal_like(rng, 6300, 5000)
        return bev, s, 0.85, 358, 5000
    if name == 'test_budget_far':
        bev, s = _proposal_like(rng, 2700, 1900)
        return bev, s, 0.8, 30, 1900
    if name == 'above_smem':
        # above the 14,415 boxes that a copy in a block's shared memory would
        # hold: the kernel reads them at any N, so no second path starts here
        n = 14415 + 101
        bev, s = _boxes(rng, n, spread=60.0), rng.rand(n).astype(np.float32)
        return bev, s, 0.3, 40, None
    raise KeyError(name)


CASES = ['tied_scores', 'num_valid_mid_word', 'max_keep_mid_word_and_block', 'n_203',
         'nothing_kept', 'max_keep_above_n', 'on_thresh_0.5', 'on_thresh_0.8',
         'on_thresh_0.85', 'nan_box', 'train_budget_near', 'test_budget_far', 'above_smem']


@pytest.mark.parametrize('name', CASES)
def test_design_keeps_as_plain_and_jax(name):
    bev, scores, thresh, max_keep, num_valid = _case(name)
    idx, count = design_nms_bev(bev, scores, thresh, max_keep, num_valid)
    p_idx, p_cnt = nms_bev_plain(torch.from_numpy(bev), torch.from_numpy(scores), thresh,
                                 max_keep, num_valid=num_valid)
    j_idx, j_cnt = j_nms(jnp.asarray(bev), jnp.asarray(scores), thresh, max_keep,
                         num_valid=num_valid)
    assert count == p_cnt == int(j_cnt)
    np.testing.assert_array_equal(idx, p_idx.numpy())
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    # nms_bev takes the plain loop for a CPU tensor
    c_idx, c_cnt = nms_bev(torch.from_numpy(bev), torch.from_numpy(scores), thresh, max_keep,
                           num_valid=num_valid)
    assert c_cnt == count
    np.testing.assert_array_equal(c_idx.numpy(), idx)


def test_cases_are_not_vacuous():
    """The edge cases reach what they name: the cut mid-word, max_keep
    filled inside a block whose loop keeps more, the exact-threshold pairs
    kept and their neighbours above it suppressed, ties among the kept."""
    bev, s, thresh, mk, nv = _case('max_keep_mid_word_and_block')
    _, full = design_nms(bev[np.argsort(-s, kind='stable')], len(bev), thresh, 10 ** 6)
    assert full > 64 and mk % 64
    bev, s, thresh, mk, nv = _case('on_thresh_0.8')
    ranks, count = design_nms(bev[np.argsort(-s, kind='stable')], len(bev), thresh, mk)
    assert count == 18  # per group: the wide box, the box exactly on thresh, the wide one
    assert iou_f32(bev[0], bev[1:2])[0] == np.float32(0.8)
    bev, s, thresh, mk, nv = _case('tied_scores')
    idx, count = design_nms_bev(bev, s, thresh, mk, nv)
    assert count == mk and len(set(idx[:count]) & set(range(10, 120))) > 5
    bev, s, thresh, mk, nv = _case('num_valid_mid_word')
    _, count = design_nms_bev(bev, s, thresh, mk, nv)
    assert 0 < count < nv < len(bev)


@pytest.mark.parametrize('count,max_keep,n', [(0, 5, 8), (3, 5, 8), (5, 5, 8), (2, 12, 8),
                                              (8, 12, 8), (0, 12, 8), (1, 1, 1)])
def test_keep_indices_pads_as_plain(count, max_keep, n):
    """The wrapper's padding from (ranks, count) equals ``nms_bev_plain``'s
    from its kept mask: slots past count repeat the first kept box, nothing
    kept gives order[N - 1], max_keep > N repeats the last slot."""
    rng = np.random.RandomState(count * 100 + max_keep * 10 + n)
    # boxes far apart (none overlaps): the first `count` by score are kept
    bev = np.array([[10 * k, 0, 10 * k + 1, 1, 0] for k in range(n)], np.float32)
    scores = rng.permutation(n).astype(np.float32)
    p_idx, p_cnt = nms_bev_plain(torch.from_numpy(bev), torch.from_numpy(scores), 0.5,
                                 max_keep, num_valid=count)
    order = torch.argsort(-torch.from_numpy(scores), stable=True)
    ranks = torch.full((max_keep,), -12345, dtype=torch.int64)  # the kernel leaves the rest
    ranks[:count] = torch.arange(count)
    assert p_cnt == count
    np.testing.assert_array_equal(keep_indices(order, ranks, count, max_keep).numpy(),
                                  p_idx.numpy())
