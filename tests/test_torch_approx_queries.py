"""The approximate query family (``EXACT_QUERIES`` false) of
``epnet_tpu_torch/ops/pointops.py`` and ``ops/roipool3d.py`` against the
JAX package's, on the CPU.

JAX selects with ``lax.approx_max_k`` / ``approx_min_k``. Off the TPU they
return ``lax.top_k``'s selection on distinct keys, but not on equal ones:
over bf16 keys (the ball queries' rounded ``-index`` keys, the approximate
``three_nn``'s rounded field) they may pick another member of a tie, or
the same members in another order. So:

* the f32-key paths (``ball_query_nested_first_hit`` with
  ``nested_radius_select``, roipool's first k) are held index for index to
  JAX as it runs;
* the bf16-key paths (``ball_query``, ``ball_query_multi``, ``three_nn``)
  index for index to JAX with both functions replaced by their stable form
  (``lax.top_k``: the lowest index first among equal keys), which is what
  the port computes, and as value multisets to JAX as it runs.

Every test pins JAX's module state ``EXACT_QUERIES`` with ``monkeypatch``
and unsets the ``EPNET_*`` switches the approximate paths read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from epnet_tpu.models import target_assign as jta
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.roipool3d import roipool3d as j_roipool3d
from epnet_tpu_torch.models import target_assign as tta
from epnet_tpu_torch.ops import pointops as tpo
from epnet_tpu_torch.ops.roipool3d import roipool3d as t_roipool3d
from epnet_tpu_torch.utils.testing import tiny_config

from test_torch_target_assign import _jax_draws, _scene

ENV = ('EPNET_BALL_POLICY', 'EPNET_BALL_NESTED', 'EPNET_BALL_F32', 'EPNET_BALL_RECALL',
       'EPNET_3NN_F32', 'EPNET_3NN_RECALL', 'EPNET_ROIPOOL_RECALL', 'EPNET_EXACT_OPS')


def _stable_max_k(operand, k, **kwargs):
    return lax.top_k(operand, k)


def _stable_min_k(operand, k, **kwargs):
    v, i = lax.top_k(-operand, k)
    return -v, i


@pytest.fixture
def approx(monkeypatch):
    """JAX on its approximate paths, as it runs off the TPU."""
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', False)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def stable(approx, monkeypatch):
    """JAX's approximate selections made stable (``lax.top_k``)."""
    monkeypatch.setattr(jax.lax, 'approx_max_k', _stable_max_k)
    monkeypatch.setattr(jax.lax, 'approx_min_k', _stable_min_k)


def _cloud(seed, B=2, N=600, M=21, spread=1.0, dtype=np.float32):
    """Points in a 2 m box with a tenth of them duplicated (ties), and
    centroids drawn among them; N > 256 so that bf16 ``-index`` keys tie."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    dup = rng.randint(0, N, (B, N // 10))
    xyz[:, -N // 10:] = np.take_along_axis(xyz, dup[..., None], 1)
    new = np.take_along_axis(xyz, rng.randint(0, N, (B, M))[..., None], 1)
    new = new + rng.randn(B, M, 3).astype(np.float32) * 0.05
    if dtype is not np.float32:
        xyz = np.asarray(jnp.asarray(xyz, dtype).astype(jnp.float32))
        new = np.asarray(jnp.asarray(new, dtype).astype(jnp.float32))
    return xyz, new


def _nested_cloud():
    """Centroid 0 at the origin: its first outer hits lie outside the inner
    radius and its inner hits come later in index order, so the inner ball
    extends past the first s_max outer hits (the gathered rows keep only 2
    of its 6 members); centroid 1 far from every point (both balls empty);
    centroid 2 with no inner hit among its gathered rows."""
    B, N = 1, 64
    rng = np.random.RandomState(5)
    xyz = rng.uniform(3.0, 6.0, (B, N, 3)).astype(np.float32)
    ring = np.array([0.7, 0.0, 0.0], np.float32)
    xyz[0, 0] = [0.05, 0, 0]                 # inner
    xyz[0, 1:5] = ring * [1, 1, 1]           # outer only, repeated
    xyz[0, 5] = [0, 0.1, 0]                  # inner
    xyz[0, 6:12] = [0.0, 0.0, 0.12]          # inner, beyond s_max outer hits
    xyz[0, 20:26] = [10.75, 0, 0]            # outer only around centroid 2
    xyz[0, 30] = [10.0, 0.05, 0]             # inner of centroid 2, late
    new = np.array([[[0, 0, 0], [-50, -50, -50], [10, 0, 0]]], np.float32)
    return xyz, new


RADII, NSAMPLES = (0.3, 1.0), (4, 6)


@pytest.mark.parametrize('case', ['random', 'nested', 'chunked', 'bf16'])
def test_nested_first_hit_and_radius_select(case, approx, monkeypatch):
    """f32 keys: JAX unpatched. The nested query's indices, then each
    scale's rows from the gathered rows, index for index and value for
    value; the port's index form of the select gathers the same rows."""
    if case == 'nested':
        xyz, new = _nested_cloud()
    else:
        xyz, new = _cloud(1, dtype=jnp.bfloat16 if case == 'bf16' else np.float32)
    kw = {}
    if case == 'chunked':  # M = 21 in JAX chunks of 3, the port's of 7
        real = jpo._chunk_size
        monkeypatch.setattr(jpo, '_chunk_size', lambda total, budget: real(total, 3))
        kw = {'max_block_elems': 7 * xyz.shape[0] * xyz.shape[1]}
    want = np.asarray(jpo.ball_query_nested_first_hit(RADII, NSAMPLES, jnp.asarray(xyz),
                                                      jnp.asarray(new)))
    got = tpo.ball_query_nested_first_hit(RADII, NSAMPLES, torch.from_numpy(xyz),
                                          torch.from_numpy(new), **kw)
    np.testing.assert_array_equal(got.numpy(), want)

    feats = np.random.RandomState(2).randn(*xyz.shape[:2], 5).astype(np.float32)
    table = np.concatenate([xyz, feats], -1)
    full = np.array(jpo.group_points(jnp.asarray(table), jnp.asarray(want)))
    gx = full[..., 0:3] - new[:, :, None, :]
    d2 = np.asarray(jnp.sum(jnp.asarray(gx) ** 2, axis=-1))
    d2_t = tpo.sq_dist(tpo.group_points(torch.from_numpy(xyz), got),
                       torch.from_numpy(new)[:, :, None, :])
    np.testing.assert_array_equal(d2_t.numpy(), d2)
    for i, r in enumerate(RADII):
        outer = i == len(RADII) - 1
        rows = np.asarray(jpo.nested_radius_select(jnp.asarray(full), jnp.asarray(d2),
                                                   float(r) ** 2, outer))
        got_rows = tpo.nested_radius_select(torch.from_numpy(full), d2_t, r, outer)
        np.testing.assert_array_equal(got_rows.numpy(), rows)
        idx = tpo.nested_radius_select(got[..., None], d2_t, r, outer)[..., 0]
        np.testing.assert_array_equal(tpo.group_points(torch.from_numpy(table), idx).numpy(),
                                      rows)
    if case == 'nested':
        inner = tpo.nested_radius_select(got[..., None], d2_t, RADII[0], False)[0, :, :, 0]
        assert inner[0].tolist() == [0, 0, 0, 0, 0, 5]  # 2 of the 8 inner points kept
        assert (got[0, 1] == 0).all() and (inner[1] == 0).all()  # empty balls: index 0
        assert inner[2].tolist() == got[0, 2, 0:1].repeat(6).tolist()  # slot 0 kept


def _rois(seed, B=2, M=6):
    """Boxes around the cloud's points: crowded (more than S points),
    short, and one far from every point (empty)."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform(-0.5, 0.5, (B, M, 3)), rng.uniform(0.3, 1.5, (B, M, 3)),
                            rng.uniform(-np.pi, np.pi, (B, M, 1))], -1).astype(np.float32)
    boxes[:, 0, 3:6] = 3.0   # holds the whole cloud
    boxes[:, -1, 0] = 40.0   # empty
    return boxes


@pytest.mark.parametrize('n,s,bf16', [(600, 64, False), (600, 64, True), (40, 64, False)],
                         ids=['crowded', 'bf16_features', 'n_below_s'])
def test_roipool_first_k(n, s, bf16, approx):
    """f32 keys: JAX unpatched. The first k in-box points by index, short
    boxes padded with slot 0, empty boxes zeros, ``cnt`` the points found
    (at most min(S, N))."""
    xyz, _ = _cloud(3, N=n)
    feats = np.random.RandomState(4).randn(*xyz.shape[:2], 5).astype(np.float32)
    boxes = _rois(5)
    fdt = jnp.bfloat16 if bf16 else jnp.float32
    want = [np.asarray(a.astype(jnp.float32)) for a in j_roipool3d(
        jnp.asarray(xyz), jnp.asarray(feats).astype(fdt), jnp.asarray(boxes), 0.2,
        sampled_pt_num=s)]
    tfeats = torch.from_numpy(feats).to(torch.bfloat16 if bf16 else torch.float32)
    got = [a.float().numpy() for a in t_roipool3d(
        torch.from_numpy(xyz), tfeats, torch.from_numpy(boxes), 0.2, sampled_pt_num=s,
        approx=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cnt = want[3]
    assert (cnt == 0).any() and ((cnt > 0) & (cnt < min(s, n))).any()
    assert cnt.max() == s if n > s else cnt.max() <= n
    exact = t_roipool3d(torch.from_numpy(xyz), tfeats, torch.from_numpy(boxes), 0.2,
                          sampled_pt_num=s)
    assert not np.array_equal(exact[1].float().numpy(), got[1])  # cycles, not pads


BF16_CASES = {'f32': dict(), 'bf16_coords': dict(dtype=jnp.bfloat16),
              'wide': dict(N=1500, M=12, spread=0.6)}


@pytest.mark.parametrize('case', list(BF16_CASES))
def test_ball_queries_stable(case, stable):
    """bf16 keys, JAX's selections made stable: ``ball_query``'s
    approximate branch and ``ball_query_multi``, index for index."""
    xyz, new = _cloud(6, **BF16_CASES[case])
    jx, jn = jnp.asarray(xyz), jnp.asarray(new)
    tx, tn = torch.from_numpy(xyz), torch.from_numpy(new)
    for r, s in ((0.2, 16), (0.5, 32)):
        np.testing.assert_array_equal(
            tpo.ball_query_approx(r, s, tx, tn).numpy(),
            np.asarray(jpo.ball_query(r, s, jx, jn, exact=False)))
    want = jpo.ball_query_multi((0.2, 0.5), (16, 32), jx, jn, exact=False)
    for (r, s), w in zip(((0.2, 16), (0.5, 32)), want):
        got = tpo.ball_query_approx(r, s, tx, tn, max_block_elems=3 * xyz.shape[0] * xyz.shape[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    # not vacuous: balls that overflow, and short balls or bf16 key ties among hits
    got = tpo.ball_query_approx(0.5, 32, tx, tn).numpy()
    assert (got[..., -1] != got[..., 0]).any()
    if case == 'wide':
        keys = np.asarray(-jnp.asarray(got, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        assert (np.diff(keys, axis=-1) == 0).any()
    else:
        assert (got[..., -1] == got[..., 0]).any()


def _three_nn_cloud(seed, B=2, N=50, M=40):
    """Knowns on a coarse lattice (many equidistant neighbours: ties in
    f32 and more after the bf16 rounding) and queries on and between them."""
    rng = np.random.RandomState(seed)
    known = (rng.randint(0, 5, (B, M, 3)) * 0.5).astype(np.float32)
    unknown = np.concatenate([known[:, :N // 2], known[:, :N - N // 2] + 0.25], 1)
    unknown[:, ::3] += rng.randn(B, len(range(0, N, 3)), 3).astype(np.float32) * 0.3
    return unknown, known


def test_three_nn_stable(stable):
    """The approximate ``three_nn`` (field clipped, rounded to bf16, three
    smallest, square roots in f32) with JAX's selection made stable:
    indices and distances identical."""
    unknown, known = _three_nn_cloud(7)
    dist, idx = jpo.three_nn(jnp.asarray(unknown), jnp.asarray(known), exact=False)
    gd, gi = tpo.three_nn(torch.from_numpy(unknown), torch.from_numpy(known), approx=True)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(dist))
    ed, _ = tpo.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert not np.array_equal(ed.numpy(), gd.numpy())  # the distances are bf16-rounded


def test_queries_as_multisets_unpatched(approx):
    """JAX as it runs: the bf16-key selections agree with the port's as
    multisets of their keys (ball queries) and of their distances
    (``three_nn``)."""
    xyz, new = _cloud(8, N=1500, M=12, spread=0.6)
    tx, tn = torch.from_numpy(xyz), torch.from_numpy(new)
    for r, s in ((0.2, 16), (0.5, 32)):
        want = np.asarray(jpo.ball_query(r, s, jnp.asarray(xyz), jnp.asarray(new), exact=False))
        got = tpo.ball_query_approx(r, s, tx, tn).numpy()

        def keys(i):
            return np.sort(np.asarray(jnp.asarray(-i, jnp.float32).astype(jnp.bfloat16)
                                      .astype(jnp.float32)), -1)

        np.testing.assert_array_equal(keys(got), keys(want))
    unknown, known = _three_nn_cloud(9)
    dist, _ = jpo.three_nn(jnp.asarray(unknown), jnp.asarray(known), exact=False)
    gd, _ = tpo.three_nn(torch.from_numpy(unknown), torch.from_numpy(known), approx=True)
    np.testing.assert_array_equal(np.sort(gd.numpy(), -1), np.sort(np.asarray(dist), -1))


def test_mask_score_reweighted(approx):
    """The target layer under the approximate policy: the pool's first k
    and pad, and ``mask_score`` reweighted by the cyclic multiplicity from
    the pool's ``cnt``; against JAX's layer on the same draws."""
    cfg = tiny_config(EXACT_QUERIES=False)
    args = _scene(0)
    key = jax.random.PRNGKey(7)
    fn = jax.jit(lambda k, *a: jta.proposal_target_layer(k, *a, cfg))
    want = {k: np.asarray(v) for k, v in fn(key, *(jnp.asarray(a) for a in args))
            ._asdict().items()}
    draws = _jax_draws(key, cfg, *args[0].shape[:2])
    got = {k: v.numpy() for k, v in tta.proposal_target_layer(
        *(torch.from_numpy(a) for a in args), cfg, draws=draws)._asdict().items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # the reweighting recovers the exact pool's statistic, which the padded
    # pool's plain mean misses
    exact = tta.proposal_target_layer(*(torch.from_numpy(a) for a in args),
                                      tiny_config(EXACT_QUERIES=True), draws=draws)
    np.testing.assert_allclose(exact.mask_score.numpy(), got['mask_score'], atol=1e-6)
    assert not np.allclose(got['pts_feature'][..., 0].mean(-1), got['mask_score'])


def test_mask_score_weights():
    """The cyclic multiplicities: a count of c in S slots weighs slot j < c
    by floor(S / c) + (j < S mod c), so the weights sum to S."""
    seg = torch.ones(1, 4, 10)
    cnt = torch.tensor([[3, 10, 0, 25]])
    got = tta.mask_score_of(seg, cnt, approx=True)
    np.testing.assert_allclose(got.numpy(), [[1.0, 1.0, 1.0, 1.0]])  # c = 3, 10, 1, 10
    seg = torch.arange(10.0).reshape(1, 1, 10)
    # c = 3: slots 0, 1, 2 weigh 4, 3, 3 (the cyclic pool 0 1 2 0 1 2 0 1 2 0)
    np.testing.assert_allclose(float(tta.mask_score_of(seg, torch.tensor([[3]]), True)),
                               (0 * 4 + 1 * 3 + 2 * 3) / 10, rtol=1e-7)


@pytest.mark.parametrize('policy,exc', [('nearest', NotImplementedError), ('first', ValueError)])
def test_ball_policy_refusals(policy, exc):
    """An unknown policy raises ValueError; 'nearest', which raised
    NotImplementedError until the nearest-first query was ported, returns."""
    if exc is NotImplementedError:
        assert tpo.check_ball_policy(policy) == policy
    else:
        with pytest.raises(exc, match='first_nested'):
            tpo.check_ball_policy(policy)
    assert tpo.check_ball_policy('first_multi') == 'first_multi'
