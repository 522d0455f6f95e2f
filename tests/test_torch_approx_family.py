"""The rest of the approximation family, ops and tools: partitioned FPS,
the nearest-first nested ball (``ball_query_nested`` with
``nested_prefix_select``), ``block_local_window_query`` and
``block_local_group_nested`` of the port against the JAX package's on the
CPU, and the pin's ``fps`` / ``fpwin`` / ``--speed-mode`` cells and the
campaign's command lines against the JAX scripts'.

Partitioned FPS and the window query are held index for index to JAX as it
runs. The nested ball's keys are bf16: JAX's ``lax.approx_max_k`` reorders
their ties off the TPU, so its ``idx`` and ``cnts`` are held index for
index with ``approx_max_k`` replaced by its stable form (``lax.top_k``:
the lowest index first among equal keys), which is what the port computes,
and as multisets of their keys unpatched (``test_torch_approx_queries.py``
says why). ``block_local_group_nested`` takes ``lax.top_k`` itself with
``approx=False`` and ``approx_max_k`` with ``approx=True`` (patched to the
stable form); its rows, gathered by JAX with one-hot matmuls and by the
port by index, are equal bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.ops import block_local as jbl
from epnet_tpu.ops import pointops as jpo
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.ops import block_local as tbl
from epnet_tpu_torch.ops import fps as tfps
from epnet_tpu_torch.ops import morton as tmorton
from epnet_tpu_torch.ops import pointops as tpo
from epnet_tpu_torch.tools import ap_pin_campaign as tcamp
from epnet_tpu_torch.tools import synthetic_ap_pin as tpin
from epnet_tpu_torch.utils.testing import structured_scene

from test_torch_approx_queries import ENV, _stable_max_k
from test_torch_bridge import one_torch_thread
from test_torch_train_cli import _jax_pin_commands


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture
def approx(monkeypatch):
    """JAX on its approximate paths, as it runs off the TPU."""
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', False)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def stable(approx, monkeypatch):
    monkeypatch.setattr(jax.lax, 'approx_max_k', _stable_max_k)


# ---------------------------------------------------------------------------
# partitioned FPS
# ---------------------------------------------------------------------------

def _lattice(B=2, N=512):
    """Points on a 4 x 8 x 8 integer lattice, each twice (exactly equal
    distances everywhere)."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(8), np.arange(8), indexing='ij'),
                 -1).reshape(-1, 3).astype(np.float32)
    return np.broadcast_to(np.concatenate([g, g])[:N], (B, N, 3)).copy()


FPS_CASES = {  # (cloud, npoint): each group's FPS, or plain FPS where a count is indivisible
    'scene': (lambda: np.stack([structured_scene(np.random.RandomState(s), 1024)[0]
                                for s in (0, 1)]), 128),
    'ties': (_lattice, 64),
    'n_indivisible': (lambda: np.random.RandomState(2).randn(2, 644, 3).astype(np.float32), 64),
    'npoint_indivisible': (lambda: np.random.RandomState(3).randn(2, 640, 3)
                           .astype(np.float32), 60),
}


@pytest.mark.parametrize('case', list(FPS_CASES))
def test_partitioned_fps_identical(case):
    """``groups=8``: the picks equal JAX's, index for index and in order;
    partitioned, each round holds one pick of every group (pick j * 8 + g
    lies in group g), and the picks differ from plain FPS's."""
    make, npoint = FPS_CASES[case]
    xyz = make()
    want = np.asarray(jpo.furthest_point_sample(jnp.asarray(xyz), npoint, groups=8))
    got = tfps.furthest_point_sample(torch.from_numpy(xyz), npoint, groups=8)
    assert got.dtype == torch.int64 and got.shape == (2, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tfps.furthest_point_sample(torch.from_numpy(xyz), npoint).numpy()
    if case.endswith('indivisible'):
        np.testing.assert_array_equal(want, plain)
    else:
        assert (want % 8 == np.arange(npoint) % 8).all()
        assert not np.array_equal(want, plain)
        assert len(np.unique(want[0])) == npoint


# ---------------------------------------------------------------------------
# the nearest-first nested ball
# ---------------------------------------------------------------------------

RADII, NSAMPLES = (0.3, 0.6), (8, 16)


def _ball_cloud(case):
    """(xyz, centroids): 'random' in a 2 m box; 'ties' on a 0.1 m lattice
    (each distance many times over, and more ties after the bf16
    rounding); 'bf16' bf16-valued coordinates; 'sparse' with empty and
    short balls (centroids far out and on isolated points)."""
    rng = np.random.RandomState({'random': 0, 'ties': 1, 'bf16': 2, 'sparse': 3}[case])
    if case == 'ties':
        xyz = (rng.randint(0, 12, (2, 700, 3)) * 0.1).astype(np.float32)
    else:
        xyz = rng.uniform(-1, 1, (2, 700, 3)).astype(np.float32)
    new = np.take_along_axis(xyz, rng.randint(0, 700, (2, 24))[..., None], 1).copy()
    if case == 'bf16':
        xyz = np.asarray(jnp.asarray(xyz, jnp.bfloat16).astype(jnp.float32))
        new = np.asarray(jnp.asarray(new, jnp.bfloat16).astype(jnp.float32))
    if case == 'sparse':
        xyz *= 6.0
        new = np.take_along_axis(xyz, rng.randint(0, 700, (2, 24))[..., None], 1).copy()
        new[:, :4] = 40.0
    return xyz, new


def _keys(xyz, new, idx):
    """Each slot's bf16 key as JAX computes it, for multiset comparisons."""
    inv = jnp.float32(1.0 / RADII[-1])
    d2n = np.asarray(jpo._pairwise_d2(jnp.asarray(new) * inv, jnp.asarray(xyz) * inv))
    k = np.asarray(jnp.asarray(-d2n).astype(jnp.bfloat16).astype(jnp.float32))
    return np.take_along_axis(k, np.asarray(idx), -1)


@pytest.mark.parametrize('case', ['random', 'ties', 'bf16', 'sparse', 'chunked'])
def test_ball_query_nested_stable(case, stable, monkeypatch):
    """``idx`` and ``cnts`` index for index with JAX's stable selection;
    each scale's rows from ``nested_prefix_select`` equal JAX's."""
    xyz, new = _ball_cloud('random' if case == 'chunked' else case)
    kw = {}
    if case == 'chunked':  # M = 24 in JAX chunks of 4, the port's of 6
        real = jpo._chunk_size
        monkeypatch.setattr(jpo, '_chunk_size', lambda total, budget: real(total, 4))
        kw = {'max_block_elems': 6 * xyz.shape[0] * xyz.shape[1]}
    want_idx, want_cnts = jpo.ball_query_nested(RADII, NSAMPLES, jnp.asarray(xyz),
                                                jnp.asarray(new))
    got_idx, got_cnts = tpo.ball_query_nested(RADII, NSAMPLES, torch.from_numpy(xyz),
                                              torch.from_numpy(new), **kw)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for g, w in zip(got_cnts, want_cnts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    feats = np.random.RandomState(9).randn(*xyz.shape[:2], 5).astype(np.float32)
    table = np.concatenate([xyz, feats], -1)
    full = jpo.group_points(jnp.asarray(table), want_idx)
    for i, s in enumerate(NSAMPLES):
        outer = i == len(NSAMPLES) - 1
        rows = np.asarray(jp2.nested_prefix_select(full, s, want_cnts[i], outer))
        idx = tp2.nested_prefix_select(got_idx[..., None], s, got_cnts[i], outer)[..., 0]
        np.testing.assert_array_equal(tpo.group_points(torch.from_numpy(table), idx).numpy(),
                                      rows)
        np.testing.assert_array_equal(
            tp2.nested_prefix_select(torch.from_numpy(np.array(full)), s, got_cnts[i],
                                     outer).numpy(), rows)
    # not vacuous
    cnt_in, cnt_out = (c.numpy() for c in got_cnts)
    keys = _keys(xyz, new, got_idx.numpy())
    if case == 'ties':
        assert (np.diff(keys, axis=-1)[keys[..., 1:] > -2] == 0).any()  # equal keys kept
    if case == 'sparse':
        assert (cnt_out == 0).any() and ((cnt_out > 0) & (cnt_out < 16)).any()
        assert (got_idx.numpy()[cnt_out == 0] == 0).all()
    else:
        assert (cnt_out == 16).any() and (cnt_in < 16).any()
    if case == 'random':  # an inner scale both short and overflowing
        assert (cnt_in < 8).any() and (cnt_in > 8).any()
    live = np.arange(1, 16) < cnt_out[..., None]
    assert (np.diff(keys, axis=-1)[live] <= 0).all()  # nearest first


def test_ball_query_nested_multisets_unpatched(approx):
    """JAX as it runs: its bf16-key selection agrees with the port's as
    multisets of each ball's keys, and the counts are equal."""
    xyz, new = _ball_cloud('ties')
    want_idx, want_cnts = jpo.ball_query_nested(RADII, NSAMPLES, jnp.asarray(xyz),
                                                jnp.asarray(new))
    got_idx, got_cnts = tpo.ball_query_nested(RADII, NSAMPLES, torch.from_numpy(xyz),
                                              torch.from_numpy(new))
    np.testing.assert_array_equal(np.sort(_keys(xyz, new, got_idx.numpy()), -1),
                                  np.sort(_keys(xyz, new, want_idx), -1))
    for g, w in zip(got_cnts, want_cnts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ball_policies():
    """'nearest' is a policy of the port, an unknown name raises."""
    assert tpo.BALL_POLICIES == ('first_nested', 'first_multi', 'nearest')
    assert tpo.check_ball_policy('nearest') == 'nearest'
    with pytest.raises(ValueError, match='nearest'):
        tpo.check_ball_policy('nearest_first')


# ---------------------------------------------------------------------------
# block-local: the window query and the nested grouping
# ---------------------------------------------------------------------------

def _sorted_scene(seed, n):
    pts, _, _ = structured_scene(np.random.RandomState(seed), n, n_cars=5)
    return pts[tmorton.morton_argsort_np(pts)]


def _roi_tables(seed, T=4, N=128, M=32):
    """Spatially ordered tables (runs of a sorted scene) with ascending
    centroid positions; the first row's windows clip at 0, the second's at
    N - W."""
    xyz = _sorted_scene(seed, 4096)
    rng = np.random.RandomState(seed + 1)
    first = np.sort(rng.choice(4096 - N, T, replace=False))
    tables = np.stack([xyz[f:f + N] for f in first])
    parents = np.stack([np.sort(rng.choice(N, M, replace=False)) for _ in range(T)])
    parents[0], parents[1] = np.arange(M), np.arange(N - M, N)
    return tables, parents


@pytest.mark.parametrize('radius,nsample', [(0.2, 16), (0.8, 8), (0.01, 16)],
                         ids=['recipe', 'crowded', 'mostly_empty'])
def test_block_local_window_query_identical(radius, nsample):
    """``(idx_rel, starts, cnt)`` bit for bit, with the centroids gathered
    from ``parent_idx`` and given (four of them far from every point: empty
    balls)."""
    tables, parents = _roi_tables(1)
    W, bc = 64, 8
    cen = np.take_along_axis(tables, parents[..., None], 1)
    cen[2, :4] = 100.0
    for c in (None, cen):
        want = jbl.block_local_window_query(radius, nsample, jnp.asarray(tables),
                                            jnp.asarray(parents, jnp.int32),
                                            None if c is None else jnp.asarray(c), W, bc)
        got = tbl.block_local_window_query(radius, nsample, torch.from_numpy(tables),
                                           torch.from_numpy(parents),
                                           None if c is None else torch.from_numpy(c), W, bc)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx_rel, starts, cnt = (np.asarray(w) for w in want)
    assert starts.min() == 0 and starts.max() == 128 - W and idx_rel.max() < W
    assert (cnt[2, :4] == 0).all() and (idx_rel[2, :4] == 0).all()
    short = (cnt > 0) & (cnt < nsample)
    assert short.any() and ((cnt == nsample).any() or radius != 0.8)  # crowded: full balls


@pytest.mark.parametrize('approx_sel', [False, True], ids=['top_k', 'approx_max_k'])
@pytest.mark.parametrize('fdtype', ['f32', 'bf16'])
def test_block_local_group_nested_identical(approx_sel, fdtype, monkeypatch):
    """The rows (xyz and features) and counts bit for bit, the first
    block's window clipped at 0; JAX's ``approx_max_k`` in its stable
    form."""
    monkeypatch.setattr(jax.lax, 'approx_max_k', _stable_max_k)
    xyz = _sorted_scene(3, 2048)[None]
    rng = np.random.RandomState(4)
    feats = rng.randn(1, 2048, 6).astype(np.float32)
    parents = np.sort(rng.choice(2048, 512, replace=False))[None]
    parents[0, :64] = np.arange(64)
    jdt, tdt = (jnp.float32, torch.float32) if fdtype == 'f32' else (jnp.bfloat16, torch.bfloat16)
    radii, nsamples = (0.5, 1.0), (8, 16)
    gx, gf, cnts = jbl.block_local_group_nested(
        radii, nsamples, jnp.asarray(xyz), jnp.asarray(feats).astype(jdt),
        jnp.asarray(parents, jnp.int32), window=256, block_c=64, approx=approx_sel)
    tx, tf, tc = tbl.block_local_group_nested(
        radii, nsamples, torch.from_numpy(xyz), torch.from_numpy(feats).to(tdt),
        torch.from_numpy(parents), window=256, block_c=64, approx=approx_sel)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(tf.float().numpy(), np.asarray(gf.astype(jnp.float32)))
    assert tf.dtype == tdt
    for g, w in zip(tc, cnts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c_in, c_out = (np.asarray(c) for c in cnts)
    assert (c_out == 16).any() and (c_out < 16).any() and (c_in < c_out).any()
    _, tf_none, _ = tbl.block_local_group_nested(
        radii, nsamples, torch.from_numpy(xyz), None, torch.from_numpy(parents),
        window=256, block_c=64)
    assert tf_none is None


# ---------------------------------------------------------------------------
# the pin and the campaign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('argv', [['--knobs', 'fps'], ['--knobs', 'fpwin'],
                                  ['--knobs', 'fps,queries,fpwin'], ['--speed-mode'],
                                  ['--speed-mode', '--knobs', 'residual']],
                         ids=['fps', 'fpwin', 'fps_queries_fpwin', 'speed', 'speed_knobs'])
def test_pin_cells_equal_jax_lists(argv, tmp_path, capsys):
    """The pin's train and eval argv equal the JAX pin's recorded command
    lines, and the port's pin passes them to its CLIs."""
    jtrain, jeval, jresult = _jax_pin_commands(argv, tmp_path, capsys)
    args = tpin.parse_args(['--workdir', str(tmp_path)] + argv)
    data, out = str(tmp_path / 'seed0' / 'data'), str(tmp_path / 'seed0' / 'out')
    ckpt = os.path.join(out, 'ckpt', 'checkpoint_epoch_39')
    assert tpin.train_argv(args, data, out) == jtrain[2:]
    assert tpin.eval_argv(args, data, out, ckpt) == jeval[2:]
    if argv[0] == '--speed-mode':
        assert jtrain[-11:] == ['--set'] + tpin.SPEED_MODE and jresult['config'] == 'speed'


def test_pin_ball_policy_reaches_both_clis(tmp_path):
    args = tpin.parse_args(['--workdir', str(tmp_path), '--knobs', 'queries',
                            '--ball_policy', 'nearest', '--device', 'cpu'])
    for argv in (tpin.train_argv(args, 'd', 'o'), tpin.eval_argv(args, 'd', 'o', 'c')):
        i = argv.index('--set')
        assert argv[i - 4:i] == ['--device', 'cpu', '--ball_policy', 'nearest']
    assert '--ball_policy' not in tpin.train_argv(tpin.parse_args([]), 'd', 'o')
    with pytest.raises(SystemExit):
        tpin.parse_args(['--ball_policy', 'first'])


def test_campaign_builds_pin_commands(tmp_path, monkeypatch, capsys):
    """The ladder runs the pin once a seed and cell (``--skip`` honoured),
    logs each run under its workdir, and prints the paired table of
    moderate deltas; the pin's argv are the ones its parser reads."""
    calls = []
    ap = {'parity': [5.0, 13.0, 13.0], 'block,queries': [6.0, 15.5, 15.0],
          'speed': [2.0, 6.5, 6.0]}

    class Done:
        returncode = 0
        stderr = ''

        def __init__(self, cell):
            self.stdout = 'noise\n' + json.dumps(
                {'metric': 'synthetic Car 3D AP R40 (easy/moderate/hard)', 'value': ap[cell]})

    def run(cmd, cwd, **kwargs):
        assert cwd == tcamp.REPO and cmd[1:3] == ['-m', 'epnet_tpu_torch.tools.synthetic_ap_pin']
        calls.append(cmd)
        cell = 'speed' if '--speed-mode' in cmd else (
            cmd[cmd.index('--knobs') + 1] if '--knobs' in cmd else 'parity')
        return Done(cell)

    monkeypatch.setattr(tcamp.subprocess, 'run', run)
    work = tmp_path / 'camp'
    lines = tcamp.main(['--seeds', '0', '1', '--epochs', '2', '--cells', 'parity',
                        'block,queries', 'speed', '--skip', 'speed:1',
                        '--workdir', str(work)])
    assert len(calls) == 5
    pin_args = tpin.parse_args(calls[1][3:])
    assert (pin_args.seed, pin_args.epochs, pin_args.val, pin_args.knobs) == (0, 2, 72,
                                                                             'block,queries')
    assert pin_args.workdir == str(work / 'block_queries')
    assert tpin.parse_args(calls[2][3:]).speed_mode
    recs = [json.loads(x) for x in (work / 'campaign.jsonl').read_text().splitlines()]
    assert [(r['cell'], r['seed']) for r in recs] == [
        ('parity', 0), ('block,queries', 0), ('speed', 0), ('parity', 1), ('block,queries', 1)]
    assert lines[1:] == ['0 | block,queries | [5.0, 13.0, 13.0] | [6.0, 15.5, 15.0] | +2.5',
                         '1 | block,queries | [5.0, 13.0, 13.0] | [6.0, 15.5, 15.0] | +2.5',
                         '0 | speed | [5.0, 13.0, 13.0] | [2.0, 6.5, 6.0] | -6.5']
    assert capsys.readouterr().out.rstrip().endswith(lines[-1])
