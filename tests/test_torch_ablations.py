"""The three research harnesses (``epnet_tpu_torch/tools/ablation.py``,
``sampling_ablation.py``, ``block_local_ablation.py``,
``block_local_fullscale.py``) against the JAX package's
``tools/sampling_ablation.py``, ``tools/block_local_ablation.py`` and
``tools/block_local_fullscale.py``, loaded by path, on the CPU.

- Configs key for key: ``MODES`` merged into the sampling base (JAX builds
  its base inside ``main``; ``_jax_sampling_base`` stops ``main`` at its
  batch and keeps the config it was given), the block-local base and its
  block-local twin, and ``cfg_for`` of every kind under both query flags
  against JAX's ``cfg_for`` under its environment switches, restored after.
- ``per_gt_iou`` against both JAX forms, on unpadded and zero-padded gt
  sets, within 1e-6.
- ``evaluate`` against JAX's ``evaluate`` (``sampling_ablation.py:62-66``)
  under bridged weights at the harness's tiny widths without the image
  stream (``NO_IMAGE``: it costs each JAX compile ~3 s and takes no part in
  what is compared), ``EXACT_QUERIES`` None (exact on the CPU in both
  packages), for the consistent ``fps`` cell and the two swaps (``fps``
  weights under ``fps-G8`` and ``random``): per-gt IoU within 1e-4 and
  every FPS call's picks identical. JAX's jitted step runs ``three_nn`` op
  by op (``_eager_three_nn``; XLA rounds the fused 3-NN field otherwise)
  and reports its picks through ``jax.debug.callback``.
- The block-local swap (``block_local_ablation.py:91-96``: the dense
  weights evaluated block-local) under ``EXACT_QUERIES`` 'residual' on both
  sides (None leaves block-local off on the CPU in both packages), JAX's
  windowed interpolation op by op, as ``test_torch_block_local_slice.py``
  runs it (at these sizes no JAX gate needs a patch: RPN sa0's block-local
  grouping is open on the CPU under 'residual', and the RCNN stays dense);
  spies assert that the block-local grouping ran on both sides.
- A 2-step ``run`` of each harness (the full-scale one on a tiny
  block-local config passed in as its base): finite losses, one IoU for
  each real gt, and the paths each kind names.

The weights are the port's initialization carried into flax variables
(``_flax_variables``, norms randomized), so that no JAX init is compiled,
and the four JAX evaluations share one module-scoped fixture (``evals``).
About 55 s alone on a quiet host, imports included (pytest's count); torch
on one thread.
"""

import ast
import concurrent.futures
import contextlib
import importlib.util
import math
import os

import jax
import numpy as np
import pytest
import torch

from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops import rotated_iou as j_rotated_iou
from epnet_tpu.ops.rotated_iou import boxes_iou3d as j_boxes_iou3d
from epnet_tpu_torch.bridge import load_flax_variables
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.models.epnet import EPNet
from epnet_tpu_torch.tools import ablation
from epnet_tpu_torch.tools import block_local_ablation as tbl
from epnet_tpu_torch.tools import block_local_fullscale as tfs
from epnet_tpu_torch.tools import sampling_ablation as tsa
from epnet_tpu_torch.utils.testing import (BLOCK_LOCAL_TINY, full_batch, synthetic_batch,
                                           tiny_config)

from test_torch_approx_family_slice import _flax_variables
from test_torch_block_local_slice import _eager_three_interp
from test_torch_bridge import one_torch_thread
from test_torch_train_step import _eager_three_nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ('ablation', 'sampling_ablation', 'block_local_ablation', 'block_local_fullscale')
IOU_TOL = 1e-4
NO_IMAGE = {'LI_FUSION': {'ENABLED': False}}


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f'jax_tool_{name}',
                                                  os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jax_tools():
    """The three JAX tools, their ``boxes_iou3d`` jitted (eager, its first
    call compiles every operation apart: ~7 s)."""
    tools = {name: _jax_tool(name) for name in TOOLS[1:]}
    for name in ('sampling_ablation', 'block_local_ablation'):
        tools[name].boxes_iou3d = jax.jit(j_boxes_iou3d)
    return tools


class _Stop(Exception):
    pass


def _jax_sampling_base(jsa):
    """The base config JAX's ``sampling_ablation.main`` builds, taken from
    its call to ``synthetic_batch``, which stops it there."""
    def stop(rng, cfg, **kwargs):
        raise _Stop(cfg)

    mp = pytest.MonkeyPatch()
    mp.setattr(jsa, 'synthetic_batch', stop)
    try:
        jsa.main()
    except _Stop as e:
        return e.args[0]
    finally:
        mp.undo()
    raise AssertionError('sampling_ablation.main built no batch')


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_sampling_configs_match_jax(jax_tools):
    jsa = jax_tools['sampling_ablation']
    jbase = _jax_sampling_base(jsa)
    assert tsa.base_config().asdict() == jbase.asdict()
    assert [n for n, _ in tsa.MODES] == [n for n, _ in jsa.MODES]
    for (_, over), (_, jover) in zip(tsa.MODES, jsa.MODES):
        assert over == jover
        assert (tsa.base_config().merged({'RPN': over}).asdict()
                == jbase.merged({'RPN': jover}).asdict())


def test_block_local_configs_match_jax(jax_tools):
    jbl = jax_tools['block_local_ablation']
    assert tbl.base_config().asdict() == jbl.base_config().asdict()
    over = {'RPN': {'BLOCK_LOCAL': True}}
    assert tbl.base_config().merged(over).asdict() == jbl.base_config().merged(over).asdict()


@pytest.mark.parametrize('queries', ['0', 'residual'])
@pytest.mark.parametrize('kind', list(tfs.KINDS))
def test_fullscale_cfg_for_matches_jax(jax_tools, monkeypatch, kind, queries):
    """``cfg_for(kind)`` against JAX's under ``EPNET_EXACT_QUERIES``
    (``__graft_entry__._full_config`` reads it; '0' is its default, False);
    ``fp_block`` is JAX's ``EPNET_FP_BLOCK`` as ``cfg_for`` leaves it."""
    for k in ('EPNET_FPS_GROUPS', 'EPNET_FP_WINDOW', 'EPNET_FP_UBLOCK', 'EPNET_FP_BLOCK',
              'EPNET_BLOCK_LOCAL', 'EPNET_RCNN_WIN'):
        monkeypatch.delenv(k, raising=False)  # JAX's cfg_for sets them: restored after
    monkeypatch.setenv('EPNET_EXACT_QUERIES', queries)
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', jpo.EXACT_QUERIES)  # _full_config sets it
    want = jax_tools['block_local_fullscale'].cfg_for(kind)
    cfg, fp_block = tfs.cfg_for(kind, {'0': False, 'residual': 'residual'}[queries])
    assert cfg.asdict() == want.asdict()
    assert fp_block == (os.environ.get('EPNET_FP_BLOCK') != '0')


@pytest.mark.parametrize('kind', ['block_rcnn', 'rcnn', ''])
def test_fullscale_refuses_other_kinds(kind):
    with pytest.raises(ValueError, match='RPN.BLOCK_LOCAL' if kind == 'block_rcnn' else 'kind'):
        tfs.cfg_for(kind)
    with pytest.raises(ValueError):
        tfs.run(tfs.parse_args(['dense', kind, '--device', 'cpu']))


def test_exact_queries_flag():
    for text, want in (('None', None), ('True', True), ('False', False),
                       ('residual', 'residual')):
        args = tsa.parse_args(['--exact_queries', text])
        assert args.exact_queries is want or args.exact_queries == want
    assert tsa.parse_args([]).exact_queries is False
    assert tfs.parse_args([]).kinds == ['dense', 'block']
    with pytest.raises(SystemExit):
        tsa.parse_args(['--exact_queries', 'approx'])
    cfg = ablation.with_queries(tiny_config(**BLOCK_LOCAL_TINY), False)
    assert cfg.EXACT_QUERIES is False and cfg.RPN.BLOCK_LOCAL


@pytest.mark.parametrize('name', TOOLS)
def test_tools_read_no_environment(name):
    """No ``os.environ``, ``os.getenv`` or ``environ`` in the harnesses."""
    tree = ast.parse(open(os.path.join(REPO, 'epnet_tpu_torch', 'tools', f'{name}.py')).read())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & {'environ', 'getenv', 'putenv'}


@pytest.mark.skipif(torch.cuda.is_available(), reason='checks the refusal without a card')
@pytest.mark.parametrize('module', [tsa, tbl, tfs], ids=lambda m: m.__name__.split('.')[-1])
def test_entry_points_need_a_card(module):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(['--steps', '1'])


# ---------------------------------------------------------------------------
# per_gt_iou
# ---------------------------------------------------------------------------

def _scored_boxes(rng, gt, m=24):
    """Boxes near the gts (and some elsewhere) with random scores."""
    B = gt.shape[0]
    boxes = np.concatenate([np.repeat(gt, 3, axis=1)[:, :m]
                            + rng.normal(0, 0.3, (B, min(m, 3 * gt.shape[1]), 7)),
                            rng.uniform(-10, 30, (B, max(0, m - 3 * gt.shape[1]), 7))], 1)
    boxes[..., 3:6] = np.abs(boxes[..., 3:6]) + 0.5
    return {'pred_boxes3d': boxes.astype(np.float32),
            'norm_scores': rng.rand(B, boxes.shape[1]).astype(np.float32)}


@pytest.mark.parametrize('padded', [False, True])
def test_per_gt_iou_matches_jax(jax_tools, padded):
    rng = np.random.RandomState(4)
    batch = synthetic_batch(rng, tiny_config(), batch=2, structured=True)
    gt = batch['gt_boxes3d']
    if padded:
        gt = np.concatenate([gt, np.zeros((2, 5, 7), np.float32)], 1)
        gt[1, 2] = 0  # one image with fewer gts
    res = _scored_boxes(rng, gt[:, :3])
    b = {'gt_boxes3d': gt}
    got = ablation.per_gt_iou(res, b)
    assert len(got) == int((np.abs(gt).sum(-1) > 0).sum())
    assert max(got) > 0.3
    forms = ['block_local_fullscale'] if padded else ['block_local_fullscale',
                                                      'sampling_ablation']
    with pytest.MonkeyPatch.context() as mp:  # the full-scale form imports it when called
        mp.setattr(j_rotated_iou, 'boxes_iou3d', jax_tools['sampling_ablation'].boxes_iou3d)
        for form in forms:
            np.testing.assert_allclose(got, jax_tools[form].per_gt_iou(res, b), atol=1e-6)
    np.testing.assert_allclose(  # the tensors of joint_eval_step's dict take the same path
        ablation.per_gt_iou({k: torch.from_numpy(v) for k, v in res.items()}, b), got)


# ---------------------------------------------------------------------------
# evaluate: the sampling cells and the block-local swap
# ---------------------------------------------------------------------------

def _spy_fps(mp, picks):
    """Every FPS call's picks on both sides, keyed by (side, shape): JAX's
    through ``jax.debug.callback`` as its jitted step runs."""
    real_j, real_t = jp2.furthest_point_sample, tp2.furthest_point_sample

    def jax_spy(*args, **kwargs):
        idx = real_j(*args, **kwargs)
        jax.debug.callback(lambda a: picks.setdefault(('jax', a.shape), np.asarray(a)), idx)
        return idx

    def torch_spy(*args, **kwargs):
        idx = real_t(*args, **kwargs)
        picks[('torch', tuple(idx.shape))] = idx.numpy()
        return idx

    mp.setattr(jp2, 'furthest_point_sample', jax_spy)
    mp.setattr(tp2, 'furthest_point_sample', torch_spy)


def _port_model(cfg, v):
    model = EPNet(cfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    return model


SAMPLING_CELLS = ('fps', 'fps-G8', 'random')
BL_PATHS = ('block_local_group_multi', 'block_local_three_interp')


def _spy_paths(mp, calls):
    """Count the block-local paths' calls by side (JAX's as it traces)."""
    for side, module in (('jax', jp2), ('torch', tp2)):
        for name in BL_PATHS:
            real = getattr(module, name)

            def spy(*args, _real=real, _key=(side, name), **kwargs):
                calls[_key] = calls.get(_key, 0) + 1
                return _real(*args, **kwargs)

            mp.setattr(module, name, spy)


@contextlib.contextmanager
def _patched(cell, record):
    """Both sides as the cell needs them: the sampling cells under
    ``EXACT_QUERIES`` None with the FPS picks recorded; the swap under
    'residual' with JAX's windowed interpolation op by op and the
    block-local paths counted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2, 'three_nn', _eager_three_nn)
        if cell == 'swap':
            mp.setattr(jpo, 'EXACT_QUERIES', 'residual')
            mp.delenv('EPNET_FP_BLOCK', raising=False)
            mp.setattr(jp2, 'block_local_three_interp', _eager_three_interp)
            _spy_paths(mp, record)
        else:
            mp.setattr(jpo, 'EXACT_QUERIES', None)
            _spy_fps(mp, record)
        yield


def _compiled(step, jcfg):
    """``make_joint_eval_step`` for JAX's ``evaluate``: the compiled step,
    once it has checked that it was asked for ``jcfg``'s."""
    def make(ecfg, model):
        assert ecfg.asdict() == jcfg.asdict()
        return step

    return make


@pytest.fixture(scope='module')
def evals(jax_tools):
    """cell -> (JAX per-gt IoU, port per-gt IoU, record) for the consistent
    ``fps`` cell, the two sampling swaps on the same weights (through JAX's
    ``sampling_ablation.evaluate``) and the block-local swap (the dense
    weights of ``block_local_ablation``'s base evaluated block-local, as
    its ``main`` does). JAX's four steps are lowered under each cell's
    patches, then compiled together on threads (XLA's compile releases the
    GIL: ~7 s less alone), and run."""
    from epnet_tpu.eval.detect import make_joint_eval_step
    from epnet_tpu.models.epnet import EPNet as JEPNet

    jsa, jbl = jax_tools['sampling_ablation'], jax_tools['block_local_ablation']
    modes = dict(tsa.MODES)
    jfps = _jax_sampling_base(jsa).merged(NO_IMAGE).merged({'RPN': modes['fps']})
    sbase = tsa.base_config().merged(NO_IMAGE)
    dense = tbl.base_config().merged(NO_IMAGE)
    over = {'RPN': {'BLOCK_LOCAL': True}, 'EXACT_QUERIES': 'residual'}
    cells = {c: (jfps.merged({'RPN': modes[c]}),
                 sbase.merged({'RPN': modes['fps']}).merged({'RPN': modes[c]}), sbase)
             for c in SAMPLING_CELLS}
    cells['swap'] = jbl.base_config().merged(NO_IMAGE).merged(over), dense.merged(over), dense
    weights = {id(b): _flax_variables(b, 'TRAIN') for b in (sbase, dense)}
    records, lowered, batches = {}, {}, {}
    for cell, (jcfg, cfg, trained) in cells.items():
        batches[cell] = synthetic_batch(np.random.RandomState(11), cfg, batch=2,
                                        structured=True)
        with _patched(cell, records.setdefault(cell, {})):
            lowered[cell] = make_joint_eval_step(jcfg, JEPNet(jcfg, mode='TEST')).lower(
                weights[id(trained)], batches[cell])
    with concurrent.futures.ThreadPoolExecutor(len(lowered)) as pool:
        steps = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    out = {}
    for cell, (jcfg, cfg, trained) in cells.items():
        v, batch = weights[id(trained)], batches[cell]
        with _patched(cell, records[cell]), pytest.MonkeyPatch.context() as mp:
            if cell == 'swap':
                want = jbl.per_gt_iou(jax.device_get(steps[cell](v, batch)), batch)
            else:
                mp.setattr(jsa, 'make_joint_eval_step', _compiled(steps[cell], jcfg))
                want = jsa.evaluate(jfps, modes[cell], v, batch)
            got = ablation.evaluate(cfg, _port_model(trained, v), batch)
        out[cell] = want, got, records[cell]
    return out


@pytest.mark.parametrize('cell', SAMPLING_CELLS)
def test_sampling_evaluate_matches_jax(evals, cell):
    want, got, _ = evals[cell]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_TOL)


@pytest.mark.parametrize('cell', SAMPLING_CELLS)
def test_sampling_evaluate_fps_picks(evals, cell):
    """The same FPS calls with identical picks: 4 RPN and 2 RCNN stages,
    the RPN partitioned under ``fps-G8`` (same shapes) and absent under
    ``random``."""
    _, _, picks = evals[cell]
    shapes = {side: sorted(s for k, s in picks if k == side) for side in ('jax', 'torch')}
    rpn = [(2, 8), (2, 16), (2, 32), (2, 64)] if cell != 'random' else []
    assert shapes['jax'] == shapes['torch'] == sorted(rpn + [(32, 16), (32, 32)])
    for s in shapes['jax']:
        np.testing.assert_array_equal(picks['torch', s], picks['jax', s], err_msg=str(s))


def test_block_local_swap_matches_jax(evals):
    want, got, _ = evals['swap']
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_TOL)


def test_block_local_swap_took_the_block_local_paths(evals):
    """RPN sa0 grouped block-locally on both sides (2048 points, windows of
    1024: JAX's gate ``block_local_available``), and the windowed
    interpolation ran where its gate admits it."""
    _, _, calls = evals['swap']
    assert calls.get(('jax', 'block_local_group_multi'), 0) >= 1
    assert calls.get(('torch', 'block_local_group_multi'), 0) == 1
    assert (calls.get(('jax', 'block_local_three_interp'), 0) > 0) == \
        (calls.get(('torch', 'block_local_three_interp'), 0) > 0)


# ---------------------------------------------------------------------------
# the harnesses end to end, two steps
# ---------------------------------------------------------------------------

def _check_runs(out, names, gts):
    assert [r['name'] for r in out] == names
    for r in out:
        assert len(r['ious']) == gts and all(0.0 <= x <= 1.0 for x in r['ious'])
        assert r['min'] == min(r['ious'])
        if 'loss' in r:
            assert math.isfinite(r['loss']) and r['median_step_ms'] > 0


def test_sampling_run(capsys):
    out = tsa.run(tsa.parse_args(['--steps', '2', '--device', 'cpu']))
    _check_runs(out, ['fps', 'fps-G8', 'random', 'fps-trained evaled with fps-G8',
                      'fps-trained evaled with random'], 6)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('fps: trained (loss ') and 'consistent-eval per-gt IoU [' in lines[0]
    assert lines[3].startswith('fps-trained evaled with fps-G8: per-gt IoU [')


def test_block_local_run():
    calls = {}
    mp = pytest.MonkeyPatch()
    real = tp2.block_local_group_multi
    mp.setattr(tp2, 'block_local_group_multi',
               lambda *a, **k: calls.setdefault('n', []).append(1) or real(*a, **k))
    try:
        out = tbl.run(tbl.parse_args(['--steps', '2', '--device', 'cpu', '--seed', '5']))
    finally:
        mp.undo()
    _check_runs(out, ['dense (nested approx)', 'block-local',
                      'dense-trained evaled block-local'], 6)
    assert len(calls['n']) == 2 + 1 + 1  # two block-local steps, its eval, the swap


def test_fullscale_run():
    """Three kinds on a tiny block-local base without the image stream (a
    full-resolution image through the tiny tower costs seconds a step on the
    CPU): each kind's paths (RPN
    block-local grouping; the windowed interpolation only where ``fp_block``
    keeps it; the windowed RCNN stage only under ``block``)."""
    names = ('block_local_group_multi', 'block_local_three_interp', 'fused_point_mlp_max_win')
    calls, out = {}, []
    mp = pytest.MonkeyPatch()
    for name in names:
        real = getattr(tp2, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        mp.setattr(tp2, name, spy)
    base = tiny_config(li_fusion=False, **BLOCK_LOCAL_TINY)
    try:
        for kind in ('dense', 'block', 'block_sa'):
            calls.clear()
            out += tfs.run(tfs.parse_args([kind, '--steps', '2', '--device', 'cpu']), base)
            seen = {n for n in names if calls.get(n)}
            assert seen == {'dense': set(), 'block': set(names),
                            'block_sa': {'block_local_group_multi'}}[kind], kind
    finally:
        mp.undo()
    gt = full_batch(base, 2, seed=7, with_labels=True)['gt_boxes3d']
    _check_runs(out, ['dense', 'block', 'block_sa'], int((np.abs(gt).sum(-1) > 0).sum()))
