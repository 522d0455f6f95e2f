"""The bf16 eval forward (``MIXED_PRECISION``): the port's modules and its
``EPNet`` TEST forward against the JAX package's bf16 ones under bridged
weights, on the CPU, at ``tiny_config`` widths with
``utils/testing.MIXED_TINY``.

The JAX side runs jitted, compiled with ``xla_allow_excess_precision``
off. By default XLA's CPU fusions keep a fused chain of bf16 operations in
f32 and round once at the end, which is another rounding of the same
program; with the flag off every operation rounds to the dtype the JAX
code states, as the port's operations do. Beside that, as in the f32
slices, JAX's ``three_nn`` runs op by op (``_eager_three_nn``), the
``fused_sa_available`` gate is patched in both places it is read so that
JAX takes the Pallas fused kernel's bf16 branch in interpret mode (its
unfused bf16 Dense rounds elsewhere), and the RCNN's FPS gets its bf16
coordinates widened to f32: on the TPU the JAX package's FPS kernel
widens them (``fps_pallas.py:140``; the RCNN's tables take that kernel at
full width), where the CPU recurrence would compare bf16 distances. The
ball queries run as JAX states them, on a bf16 distance field.

Tolerances: a module's bf16 output within 2 bf16 units in the last place
of max|out| (u = 2^-7 * 2^floor(log2 max|out|)); they come out bit-identical
or at f32 roundoff. The slice: FPS picks and RoI counts identical; the
port's backbone features and RPN outputs at most 0.25 x the gap between
JAX bf16 and JAX f32 away from JAX bf16 (both gaps printed); the port's
proposal stage fed JAX's bf16 RPN outputs gives JAX's RoIs (to the f32
roundoff of the decode); the port's
pooling and RCNN fed JAX's RoIs give its RCNN outputs within 2 bf16 units
of max|out|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import fusion as jfu
from epnet_tpu.models import layers as jla
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.models.rcnn import RCNNNet as JRCNNNet
from epnet_tpu.ops import block_local as jbl
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops import sa_fused as jsf
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.bridge import load_flax_variables
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models import fusion as tfu
from epnet_tpu_torch.models import layers as tla
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.models.rcnn import RCNNNet as TRCNNNet
from epnet_tpu_torch.ops import block_local as tbl
from epnet_tpu_torch.ops import pointops as tpo
from epnet_tpu_torch.ops.grid_sample import grid_sample_points
from epnet_tpu_torch.utils.testing import (MIXED_BLOCK_LOCAL_TINY, MIXED_TINY, make_fake_kitti,
                                           tiny_config)

from test_torch_block_local_slice import PATHS as BL_PATHS
from test_torch_block_local_slice import _eager_three_interp, _spy
from test_torch_bridge import bridged, randomize_norms, t, to_numpy
from test_torch_train_step import _eager_three_nn

BF = jnp.bfloat16
TBF = torch.bfloat16
INPUTS = ('pts_input', 'img', 'pts_origin_xy')


def _fused_gate(n, m, s, c1, c2, c3, use_bn):
    """``fused_sa_available`` without the TPU's lane and VMEM limits."""
    return not use_bn and (m * s) % 8 == 0


def _patch_jax(mp):
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    mp.setattr(jsf, 'fused_sa_available', _fused_gate)
    mp.setattr(jp2, 'fused_sa_available', _fused_gate)
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    fps = jp2.furthest_point_sample
    mp.setattr(jp2, 'furthest_point_sample',
               lambda xyz, n, **kw: fps(xyz.astype(jnp.float32), n, **kw))


@pytest.fixture
def jax_bf16(monkeypatch):
    _patch_jax(monkeypatch)


def _rounding_jit(fn):
    """``jax.jit(fn)`` compiled with XLA's excess precision off: every
    bf16 operation rounds, as it is written."""
    jitted = jax.jit(fn)

    def run(*args):
        return jitted.lower(*args).compile(
            compiler_options={'xla_allow_excess_precision': False})(*args)

    return run


def _jit_variables(module, seed, *args, **kwargs):
    init = jax.jit(lambda r, *a: module.init(r, *a, **kwargs))
    return randomize_norms(init(jax.random.PRNGKey(seed), *args), seed + 1)


def _ulp(v):
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _within_ulps(got, want, what, ulps=2):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float32) - want).max())
    print(f'{what}: max err {err:.3e} = {err / _ulp(scale):.3f} bf16 ulp of max|out| {scale:.3e}, '
          f'{np.mean(got == want):.4f} bit-identical')
    assert scale > 0 and err <= ulps * _ulp(scale), what


def _bf16(a):
    """The bf16 values of ``a``: (as a jax array, as a torch tensor)."""
    j = jnp.asarray(a, BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TBF)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_batchnorm_bf16(jax_bf16):
    """Eval BN in the input's dtype: ``x - mean.bf16``, then one bf16
    multiply-add with the scale folded in f32 (``layers.py:136-143``)."""
    xj, xt = _bf16(np.random.RandomState(0).randn(4, 10, 6) * 3)
    v = _jit_variables(jla.BatchNorm(), 1, xj, train=False)
    want = _rounding_jit(lambda v, x: jla.BatchNorm().apply(v, x, train=False))(v, xj)
    assert want.dtype == BF
    got = bridged(tla.BatchNorm(6), v)(xt)
    assert got.dtype == TBF
    _within_ulps(got, want, 'BatchNorm bf16')


def test_shared_mlp_bf16(jax_bf16):
    x = np.random.RandomState(2).randn(2, 5, 9, 4).astype(np.float32)
    jmod = jla.SharedMLP((8, 8, 12), dtype=BF)
    v = _jit_variables(jmod, 3, x)
    want = _rounding_jit(jmod.apply)(v, x)
    got = bridged(tla.SharedMLP(4, (8, 8, 12), dtype=TBF), v)(t(x))
    _within_ulps(got, want, 'SharedMLP bf16')


def _cloud(seed, B, N, C):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, (B, N, 3)).astype(np.float32),
            rng.randn(B, N, C).astype(np.float32))


@pytest.mark.parametrize('bn', [False, True], ids=['fused', 'bn'])
def test_sa_stage_bf16(jax_bf16, monkeypatch, bn):
    """The RCNN's fused stage (no BN, three layers: B-bf16's function, JAX's
    Pallas bf16 branch) and an RPN-style MSG stage with BN."""
    xyz, feats = _cloud(4, 3, 64, 16)
    if bn:
        kw = dict(npoint=16, radii=(0.5, 1.0), nsamples=(8, 16), mlps=((8, 8, 12), (8, 8, 16)))
    else:
        kw = dict(npoint=16, radii=(0.8,), nsamples=(8,), mlps=((32, 32, 48),))
    jmod = jp2.SAModuleMSG(**kw, bn=bn, dtype=BF)
    v = _jit_variables(jmod, 5, xyz, feats)
    calls = []
    real = jp2.fused_point_mlp_max
    monkeypatch.setattr(jp2, 'fused_point_mlp_max',
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    j_xyz, j_feat, j_idx = _rounding_jit(jmod.apply)(v, xyz, feats)
    assert calls == ([] if bn else [BF])  # the Pallas kernel's bf16 branch ran
    tmod = bridged(tp2.SAModuleMSG(**kw, in_features=16, bn=bn, dtype=TBF), v)
    with torch.no_grad():
        t_xyz, t_feat, t_idx = tmod(t(xyz), t(feats))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_xyz.numpy(), np.asarray(j_xyz))
    assert t_feat.dtype == TBF and j_feat.dtype == BF
    _within_ulps(t_feat, j_feat, f'SA stage bf16 ({"BN" if bn else "fused"})')


def test_fp_stage_bf16(jax_bf16):
    """bf16 known features and interpolation weights (``pointnet2.py:
    397-403``), then a bf16 SharedMLP with BN."""
    rng = np.random.RandomState(6)
    unknown, known = rng.randn(2, 48, 3).astype(np.float32), rng.randn(2, 12, 3).astype(np.float32)
    uf, kf = rng.randn(2, 48, 6).astype(np.float32), rng.randn(2, 12, 10).astype(np.float32)
    jmod = jp2.FPModule(mlp=(16, 16), dtype=BF)
    v = _jit_variables(jmod, 7, unknown, known, _bf16(uf)[0], _bf16(kf)[0])
    want = _rounding_jit(jmod.apply)(v, unknown, known, _bf16(uf)[0], _bf16(kf)[0])
    tmod = bridged(tp2.FPModule(16, (16, 16), dtype=TBF), v)
    with torch.no_grad():
        got = tmod(t(unknown), t(known), _bf16(uf)[1], _bf16(kf)[1])
    _within_ulps(got, want, 'FP stage bf16')


def test_image_block_bf16(jax_bf16):
    """The stem from an f32 image (``nn.Conv`` in bf16), BN, and the
    stride-2 conv (F-bf16's function)."""
    x = np.random.RandomState(9).rand(2, 16, 24, 3).astype(np.float32)
    jmod = jfu.ImageBlock(8, dtype=BF)
    v = _jit_variables(jmod, 10, x)
    want = _rounding_jit(jmod.apply)(v, x)
    assert want.dtype == BF
    with torch.no_grad():
        got = bridged(tfu.ImageBlock(3, 8, dtype=TBF), v)(t(x))
    _within_ulps(got, want, 'ImageBlock bf16')


def test_atten_fusion_conv_bf16(jax_bf16):
    """The gate is f32 (``fusion.py:56-57``), the gated features come back to
    the points' bf16 (``:77``)."""
    rng = np.random.RandomState(11)
    pf, imf = _bf16(rng.randn(2, 40, 12)), _bf16(rng.randn(2, 40, 8))
    jmod = jfu.AttenFusionConv(16, dtype=BF)
    v = _jit_variables(jmod, 12, pf[0], imf[0])
    want = _rounding_jit(jmod.apply)(v, pf[0], imf[0])
    with torch.no_grad():
        got = bridged(tfu.AttenFusionConv(12, 8, 16, dtype=TBF), v)(pf[1], imf[1])
    _within_ulps(got, want, 'AttenFusionConv bf16')


def test_deconv_head_eval_bf16(jax_bf16):
    """Against JAX's eval head ``deconv_bn_relu_sample_eval`` on bf16 scale
    maps, the head the JAX package runs at eval."""
    rng = np.random.RandomState(13)
    chans, ks = (4, 6, 8, 10), (2, 4, 8, 16)
    imgs = [_bf16(rng.randn(2, 32 // k, 64 // k, c)) for c, k in zip(chans, ks)]
    xy = rng.uniform(-1, 1, (2, 50, 2)).astype(np.float32)
    jmod = jfu.DeconvFusionHead(reduce=(3, 3, 3, 3), kernels=ks, features=5, dtype=BF)
    jimgs = [j for j, _ in imgs]
    v = _jit_variables(jmod, 14, jimgs, xy=xy)
    want = _rounding_jit(lambda v, i, p: jmod.apply(v, i, xy=p))(v, jimgs, xy)
    assert want.dtype == BF
    tmod = bridged(tfu.DeconvFusionHead(chans, (3, 3, 3, 3), ks, 5, dtype=TBF), v)
    with torch.no_grad():
        got = tmod([x for _, x in imgs], t(xy))
    _within_ulps(got, want, 'deconv head eval bf16')


def test_rcnn_bf16_on_identical_pooled_input(jax_bf16):
    """RCNNNet on the same bf16 pooled points (``epnet.py:108-125``): xyz_up,
    merge_down and the SA tower in bf16 (the fused stages B-bf16's
    function), the final pool and the heads f32."""
    jcfg = j_tiny_config().merged(MIXED_TINY)
    rng = np.random.RandomState(15)
    T, S = 6, jcfg.RCNN.NUM_POINTS
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (T, S, 3)), rng.rand(T, S, 2),
                          rng.randn(T, S, 32)], -1)
    pj, pt = _bf16(pts)
    jmod = JRCNNNet(jcfg)
    v = _jit_variables(jmod, 16, pj)
    want = _rounding_jit(jmod.apply)(v, pj)
    tmod = bridged(TRCNNNet(tiny_config(**MIXED_TINY), pts.shape[-1]), v)
    with torch.no_grad():
        got = tmod(pt)
    for k in ('rcnn_cls', 'rcnn_reg'):
        assert got[k].dtype == torch.float32
        _within_ulps(got[k], want[k], f'RCNNNet bf16 {k}')


@pytest.mark.parametrize('query', ['ball', 'bucket'])
def test_ball_queries_on_bf16_coordinates(query):
    """The RCNN's queries on its bf16 coordinates, as JAX states them: the
    difference and the squares in bf16, their sum in f32 rounded to bf16,
    against radius^2 rounded to bf16 (``pointops.py:364-365``,
    ``block_local.py:160-162``). The same query on the coordinates widened
    to f32 picks other points, so the dtype of the field is tested."""
    rng = np.random.RandomState(18)
    xj, xt = _bf16(rng.uniform(-1.2, 1.2, (4, 128, 3)))
    cj, ct = _bf16(rng.uniform(-1.2, 1.2, (4, 32, 3)))
    r, s = 0.6, 16
    if query == 'ball':
        want = _rounding_jit(lambda x, c: jpo.ball_query(r, s, x, c, exact=True))(xj, cj)
        fn = tpo.ball_query
    else:
        want = _rounding_jit(lambda x, c: jbl.bucket_ball_query(r, s, x, c))(xj, cj)
        fn = tbl.bucket_ball_query
    got = fn(r, s, xt, ct)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(fn(r, s, xt.float(), ct.float()).numpy(), np.asarray(want))


def test_grid_sample_passes_no_gradient_to_xy():
    """JAX's custom VJP returns zero for ``xy_norm`` (``grid_sample.py:
    45-47,110``): the port detaches it; the map still gets its gradient."""
    rng = np.random.RandomState(17)
    fmap = t(rng.randn(1, 6, 9, 4).astype(np.float32)).requires_grad_()
    xy = t(rng.uniform(-1, 1, (1, 20, 2)).astype(np.float32)).requires_grad_()
    grid_sample_points(fmap, xy).square().sum().backward()
    assert xy.grad is None
    assert fmap.grad is not None and float(fmap.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def slice_outputs():
    """One JAX init; the JAX bf16 and f32 forwards; the port's bf16 one."""
    mp = pytest.MonkeyPatch()
    _patch_jax(mp)
    try:
        jcfg = j_tiny_config().merged(MIXED_TINY)
        jcfg32 = jcfg.merged({'MIXED_PRECISION': False})
        batch = synthetic_batch(np.random.RandomState(0), jcfg, batch=2, with_gt=False,
                                structured=True)
        j16, j32 = JEPNet(jcfg, 'TEST'), JEPNet(jcfg32, 'TEST')
        v = jax.jit(lambda r, b: j32.init(r, b, train=False))(
            {'params': jax.random.PRNGKey(0)}, {k: batch[k] for k in INPUTS})
        v = randomize_norms(v, 1)
        want = to_numpy(_rounding_jit(lambda v, b: j16.apply(v, b, train=False))(v, batch))
        want32 = to_numpy(jax.jit(lambda v, b: j32.apply(v, b, train=False))(v, batch))
    finally:
        mp.undo()
    tmodel = tep.EPNet(tiny_config(**MIXED_TINY), 'TEST', device='cpu').eval()
    load_flax_variables(tmodel, v['params'], v['batch_stats'])
    tb = {k: torch.from_numpy(batch[k]) for k in INPUTS}
    got = {k: x.numpy() for k, x in tmodel(tb).items()}
    return want, want32, got, tmodel, v


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts'])
def test_slice_exact_outputs(slice_outputs, key):
    want, _, got, _, _ = slice_outputs
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['backbone_features', 'rpn_cls', 'rpn_reg'])
def test_slice_closer_to_jax_bf16_than_bf16_is_to_f32(slice_outputs, key):
    want, want32, got, _, _ = slice_outputs
    port_gap = float(np.abs(got[key] - want[key]).max())
    bf16_gap = float(np.abs(want[key] - want32[key]).max())
    print(f'{key}: port vs JAX bf16 {port_gap:.4e}, JAX bf16 vs JAX f32 {bf16_gap:.4e}, '
          f'ratio {port_gap / bf16_gap:.4f} (limit 0.25)')
    assert bf16_gap > 0 and port_gap <= 0.25 * bf16_gap


def test_slice_proposals_from_jax_rpn_outputs(slice_outputs):
    """The f32 proposal stage fed JAX's bf16 RPN outputs gives JAX's RoIs:
    the same proposals kept in the same order (counts and scores
    identical), the boxes at the f32 roundoff of the bin decode (measured
    1.9e-6 at most; ``test_torch_proposal.py`` allows 1e-5)."""
    want, _, _, tmodel, _ = slice_outputs
    with torch.no_grad():
        rois, scores, counts = tmodel.proposal(torch.tensor(want['rpn_cls'][..., 0]),
                                               torch.tensor(want['rpn_reg']),
                                               torch.tensor(want['backbone_xyz']))
    np.testing.assert_array_equal(counts.numpy(), want['roi_counts'])
    np.testing.assert_array_equal(scores.numpy(), want['roi_scores_raw'])
    np.testing.assert_allclose(rois.numpy(), want['rois'], rtol=1e-6, atol=1e-5)


def test_slice_rcnn_from_jax_rois(slice_outputs):
    """The port's bf16 pooling and RCNN fed JAX's bf16 backbone and RoIs."""
    want, _, _, tmodel, _ = slice_outputs
    xyz = torch.tensor(want['backbone_xyz'])
    with torch.no_grad():
        pooled = tep.pool_for_eval(tmodel.cfg, torch.tensor(want['rois']), xyz,
                                   torch.tensor(want['backbone_features']),
                                   torch.tensor(want['seg_result']),
                                   torch.linalg.norm(xyz, dim=2))
        assert pooled.dtype == TBF
        out = tmodel.rcnn(pooled)
    for k in ('rcnn_cls', 'rcnn_reg'):
        _within_ulps(out[k], want[k], f'slice {k} from JAX RoIs')


# ---------------------------------------------------------------------------
# the slice in the block-local configuration
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def block_local_outputs(slice_outputs):
    """The bf16 TEST forward at ``MIXED_BLOCK_LOCAL_TINY`` on both sides,
    from the slice's variables (the configurations share every parameter
    shape) and a Morton-sorted batch. JAX as in
    ``test_torch_block_local_slice.py``: 'residual' queries, the fused gate patched, the windowed interpolation
    and ``three_nn`` op by op; spies record the block-local paths."""
    v = slice_outputs[4]
    mp = pytest.MonkeyPatch()
    _patch_jax(mp)
    mp.setattr(jpo, 'EXACT_QUERIES', 'residual')
    mp.delenv('EPNET_FP_BLOCK', raising=False)
    mp.setattr(jp2, 'block_local_three_interp', _eager_three_interp)
    calls = {}
    _spy(mp, jp2, calls, 'jax')
    _spy(mp, tp2, calls, 'torch')
    try:
        jcfg = j_tiny_config().merged(MIXED_BLOCK_LOCAL_TINY)
        batch = synthetic_batch(np.random.RandomState(0), jcfg, batch=2, with_gt=False,
                                structured=True)
        jm = JEPNet(jcfg, 'TEST')
        want = to_numpy(_rounding_jit(lambda v, b: jm.apply(v, b, train=False))(v, batch))
        tmodel = tep.EPNet(tiny_config(**MIXED_BLOCK_LOCAL_TINY), 'TEST', device='cpu').eval()
        load_flax_variables(tmodel, v['params'], v['batch_stats'])
        got = {k: x.numpy() for k, x in
               tmodel({k: torch.from_numpy(batch[k]) for k in INPUTS}).items()}
    finally:
        mp.undo()
    return want, got, calls


def test_block_local_took_the_block_local_paths(block_local_outputs):
    """Block-local grouping (SA 0-1), windowed interpolation (FP) and the
    windowed fused stage (RCNN sa0, G-bf16's function) ran on both sides."""
    _, _, calls = block_local_outputs
    for side in ('jax', 'torch'):
        for name in BL_PATHS:
            assert calls.get((side, name), 0) >= 1, (side, name)


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts', 'seg_result'])
def test_block_local_exact_outputs(block_local_outputs, key):
    want, got, _ = block_local_outputs
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['backbone_features', 'rpn_cls', 'rpn_reg', 'rois',
                                 'rcnn_cls', 'rcnn_reg'])
def test_block_local_float_outputs(block_local_outputs, key):
    want, got, _ = block_local_outputs
    _within_ulps(got[key], want[key], f'block-local bf16 {key}')


def test_mixed_precision_is_the_test_forward_only():
    """No longer the TEST forward only: TRAIN builds too (the bf16 train
    step, ``test_torch_bf16_train.py``), and building either model keeps
    bf16 split-K reductions in f32 (``use_bf16_math``)."""
    cfg = tiny_config(**MIXED_TINY)
    old = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        for mode in ('TRAIN', 'TEST'):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
            model = tep.EPNet(cfg, mode, device='cpu')
            assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
            assert model.mode == mode and model.rcnn.sa0.dtype == TBF
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = old


def test_cli_runs_mixed_precision(tmp_path):
    """The eval CLI with ``--set MIXED_PRECISION True`` at tiny widths on the
    CPU: a result file a scan and a finite AP dict."""
    import yaml
    from epnet_tpu_torch.tools import eval as cli
    from epnet_tpu_torch.train.trainer import create_train_state, save_checkpoint

    cfg = tiny_config(EXACT_QUERIES=True, RCNN={'SCORE_THRESH': 0.01},
                      TRAIN={'OPTIMIZER': 'adam_onecycle'})
    root = str(tmp_path / 'kitti')
    make_fake_kitti(root, n_samples=2, n_points=3000, seed=12)

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(y) for k, y in x.items()}
        return [plain(y) for y in x] if isinstance(x, (tuple, list)) else x

    cfg_file = tmp_path / 'tiny.yaml'
    cfg_file.write_text(yaml.safe_dump(plain(cfg.asdict())))
    state = create_train_state(cfg, total_steps=1, device='cpu',
                               generator=torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path / 'ckpt'), state, epoch=0)
    ret = cli.main(['--cfg_file', str(cfg_file), '--data_root', root, '--ckpt', ckpt,
                    '--batch_size', '2', '--workers', '0', '--output_dir', str(tmp_path / 'out'),
                    '--device', 'cpu', '--set', 'MIXED_PRECISION', 'True'])
    files = sorted(os.listdir(tmp_path / 'out' / 'epoch_0' / 'final_result' / 'data'))
    assert files == ['000000.txt', '000001.txt']
    assert all(np.isfinite(x).all() for x in ret['ap']['Car'].values())
