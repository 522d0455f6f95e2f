"""The port's user tools without the detector, against the JAX package's:
the PointNet++ segmentation harness (``tools/pointnet2_seg.py``) and the
projection check (``tools/vis_img.py``), on the CPU at test widths. The
JAX tools are loaded by path (``tools/`` is not a package).

- The seg net: JAX's ``build_model(cfg)`` variables, bridged by
  ``flax_to_state_dict`` onto the port's ``SegNet`` unchanged, give logits
  within f32 roundoff (1e-5) in eval mode; in train mode (BatchNorm's batch
  statistics) the dice loss within 1e-6 relative, and the gradients as
  ``test_torch_train_step.py`` holds the backbone's, 0.25 of each leaf's
  max and 10% of the whole norm: batch statistics amplify the frameworks'
  summation-order roundoff until a ReLU or a max flips (here at most 0.039
  of a leaf, a BN bias; errors of order 1 would show); one Adam step from
  the same gradients equals optax's ``adam`` (optax's defaults) within
  1e-7 + 1e-6 |p|: the update is lr m / (sqrt(v) + eps) on both sides,
  summed in other orders. JAX runs jitted, its ``three_nn`` op by op.
- ``run()`` on a 4-scene tree: an epoch's steps, a finite loss, an IoU in
  [0, 1]; the CLI's flags and defaults are JAX's, plus ``--device``.
- ``vis_img``: the same printed statistics as JAX's tool on the same frame,
  and its two PNGs (the port's encoder) decode to JAX's pixels (PIL's).
"""

import argparse
import importlib.util
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from epnet_tpu.losses import dice_loss as j_dice_loss
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables, state_dict_to_flax
from epnet_tpu_torch.losses import dice_loss as t_dice_loss
from epnet_tpu_torch.tools import pointnet2_seg as tseg
from epnet_tpu_torch.tools import vis_img as tvis
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

from test_torch_bridge import one_torch_thread, randomize_norms, t, to_numpy
from test_torch_train_step import _eager_three_nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the harness's config (no intensity) at test widths, two SA and FP stages
# to keep JAX's compiles short
SEG_OVER = {'RPN': {'USE_INTENSITY': False, 'SA_CONFIG': {
    'NPOINTS': (64, 16), 'RADIUS': ((0.2, 1.0), (1.0, 2.0)), 'NSAMPLE': ((8, 16), (8, 16)),
    'MLPS': (((8, 8, 12), (8, 8, 12)), ((16, 16, 24), (16, 16, 24)))},
    'FP_MLPS': ((32, 32), (48, 48))}}


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
def seg():
    """JAX's seg net at test widths, the port's net initialized as the
    port's models are, its variables in flax's form (norms randomized), and
    a batch whose first points are ignored (label -1)."""
    cfg = j_tiny_config(li_fusion=False, rcnn=False).merged(SEG_OVER)
    batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
    batch['rpn_cls_label'][:, :20] = -1
    net = tseg.build_model(tiny_config(li_fusion=False, rcnn=False).merged(SEG_OVER), 'cpu',
                           torch.Generator().manual_seed(0))
    v = randomize_norms(state_dict_to_flax(net), 1)
    load_flax_variables(net, v['params'], v['batch_stats'])
    return _jax_tool('pointnet2_seg').build_model(cfg), v, batch, net


def _exact_jax(mp):
    """JAX on the harness's exact queries (module state), its ``three_nn``
    op by op inside the jits (XLA rounds the fused 3-NN field otherwise,
    ``test_torch_train_step.py``)."""
    mp.setattr(jpo, 'EXACT_QUERIES', True)
    mp.setattr(jp2, 'three_nn', _eager_three_nn)


def test_seg_logits_equal_jax(seg, monkeypatch):
    _exact_jax(monkeypatch)
    model, v, batch, net = seg
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(v, batch['pts_input'])
    got = net.eval()(t(batch['pts_input']))
    assert got.shape == want.shape == batch['pts_input'].shape[:2]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_dice_loss_and_adam_step_equal_optax(seg, monkeypatch):
    """One train step: the dice loss and the gradients against JAX's
    ``value_and_grad`` of the harness's loss, then the port's Adam on JAX's
    gradients against ``optax.adam``'s update."""
    _exact_jax(monkeypatch)
    model, v, batch, net = seg
    label = batch['rpn_cls_label']
    assert (label == -1).any() and (label == 1).any()

    def loss_fn(p):
        logits, mut = model.apply({'params': p, 'batch_stats': v['batch_stats']},
                                  batch['pts_input'], train=True, mutable=['batch_stats'])
        return j_dice_loss(logits, label)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v['params'])
    net.train()
    net.zero_grad()
    t_loss = t_dice_loss(net(t(batch['pts_input'])), t(label))
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=1e-6)
    want_g = flax_to_state_dict(to_numpy(grads))
    got_g = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(got_g) == set(want_g)
    leaf = {n: float(np.abs(got_g[n] - w).max()) / float(np.abs(w).max()) for n, w in want_g.items()}
    norm = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in want_g.values()))
    diff = np.sqrt(sum(float(((got_g[n] - w).astype(np.float64) ** 2).sum())
                       for n, w in want_g.items()))
    assert max(leaf.values()) <= 0.25 and diff <= 0.1 * norm, (max(leaf.values()), diff / norm)

    lr = 0.002
    tx = optax.adam(lr)
    stepped = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    want_p = flax_to_state_dict(to_numpy(stepped(grads, v['params'])))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(np.array(want_g[n]))
    tseg.adam(net.parameters(), lr).step()
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n], rtol=1e-6, atol=1e-7,
                                   err_msg=n)


def test_run_on_a_fake_tree(tmp_path):
    """``run`` at test widths: one epoch over 4 scenes at batch 2 (2 steps,
    2 val batches), then the CLI's flags, JAX's defaults plus ``--device``."""
    root = str(tmp_path / 'kitti')
    make_fake_kitti(root, n_samples=4, n_points=3000)
    cfg = tiny_config(li_fusion=False, rcnn=False).merged(SEG_OVER)
    out = tseg.run(cfg, argparse.Namespace(data_root=root, epochs=1, batch_size=2, lr=0.002,
                                           device='cpu'), workers=0)
    assert len(out['steps_ms']) == 2 and np.isfinite(out['loss'][0])
    assert 0.0 <= out['iou'][0] <= 1.0
    assert vars(tseg.parse_args([])) == dict(data_root='data', epochs=10, batch_size=4,
                                             lr=0.002, device=None)
    assert not tseg.seg_config().RPN.USE_INTENSITY and not tseg.seg_config().MIXED_PRECISION


def test_vis_img_equals_jax(tmp_path, monkeypatch, capsys):
    """The same printed statistics as the JAX tool's on frame 1, and PNGs
    whose pixels are the JAX tool's."""
    root = str(tmp_path / 'kitti')
    make_fake_kitti(root, n_samples=2, n_points=3000)
    monkeypatch.setattr(sys, 'argv', ['vis_img.py', '--data_root', root, '--sample_id', '1',
                                      '--out', str(tmp_path / 'jax')])
    _jax_tool('vis_img').main()
    want = capsys.readouterr().out.splitlines()[0]
    stats = tvis.main(['--data_root', root, '--sample_id', '1', '--out', str(tmp_path / 'port')])
    got = capsys.readouterr().out.splitlines()[0]
    assert got == want and stats['in_image'] > 0
    for name in ('points', 'image'):
        a = np.asarray(Image.open(tmp_path / 'jax' / f'000001_{name}.png'))
        b = np.asarray(Image.open(stats['paths'][name]))
        np.testing.assert_array_equal(b, a)
