"""The whole slice: the port's ``EPNet`` TEST forward against the JAX
package's under bridged weights, on the CPU, at ``tiny_config`` widths.

One fixed seed; both sides are deterministic on the CPU. ``backbone_xyz``,
``roi_counts`` and ``seg_result`` must be identical; float outputs agree
within rtol=atol=1e-4 (f32 on both sides, summation orders differ across
~20 matmul layers).
"""

import jax
import numpy as np
import pytest
import torch

from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models.epnet import EPNet as TEPNet
from epnet_tpu_torch.utils.testing import tiny_config

from test_torch_bridge import randomize_norms, to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
INPUTS = ('pts_input', 'img', 'pts_origin_xy')


@pytest.fixture(scope='module')
def outputs():
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    try:
        cfg = tiny_config(EXACT_QUERIES=True)
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, with_gt=False,
                                structured=True)
        jmodel = JEPNet(cfg, 'TEST')
        v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
            {'params': jax.random.PRNGKey(0)}, {k: batch[k] for k in INPUTS})
        v = randomize_norms(v, 1)
        want = to_numpy(jmodel.apply(v, batch, train=False))
    finally:
        mp.undo()
    tmodel = TEPNet(cfg, 'TEST', device='cpu').eval()
    load_flax_variables(tmodel, v['params'], v['batch_stats'])
    got = {k: x.numpy() for k, x in tmodel({k: torch.from_numpy(batch[k]) for k in INPUTS}).items()}
    return want, got, v


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts', 'seg_result'])
def test_exact_outputs(outputs, key):
    want, got, _ = outputs
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['rpn_cls', 'rpn_reg', 'backbone_features', 'rois',
                                 'roi_scores_raw', 'rcnn_cls', 'rcnn_reg'])
def test_float_outputs(outputs, key):
    want, got, _ = outputs
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], **TOL)


def test_rois_are_real_proposals(outputs):
    """The comparison is not vacuous: every batch element keeps RoIs, and
    the RCNN sees distinct boxes."""
    want, _, _ = outputs
    assert (want['roi_counts'] > 0).all()
    assert np.unique(want['rois'].reshape(-1, 7), axis=0).shape[0] > 4


def test_bridge_covers_every_tensor(outputs):
    _, _, v = outputs
    arrays = flax_to_state_dict(v['params'], v['batch_stats'])
    tmodel = TEPNet(tiny_config(EXACT_QUERIES=True), 'TEST', device='cpu')
    assert set(arrays) == set(tmodel.state_dict())


def test_bridge_rejects_unmatched_keys(outputs):
    _, _, v = outputs
    params = dict(v['params'])
    params['stray'] = {'kernel': np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match='stray'):
        load_flax_variables(TEPNet(tiny_config(), 'TEST', device='cpu'), params, v['batch_stats'])


def test_seeded_init():
    """Weights come from the generator (same seed, same weights) with the
    JAX package's priors on the heads."""
    cfg = tiny_config()
    a = TEPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(3)).state_dict()
    b = TEPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.allclose(a['rpn.cls_out.bias'], torch.tensor([-np.log(99.0)], dtype=torch.float32))
    assert float(a['rpn.reg_out.weight'].std()) < 0.002
    w = a['rpn.backbone.fp0.SharedMLP_0.PointwiseConv_0.Dense_0.weight']
    fan_in = w.shape[1]
    assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.15
    assert float(w.abs().max()) <= 2 * np.sqrt(2.0 / fan_in) / 0.87962566103423978 + 1e-6


def test_entry_points_need_a_card_unless_told(monkeypatch):
    """Without ``device`` the model and the train state go to the card; with
    no card they raise instead of building on the CPU."""
    from epnet_tpu_torch.train.trainer import create_train_state
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEPNet(tiny_config(), 'TEST')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(tiny_config(TRAIN={'OPTIMIZER': 'adam_onecycle'}), total_steps=10)
    model = TEPNet(tiny_config(), 'TEST', device='cpu')
    assert {p.device.type for p in model.parameters()} == {'cpu'}


def test_entry_points_turn_tf32_off(monkeypatch):
    """The recipe is f32: building the model turns off the TF32 that
    PyTorch leaves on in cuDNN (and a caller may have turned on in cuBLAS),
    so the card's convolutions and matmuls run in f32."""
    from epnet_tpu_torch.train.trainer import create_train_state
    for build in (lambda: TEPNet(tiny_config(), 'TEST', device='cpu'),
                  lambda: create_train_state(tiny_config(TRAIN={'OPTIMIZER': 'adam_onecycle'}),
                                             total_steps=10, device='cpu')):
        monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
        monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
        build()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
