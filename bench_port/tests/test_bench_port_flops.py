"""The model-FLOP counter (``counts/flops.py``) against the port's model and
against the published-shape cost model of the JAX package's tools.

Run on the CPU: ``python -m pytest bench_port/tests -q``."""

import collections
import json
import os
import runpy
from pathlib import Path

import pytest

from bench_port.counts import flops

ROOT = Path(__file__).resolve().parents[2]


def _tree(name):
    return json.loads((ROOT / 'bench_port' / 'configs' / f'{name}.json').read_text())['model']


def _weights_of_port(cfg):
    from epnet_tpu_torch.models.epnet import EPNet

    model = EPNet(cfg, 'TEST', device='cpu')
    return {k for k, v in model.state_dict().items() if v.dim() >= 2}


@pytest.mark.parametrize('li_fusion', [True, False])
def test_counter_counts_every_weight_once(li_fusion):
    from epnet_tpu_torch.utils.testing import tiny_config

    cfg = tiny_config(li_fusion=li_fusion)
    layers = flops.layers(cfg.asdict(), 'eval', img_hw=(32, 64))
    assert set(layers) == _weights_of_port(cfg)
    assert all(v > 0 for v in layers.values())


@pytest.mark.parametrize('name', ['epnet_lifusion_f32', 'epnet_lidar_f32'])
def test_counter_covers_the_configurations(name):
    from epnet_tpu_torch.config import Config

    tree = _tree(name)
    assert set(flops.layers(tree, 'eval')) == _weights_of_port(Config().merged(tree))


def test_train_step_counts_forward_and_both_gradients():
    tree = _tree('epnet_lifusion_f32')
    per = flops.layers(tree, 'train')
    no_dx = {k for k in per if any(k == p.format(j=j) for p in flops.NO_INPUT_GRADIENT
                                   for j in range(4))}
    assert len(no_dx) == 4  # the two scales of RPN sa0, the image stem, the RCNN's xyz layer
    assert flops.step_flops(tree, 'train') == pytest.approx(
        3 * sum(per.values()) - sum(per[k] for k in no_dx), rel=1e-12)
    # train runs the RCNN on ROI_PER_IMAGE sampled RoIs, eval on the TEST proposals
    ev = flops.layers(tree, 'eval')
    assert ev['rcnn.cls_out.weight'] / per['rcnn.cls_out.weight'] == 100 / 64


def test_hand_counts():
    tree = _tree('epnet_lifusion_f32')
    per = flops.layers(tree, 'eval')
    assert per['rpn.backbone.sa0.SharedMLP_1.PointwiseConv_0.Dense_0.weight'] == \
        2 * 4096 * 32 * 3 * 32
    assert per['rpn.backbone.img_block0.Conv2dBlock_1.Conv_0.weight'] == \
        2 * 192 * 640 * 9 * 64 * 64
    assert per['rpn.backbone.deconv_fusion.deconv3_kernel'] == 2 * 384 * 1280 * 512 * 16
    assert per['rcnn.sa2.SharedMLP_0.PointwiseConv_0.Dense_0.weight'] == 2 * 100 * 32 * 259 * 256


def _cost_model_products(mode):
    os.environ['MODE'] = mode
    try:
        g = runpy.run_path(str(ROOT / 'tools' / 'baseline_cost_model.py'), run_name='cost_model')
    finally:
        del os.environ['MODE']
    per = collections.defaultdict(float)
    rows = {}
    for stage, name, fl, _, _ in g['rows']:
        if any(w in name for w in ('ball', '3nn', 'nms', 'roipool', 'iou')):
            continue  # comparisons and distances, not products
        per[stage] += fl
        rows[stage, name] = fl
    return per, rows, g['B']


def _stage(key):
    if '.img_block' in key or 'deconv_fusion' in key:
        return 'img'
    if key.startswith('rpn.backbone.sa'):
        return 'rpn-sa'
    if key.startswith('rpn.backbone.fp'):
        return 'rpn-fp'
    if 'fusion' in key:
        return 'fusion'
    return 'rpn-head' if key.startswith('rpn.') else 'rcnn'


def test_counter_against_the_cost_model():
    """Stage by stage at batch 4, eval: equal once the cost model's own
    departures from the model are undone, each named here."""
    per, rows, B = _cost_model_products('eval')
    tree = _tree('epnet_lifusion_f32')
    mine = collections.defaultdict(float)
    for k, v in flops.layers(tree, 'eval').items():
        mine[_stage(k)] += B * v
    # img: the cost model counts each stride-2 conv at its input resolution
    # (4x its outputs) and leaves out the 1x1 fusion of the deconv maps
    s2 = sum(v for (st, k), v in rows.items() if st == 'img' and k.endswith('(s2)'))
    fusion_1x1 = B * flops.layers(tree, 'eval')['rpn.backbone.deconv_fusion.fusion_kernel']
    assert mine['img'] == pytest.approx(per['img'] - 0.75 * s2 + fusion_1x1, rel=1e-9)
    # rpn-sa: the cost model feeds sa0 6 channels (3 + 3); the recipe's
    # points have none beside xyz, so sa0's first layers see 3
    sa0_extra = 2 * B * 4096 * (16 * 16 + 32 * 32) * 3
    assert mine['rpn-sa'] == pytest.approx(per['rpn-sa'] - sa0_extra, rel=1e-9)
    # rpn-fp: the cost model's fp0 and fp1 inputs are 192 and 384 channels;
    # the model's are 256 (fp1's 256) and 608 (fp2's 512 + level 1's 96)
    fp_fix = 2 * B * (16384 * 128 * (256 - 192) + 4096 * 256 * (608 - 384))
    assert mine['rpn-fp'] == pytest.approx(per['rpn-fp'] + fp_fix, rel=1e-9)
    # fusion: the cost model charges the attention fusions bandwidth only
    assert per['fusion'] == 0 and mine['fusion'] > 0
    assert mine['rpn-head'] == pytest.approx(per['rpn-head'], rel=1e-9)
    # rcnn: the cost model's group-all stage takes 64 rows a RoI, where it
    # groups the 32 points that sa1 leaves, and its reg head has 52 outputs,
    # where the recipe's has 46 (6 x bins, 2 x 9 heading, 3 sizes, 1 y)
    sa2 = sum(v for (st, k), v in rows.items() if st == 'rcnn' and k.startswith('sa2.mlp'))
    reg_fix = 2 * B * 100 * 512 * (52 - 46)
    assert mine['rcnn'] == pytest.approx(per['rcnn'] - sa2 / 2 - reg_fix, rel=1e-9)
