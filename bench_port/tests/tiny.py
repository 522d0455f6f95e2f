"""Test-width copies of the benchmark's configurations and traffic, for the
CPU: the widths of the port's ``utils/testing.tiny_config`` merged into a
configuration file's model tree, 256 points, a 32 x 64 image."""

from __future__ import annotations

import copy

from bench_port import harness

TINY = {
    'LI_FUSION': {'IMG_FEATURES_CHANNEL': 32, 'IMG_CHANNELS': [3, 8, 16, 24, 32],
                  'POINT_CHANNELS': [24, 48, 96, 192], 'DeConv_Reduce': [4, 4, 4, 4]},
    'RPN': {'NUM_POINTS': 256,
            'SA_CONFIG': {'NPOINTS': [64, 32, 16, 8],
                          'RADIUS': [[0.2, 1.0], [1.0, 2.0], [2.0, 4.0], [4.0, 8.0]],
                          'NSAMPLE': [[8, 16], [8, 16], [8, 16], [8, 16]],
                          'MLPS': [[[8, 8, 12], [8, 8, 12]], [[16, 16, 24], [16, 16, 24]],
                                   [[24, 24, 48], [24, 24, 48]], [[48, 48, 96], [48, 48, 96]]]},
            'FP_MLPS': [[32, 32], [48, 48], [64, 64], [96, 96]],
            'CLS_FC': [32], 'REG_FC': [32]},
    'RCNN': {'NUM_POINTS': 64, 'ROI_PER_IMAGE': 16, 'XYZ_UP_LAYER': [32, 32],
             'SA_CONFIG': {'NPOINTS': [32, 16, -1], 'RADIUS': [0.2, 0.4, 100],
                           'NSAMPLE': [16, 16, 16],
                           'MLPS': [[32, 32, 32], [32, 32, 48], [48, 48, 64]]},
             'CLS_FC': [32, 32], 'REG_FC': [32, 32]},
    'TRAIN': {'RPN_PRE_NMS_TOP_N': 128, 'RPN_POST_NMS_TOP_N': 32},
    'TEST': {'RPN_PRE_NMS_TOP_N': 128, 'RPN_POST_NMS_TOP_N': 16},
}


def _merge(tree: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict):
            _merge(tree[k], v)
        else:
            tree[k] = v
    return tree


def config_file(name: str) -> dict:
    """The configuration file ``configs/<name>.json`` at test widths."""
    f = copy.deepcopy(harness.read_json(harness.HERE / 'configs' / f'{name}.json'))
    _merge(f['model'], TINY)
    f['image_hw'] = [32, 64]
    return f


def traffic(name: str, **over) -> dict:
    t = dict(harness.read_json(harness.HERE / 'traffic' / f'{name}.json'))
    t.update(over)
    return t
