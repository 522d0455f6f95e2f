"""The configuration tree, shared with the JAX package.

``epnet_tpu/config.py`` is framework-free (frozen dataclasses, a lazy
``import yaml``), so this module loads that one file by path and re-exports
it: both packages read one definition, and ``epnet_tpu/__init__.py`` (which
imports jax) never runs.

``parity_config()`` builds the published recipe
(``cfgs/LI_Fusion_with_attention_use_ce_loss.yaml``) in code, for machines
without PyYAML; ``tests/test_torch_config.py`` holds it equal to the yaml.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

_SOURCE = pathlib.Path(__file__).resolve().parents[1] / 'epnet_tpu' / 'config.py'
_NAME = 'epnet_tpu_torch._shared_config'


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _SOURCE)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolve their module through sys.modules while the
    # classes are built, so register before executing
    sys.modules[_NAME] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[_NAME]
        raise
    return mod


_shared = _load()
Config = _shared.Config
load_config = _shared.load_config

PARITY_YAML = pathlib.Path(__file__).resolve().parents[1] / 'cfgs' / \
    'LI_Fusion_with_attention_use_ce_loss.yaml'

# Values of cfgs/LI_Fusion_with_attention_use_ce_loss.yaml, key for key.
_PARITY = {
    'CLASSES': 'Car',
    'INCLUDE_SIMILAR_TYPE': True,
    'AUG_DATA': True,
    'AUG_METHOD_LIST': ('rotation', 'scaling', 'flip'),
    'AUG_METHOD_PROB': (1.0, 1.0, 0.5),
    'AUG_ROT_RANGE': 18,
    'GT_AUG_ENABLED': False,
    'GT_EXTRA_NUM': 15,
    'GT_AUG_RAND_NUM': True,
    'GT_AUG_APPLY_PROB': 1.0,
    'GT_AUG_HARD_RATIO': 0.6,
    'PC_REDUCE_BY_RANGE': True,
    'PC_AREA_SCOPE': ((-40, 40), (-1, 3), (0, 70.4)),
    'CLS_MEAN_SIZE': ((1.52563191462, 1.62856739989, 3.88311640418),),
    'USE_IOU_BRANCH': False,
    'LI_FUSION': {
        'ENABLED': True,
        'ADD_Image_Attention': True,
        'IMG_FEATURES_CHANNEL': 128,
        'IMG_CHANNELS': (3, 64, 128, 256, 512),
        'POINT_CHANNELS': (96, 256, 512, 1024),
        'DeConv_Reduce': (16, 16, 16, 16),
        'DeConv_Kernels': (2, 4, 8, 16),
        'DeConv_Strides': (2, 4, 8, 16),
    },
    'RPN': {
        'ENABLED': True,
        'FIXED': False,
        'USE_INTENSITY': False,
        'LOC_XZ_FINE': True,
        'LOC_SCOPE': 3.0,
        'LOC_BIN_SIZE': 0.5,
        'NUM_HEAD_BIN': 12,
        'BACKBONE': 'pointnet2_msg',
        'USE_BN': True,
        'NUM_POINTS': 16384,
        'SA_CONFIG': {
            'NPOINTS': (4096, 1024, 256, 64),
            'RADIUS': ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0)),
            'NSAMPLE': ((16, 32), (16, 32), (16, 32), (16, 32)),
            'MLPS': (((16, 16, 32), (32, 32, 64)),
                     ((64, 64, 128), (64, 96, 128)),
                     ((128, 196, 256), (128, 196, 256)),
                     ((256, 256, 512), (256, 384, 512))),
        },
        'FP_MLPS': ((128, 128), (256, 256), (512, 512), (512, 512)),
        'CLS_FC': (128,),
        'REG_FC': (128,),
        'DP_RATIO': 0.5,
        'LOSS_CLS': 'SigmoidFocalLoss',
        'FG_WEIGHT': 15,
        'FOCAL_ALPHA': (0.25, 0.75),
        'FOCAL_GAMMA': 2.0,
        'REG_LOSS_WEIGHT': (1.0, 1.0, 1.0, 1.0),
        'LOSS_WEIGHT': (1.0, 1.0),
        'NMS_TYPE': 'normal',
        'SCORE_THRESH': 0.2,
    },
    'RCNN': {
        'ENABLED': True,
        'ROI_SAMPLE_JIT': True,
        'REG_AUG_METHOD': 'multiple',
        'ROI_FG_AUG_TIMES': 10,
        'USE_RPN_FEATURES': True,
        'USE_MASK': True,
        'MASK_TYPE': 'seg',
        'USE_INTENSITY': False,
        'USE_DEPTH': True,
        'USE_SEG_SCORE': False,
        'POOL_EXTRA_WIDTH': 0.2,
        'LOC_SCOPE': 1.5,
        'LOC_BIN_SIZE': 0.5,
        'NUM_HEAD_BIN': 9,
        'LOC_Y_BY_BIN': False,
        'LOC_Y_SCOPE': 0.5,
        'LOC_Y_BIN_SIZE': 0.25,
        'SIZE_RES_ON_ROI': False,
        'USE_BN': False,
        'DP_RATIO': 0.0,
        'BACKBONE': 'pointnet',
        'XYZ_UP_LAYER': (128, 128),
        'NUM_POINTS': 512,
        'SA_CONFIG': {
            'NPOINTS': (128, 32, -1),
            'RADIUS': (0.2, 0.4, 100),
            'NSAMPLE': (64, 64, 64),
            'MLPS': ((128, 128, 128), (128, 128, 256), (256, 256, 512)),
        },
        'CLS_FC': (512, 512),
        'REG_FC': (512, 512),
        'LOSS_CLS': 'BinaryCrossEntropy',
        'FOCAL_ALPHA': (0.25, 0.75),
        'FOCAL_GAMMA': 2.0,
        'CLS_WEIGHT': (1.0, 1.0, 1.0),
        'CLS_FG_THRESH': 0.6,
        'CLS_BG_THRESH': 0.45,
        'CLS_BG_THRESH_LO': 0.05,
        'REG_FG_THRESH': 0.55,
        'FG_RATIO': 0.5,
        'ROI_PER_IMAGE': 64,
        'HARD_BG_RATIO': 0.8,
        'SCORE_THRESH': 0.2,
        'NMS_THRESH': 0.1,
    },
    'TRAIN': {
        'SPLIT': 'train',
        'VAL_SPLIT': 'smallval',
        'LR': 0.002,
        'LR_CLIP': 0.00001,
        'LR_DECAY': 0.5,
        'DECAY_STEP_LIST': (100, 150, 180, 200),
        'LR_WARMUP': True,
        'WARMUP_MIN': 0.0002,
        'WARMUP_EPOCH': 1,
        'BN_MOMENTUM': 0.1,
        'BN_DECAY': 0.5,
        'BNM_CLIP': 0.01,
        'BN_DECAY_STEP_LIST': (1000,),
        'OPTIMIZER': 'adam_onecycle',
        'WEIGHT_DECAY': 0.001,
        'MOMENTUM': 0.9,
        'MOMS': (0.95, 0.85),
        'DIV_FACTOR': 10.0,
        'PCT_START': 0.4,
        'GRAD_NORM_CLIP': 1.0,
        'RPN_PRE_NMS_TOP_N': 9000,
        'RPN_POST_NMS_TOP_N': 512,
        'RPN_NMS_THRESH': 0.85,
        'RPN_DISTANCE_BASED_PROPOSE': True,
        'RPN_TRAIN_WEIGHT': 1.0,
        'RCNN_TRAIN_WEIGHT': 1.0,
        'CE_WEIGHT': 5.0,
        'IOU_LOSS_TYPE': 'cls_mask_with_bin',
        'BBOX_AVG_BY_BIN': True,
        'RY_WITH_BIN': False,
    },
    'TEST': {
        'SPLIT': 'val',
        'RPN_PRE_NMS_TOP_N': 9000,
        'RPN_POST_NMS_TOP_N': 100,
        'RPN_NMS_THRESH': 0.8,
        'RPN_DISTANCE_BASED_PROPOSE': True,
        'BBOX_AVG_BY_BIN': True,
        'RY_WITH_BIN': False,
    },
    'MIXED_PRECISION': False,
    'EXACT_QUERIES': True,
}


def parity_config() -> Config:
    """The published recipe (LI-Fusion + image attention + CE loss), f32
    with exact queries, without reading the yaml."""
    return Config().merged(_PARITY)


__all__ = ['Config', 'load_config', 'parity_config', 'PARITY_YAML']
