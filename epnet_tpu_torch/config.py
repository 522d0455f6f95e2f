"""The configuration tree: frozen dataclasses, the strict YAML merge and
dotted-path overrides.

The port's own copy of ``epnet_tpu/config.py`` (reference
``lib/config.py``): the same fields, defaults and merge rules, so that the
reference's experiment files load unchanged (defaults <- ``_BASE_`` chain
<- YAML <- overrides). ``tests/test_torch_config.py`` holds every field and
every ``cfgs/*.yaml`` equal to the JAX package's.

``parity_config()`` builds the published recipe
(``cfgs/LI_Fusion_with_attention_use_ce_loss.yaml``) in code, for machines
without PyYAML; the same test holds it equal to the yaml.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from dataclasses import dataclass, field, fields, replace
from typing import Optional, Tuple


def _tup(x):
    """Lists to tuples, recursively, so that the config stays hashable."""
    if isinstance(x, (list, tuple)):
        return tuple(_tup(v) for v in x)
    return x


@dataclass(frozen=True)
class LIFusionConfig:
    """LI-Fusion (reference ``lib/config.py:36-45``)."""

    ENABLED: bool = False
    IMG_FEATURES_CHANNEL: int = 128
    ADD_Image_Attention: bool = False
    IMG_CHANNELS: Tuple[int, ...] = (3, 64, 128, 256, 512)
    POINT_CHANNELS: Tuple[int, ...] = (96, 256, 512, 1024)
    DeConv_Reduce: Tuple[int, ...] = (16, 16, 16, 16)
    DeConv_Kernels: Tuple[int, ...] = (2, 4, 8, 16)
    DeConv_Strides: Tuple[int, ...] = (2, 4, 8, 16)


@dataclass(frozen=True)
class SAConfigRPN:
    """PointNet++ MSG set abstraction (reference ``lib/config.py:70-78``)."""

    NPOINTS: Tuple[int, ...] = (4096, 1024, 256, 64)
    RADIUS: Tuple[Tuple[float, ...], ...] = ((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
    NSAMPLE: Tuple[Tuple[int, ...], ...] = ((16, 32), (16, 32), (16, 32), (16, 32))
    MLPS: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
        ((16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 96, 128)),
        ((128, 196, 256), (128, 196, 256)),
        ((256, 256, 512), (256, 384, 512)),
    )


@dataclass(frozen=True)
class RPNConfig:
    """Reference ``lib/config.py:49-93``. ``SAMPLING``, ``FPS_GROUPS``,
    ``BLOCK_*`` and ``FP_*`` are the JAX package's approximation knobs.
    ``BLOCK_*`` drive the block-local configuration (``BLOCK_LOCAL_SET``);
    the port keeps the others so that its files load, and ``EPNet`` refuses
    any value of them but the exact default."""

    ENABLED: bool = True
    FIXED: bool = False
    USE_INTENSITY: bool = True
    USE_RGB: bool = False
    LOC_XZ_FINE: bool = False
    LOC_SCOPE: float = 3.0
    LOC_BIN_SIZE: float = 0.5
    NUM_HEAD_BIN: int = 12
    BACKBONE: str = 'pointnet2_msg'
    USE_BN: bool = True
    NUM_POINTS: int = 16384
    SAMPLING: str = 'fps'  # 'fps' (the reference) or 'random'
    FPS_GROUPS: int = 1    # 1 = exact FPS over the whole cloud
    BLOCK_LOCAL: bool = False
    BLOCK_WINDOW: int = 1024
    BLOCK_C: int = 128
    FP_WINDOW: int = 0     # 0 = dense 3-NN interpolation
    FP_UBLOCK: int = 256
    SA_CONFIG: SAConfigRPN = field(default_factory=SAConfigRPN)
    FP_MLPS: Tuple[Tuple[int, ...], ...] = ((128, 128), (256, 256), (512, 512), (512, 512))
    CLS_FC: Tuple[int, ...] = (128,)
    REG_FC: Tuple[int, ...] = (128,)
    DP_RATIO: float = 0.5
    LOSS_CLS: str = 'DiceLoss'
    FG_WEIGHT: float = 15
    FOCAL_ALPHA: Tuple[float, ...] = (0.25, 0.75)
    FOCAL_GAMMA: float = 2.0
    REG_LOSS_WEIGHT: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    LOSS_WEIGHT: Tuple[float, ...] = (1.0, 1.0)
    NMS_TYPE: str = 'normal'  # normal | rotate
    SCORE_THRESH: float = 0.3

    @property
    def per_loc_bin_num(self) -> int:
        return int(self.LOC_SCOPE / self.LOC_BIN_SIZE) * 2

    @property
    def reg_channel(self) -> int:
        # layout of reference lib/net/rpn.py:35-40
        n = self.per_loc_bin_num
        c = n * 4 if self.LOC_XZ_FINE else n * 2
        return c + self.NUM_HEAD_BIN * 2 + 3 + 1  # +1 = y offset


@dataclass(frozen=True)
class SAConfigRCNN:
    """Reference ``lib/config.py:130-136``."""

    NPOINTS: Tuple[int, ...] = (128, 32, -1)
    RADIUS: Tuple[float, ...] = (0.2, 0.4, 100)
    NSAMPLE: Tuple[int, ...] = (64, 64, 64)
    MLPS: Tuple[Tuple[int, ...], ...] = ((128, 128, 128), (128, 128, 256), (256, 256, 512))


@dataclass(frozen=True)
class RCNNConfig:
    """Reference ``lib/config.py:96-158``. ``BLOCK_*`` are the windowed
    RCNN SA's knobs (the block-local configuration, ``BLOCK_LOCAL_SET``)."""

    ENABLED: bool = False
    USE_RPN_FEATURES: bool = True
    USE_MASK: bool = True
    MASK_TYPE: str = 'seg'
    USE_INTENSITY: bool = False
    USE_DEPTH: bool = True
    USE_SEG_SCORE: bool = False
    ROI_SAMPLE_JIT: bool = False
    ROI_FG_AUG_TIMES: int = 10
    REG_AUG_METHOD: str = 'multiple'  # multiple | single | normal
    POOL_EXTRA_WIDTH: float = 1.0
    USE_RGB: bool = False
    LOC_SCOPE: float = 1.5
    LOC_BIN_SIZE: float = 0.5
    NUM_HEAD_BIN: int = 9
    LOC_Y_BY_BIN: bool = False
    LOC_Y_SCOPE: float = 0.5
    LOC_Y_BIN_SIZE: float = 0.25
    SIZE_RES_ON_ROI: bool = False
    USE_BN: bool = False
    DP_RATIO: float = 0.0
    BACKBONE: str = 'pointnet'
    BLOCK_LOCAL: bool = False
    BLOCK_WINDOW: int = 256
    BLOCK_C: int = 32
    XYZ_UP_LAYER: Tuple[int, ...] = (128, 128)
    NUM_POINTS: int = 512
    SA_CONFIG: SAConfigRCNN = field(default_factory=SAConfigRCNN)
    CLS_FC: Tuple[int, ...] = (256, 256)
    REG_FC: Tuple[int, ...] = (256, 256)
    LOSS_CLS: str = 'BinaryCrossEntropy'
    FOCAL_ALPHA: Tuple[float, ...] = (0.25, 0.75)
    FOCAL_GAMMA: float = 2.0
    CLS_WEIGHT: Tuple[float, ...] = (1.0, 1.0, 1.0)
    CLS_FG_THRESH: float = 0.6
    CLS_BG_THRESH: float = 0.45
    CLS_BG_THRESH_LO: float = 0.05
    REG_FG_THRESH: float = 0.55
    FG_RATIO: float = 0.5
    ROI_PER_IMAGE: int = 64
    HARD_BG_RATIO: float = 0.6
    IOU_LOSS_TYPE: str = 'raw'
    IOU_ANGLE_POWER: int = 1
    SCORE_THRESH: float = 0.3
    NMS_THRESH: float = 0.1

    @property
    def per_loc_bin_num(self) -> int:
        return int(self.LOC_SCOPE / self.LOC_BIN_SIZE) * 2

    @property
    def loc_y_bin_num(self) -> int:
        return int(self.LOC_Y_SCOPE / self.LOC_Y_BIN_SIZE) * 2

    @property
    def reg_channel(self) -> int:
        # layout of reference lib/net/rcnn_net.py:78-81
        c = self.per_loc_bin_num * 4 + self.NUM_HEAD_BIN * 2 + 3
        c += 1 if not self.LOC_Y_BY_BIN else self.loc_y_bin_num * 2
        return c

    @property
    def input_channel(self) -> int:
        # xyz + mask + depth (+ intensity); reference lib/net/rcnn_net.py:22
        return 3 + int(self.USE_INTENSITY) + int(self.USE_MASK) + int(self.USE_DEPTH)


@dataclass(frozen=True)
class TrainConfig:
    """Reference ``lib/config.py:161-199``."""

    SPLIT: str = 'train'
    VAL_SPLIT: str = 'smallval'
    LR: float = 0.002
    LR_CLIP: float = 0.00001
    LR_DECAY: float = 0.5
    DECAY_STEP_LIST: Tuple[int, ...] = (50, 100, 150, 200, 250, 300)
    LR_WARMUP: bool = False
    WARMUP_MIN: float = 0.0002
    WARMUP_EPOCH: int = 5
    BN_MOMENTUM: float = 0.9
    BN_DECAY: float = 0.5
    BNM_CLIP: float = 0.01
    BN_DECAY_STEP_LIST: Tuple[int, ...] = (50, 100, 150, 200, 250, 300)
    OPTIMIZER: str = 'adam'
    WEIGHT_DECAY: float = 0.0
    MOMENTUM: float = 0.9
    MOMS: Tuple[float, ...] = (0.95, 0.85)
    DIV_FACTOR: float = 10.0
    PCT_START: float = 0.4
    GRAD_NORM_CLIP: float = 1.0
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2048
    RPN_NMS_THRESH: float = 0.85
    RPN_DISTANCE_BASED_PROPOSE: bool = True
    RPN_TRAIN_WEIGHT: float = 1.0
    RCNN_TRAIN_WEIGHT: float = 1.0
    CE_WEIGHT: float = 5.0
    IOU_LOSS_TYPE: str = 'cls_mask_with_bin'
    BBOX_AVG_BY_BIN: bool = True
    RY_WITH_BIN: bool = False


@dataclass(frozen=True)
class TestConfig:
    """Reference ``lib/config.py:201-209``."""

    SPLIT: str = 'val'
    RPN_PRE_NMS_TOP_N: int = 9000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_NMS_THRESH: float = 0.7
    RPN_DISTANCE_BASED_PROPOSE: bool = True
    BBOX_AVG_BY_BIN: bool = True
    RY_WITH_BIN: bool = False


@dataclass(frozen=True)
class Config:
    """Top-level config; defaults of reference ``lib/config.py:8-209``.
    ``MIXED_PRECISION`` (bf16 matmuls) and ``EXACT_QUERIES`` (True, False,
    'residual' or None for the backend's default) are the JAX package's
    keys; the port runs every value of both."""

    TAG: str = 'default'
    CLASSES: str = 'Car'
    INCLUDE_SIMILAR_TYPE: bool = False
    AUG_DATA: bool = True
    AUG_METHOD_LIST: Tuple[str, ...] = ('rotation', 'scaling', 'flip')
    AUG_METHOD_PROB: Tuple[float, ...] = (0.5, 0.5, 0.5)
    AUG_ROT_RANGE: float = 18
    GT_AUG_ENABLED: bool = False
    GT_EXTRA_NUM: int = 15
    GT_AUG_RAND_NUM: bool = False
    GT_AUG_APPLY_PROB: float = 0.75
    GT_AUG_HARD_RATIO: float = 0.6
    PC_REDUCE_BY_RANGE: bool = True
    PC_AREA_SCOPE: Tuple[Tuple[float, float], ...] = ((-40, 40), (-1, 3), (0, 70.4))
    CLS_MEAN_SIZE: Tuple[Tuple[float, ...], ...] = ((1.52, 1.63, 3.88),)
    USE_IOU_BRANCH: bool = False
    MIXED_PRECISION: bool = False
    EXACT_QUERIES: Optional[bool] = None  # True | False | 'residual' | None
    LI_FUSION: LIFusionConfig = field(default_factory=LIFusionConfig)
    RPN: RPNConfig = field(default_factory=RPNConfig)
    RCNN: RCNNConfig = field(default_factory=RCNNConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)

    @property
    def num_classes(self) -> int:
        """Including background."""
        return 3 if self.CLASSES == 'People' else 2

    def get(self, mode: str):
        """``cfg['TRAIN']`` / ``cfg['TEST']`` lookup of the proposal layer."""
        if mode == 'TRAIN':
            return self.TRAIN
        if mode in ('TEST', 'EVAL'):
            return self.TEST
        raise KeyError(mode)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    def merged(self, updates: dict) -> 'Config':
        """Strictly merge a nested dict (parsed YAML) into this config, as
        the reference's ``_merge_a_into_b`` (``lib/config.py:221-248``):
        unknown keys raise, scalar types must match (an int may fill a
        float)."""
        return _merge(self, updates)

    def with_overrides(self, kv_pairs) -> 'Config':
        """Dotted-path overrides ``[('RPN.LOC_SCOPE', '3.0'), ...]``, as
        ``cfg_from_list`` (``lib/config.py:251-270``)."""
        from ast import literal_eval

        cfg = self
        for k, v in kv_pairs:
            if isinstance(v, str):
                try:
                    v = literal_eval(v)
                except (ValueError, SyntaxError):
                    pass  # keep as a string
            parts = k.split('.')
            nested: dict = {parts[-1]: v}
            for p in reversed(parts[:-1]):
                nested = {p: nested}
            cfg = cfg.merged(nested)
        return cfg


def _merge(node, updates: dict):
    if not dataclasses.is_dataclass(node):
        raise TypeError(f'cannot merge into non-dataclass {node!r}')
    valid = {f.name: f for f in fields(node)}
    changes = {}
    for k, v in updates.items():
        if k not in valid:
            raise KeyError(f'{k} is not a valid config key')
        old = getattr(node, k)
        if dataclasses.is_dataclass(old):
            if not isinstance(v, dict):
                raise ValueError(f'config key {k} expects a mapping, got {type(v)}')
            changes[k] = _merge(old, v)
            continue
        v = _tup(v)
        if k == 'EXACT_QUERIES' and v == 'residual':  # the one tri-state key
            changes[k] = v
            continue
        if old is not None and v is not None:
            if isinstance(old, bool) != isinstance(v, bool):
                raise ValueError(f'type mismatch for config key {k}: {type(old)} vs {type(v)}')
            if isinstance(old, float) and isinstance(v, int):
                v = float(v)
            if isinstance(old, tuple) != isinstance(v, tuple):
                raise ValueError(f'type mismatch for config key {k}: {type(old)} vs {type(v)}')
            if not isinstance(old, tuple) and type(old) is not type(v):
                raise ValueError(f'type mismatch for config key {k}: {type(old)} vs {type(v)}')
        changes[k] = v
    return replace(node, **changes)


def load_config(yaml_file: Optional[str] = None, overrides=None) -> Config:
    """defaults <- (optional ``_BASE_`` chain) <- YAML file <- overrides."""
    cfg = Config()

    def apply(path):
        nonlocal cfg
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        base = data.pop('_BASE_', None)
        if base:
            apply(os.path.join(os.path.dirname(path), base))
        if data:
            cfg = cfg.merged(data)

    if yaml_file is not None:
        apply(yaml_file)
    if overrides:
        cfg = cfg.with_overrides(overrides)
    return cfg


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


def save_config(cfg: Config, logger=None, pre: str = 'cfg') -> None:
    """Dump every key, as the reference's ``save_config_to_file``
    (``lib/config.py``; JAX ``save_config``), through ``logger.info`` or
    ``print``."""
    emit = logger.info if logger is not None else print

    def rec(node, prefix):
        for f in fields(node):
            val = getattr(node, f.name)
            if dataclasses.is_dataclass(val):
                emit(f'\n{prefix}.{f.name} = edict()')
                rec(val, f'{prefix}.{f.name}')
            else:
                emit(f'{prefix}.{f.name}: {val}')

    rec(cfg, pre)


def parity_config() -> Config:
    """The published recipe (LI-Fusion + image attention + CE loss), f32
    with exact queries, without reading the yaml."""
    return Config().merged(_PARITY)


# ``__graft_entry__._full_config`` at its environment defaults, key for key:
# the defaults merged with the published recipe's main keys, in bf16, with
# the approximate queries, exact FPS and neither block-local path.
_HEADLINE = {
    'CLASSES': 'Car',
    'INCLUDE_SIMILAR_TYPE': True,
    'MIXED_PRECISION': True,
    'EXACT_QUERIES': False,
    'CLS_MEAN_SIZE': ((1.52563191462, 1.62856739989, 3.88311640418),),
    'LI_FUSION': {'ENABLED': True, 'ADD_Image_Attention': True},
    'RPN': {'USE_INTENSITY': False, 'LOC_XZ_FINE': True,
            'LOSS_CLS': 'SigmoidFocalLoss', 'SCORE_THRESH': 0.2,
            'FPS_GROUPS': 1, 'BLOCK_LOCAL': False, 'FP_WINDOW': 0, 'FP_UBLOCK': 256},
    'RCNN': {'ENABLED': True, 'ROI_SAMPLE_JIT': True,
             'POOL_EXTRA_WIDTH': 0.2, 'HARD_BG_RATIO': 0.8,
             'CLS_FC': (512, 512), 'REG_FC': (512, 512),
             'SCORE_THRESH': 0.2, 'NMS_THRESH': 0.1, 'BLOCK_LOCAL': False},
    'TRAIN': {'OPTIMIZER': 'adam_onecycle', 'WEIGHT_DECAY': 0.001,
              'LR_WARMUP': True, 'WARMUP_EPOCH': 1,
              'BN_MOMENTUM': 0.1, 'BN_DECAY_STEP_LIST': (1000,),
              'RPN_PRE_NMS_TOP_N': 9000, 'RPN_POST_NMS_TOP_N': 512,
              'RPN_NMS_THRESH': 0.85,
              'IOU_LOSS_TYPE': 'cls_mask_with_bin'},
    'TEST': {'RPN_PRE_NMS_TOP_N': 9000, 'RPN_POST_NMS_TOP_N': 100,
             'RPN_NMS_THRESH': 0.8},
}


def headline_config() -> Config:
    """The JAX package's headline configuration, the one ``entry()`` builds
    and ``bench.py`` times (``__graft_entry__.py:8-87``), at its
    environment's defaults: the recipe's model in bf16 (``MIXED_PRECISION``)
    with the approximate queries (``EXACT_QUERIES`` false), exact FPS and
    no block-local path. Reads no environment variable; the ball policy is
    ``EPNet``'s argument (JAX's default, ``first_nested``, unless given)."""
    return Config().merged(_HEADLINE)


# The block-local configuration's three overrides, as the CLI's ``--set``
# takes them: block-local SA/FP and windowed RCNN SA, other queries exact.
BLOCK_LOCAL_SET = ('EXACT_QUERIES', 'residual', 'RPN.BLOCK_LOCAL', 'True',
                   'RCNN.BLOCK_LOCAL', 'True')


def block_local_config(cfg: Config) -> Config:
    """``cfg`` with ``BLOCK_LOCAL_SET`` applied."""
    return cfg.with_overrides(list(zip(BLOCK_LOCAL_SET[0::2], BLOCK_LOCAL_SET[1::2])))


__all__ = ['Config', 'load_config', 'save_config', 'parity_config', 'headline_config',
           'PARITY_YAML']
