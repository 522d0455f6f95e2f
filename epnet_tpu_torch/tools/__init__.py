"""Command-line entry points, run as ``python -m epnet_tpu_torch.tools.<name>``."""

import argparse
import contextlib
import logging
from typing import Dict, List


@contextlib.contextmanager
def cli_logger(name: str, log_file: str):
    """The logger ``name`` writing to the console and to ``log_file`` for
    one CLI run; its handlers close when the run ends."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    for h in (logging.StreamHandler(), logging.FileHandler(log_file)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    try:
        yield logger
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()


# The model and data switches both CLIs take, each the port's form of one
# of the JAX package's ``EPNET_*`` environment switches: flag -> (argparse
# keywords, the JAX switch).
MODEL_FLAGS = {
    '--ball_policy': (dict(type=str, default='first_nested',
                           choices=('first_nested', 'first_multi', 'nearest'),
                           help='multi-scale ball policy of the approximate queries'),
                      'EPNET_BALL_POLICY'),
    '--exact_ops': (dict(type=str, default='',
                         help='comma list of ball,three_nn,roipool kept exact under the '
                              'approximate queries'), 'EPNET_EXACT_OPS'),
    '--ball_f32': (dict(action='store_true', help='f32 keys for the nearest-first ball'),
                   'EPNET_BALL_F32'),
    '--three_nn_f32': (dict(action='store_true', help='f32 field for the approximate 3-NN'),
                       'EPNET_3NN_F32'),
    '--dense_fp': (dict(action='store_true',
                        help='FP through the dense 3-NN while SA stays block-local'),
                   'EPNET_FP_BLOCK=0'),
    '--img_f32': (dict(action='store_true', help='the image tower in f32 under '
                                                 'MIXED_PRECISION'), 'EPNET_IMG_F32'),
    '--img_cache': (dict(type=str, default=None,
                         help='directory caching the decoded images as .npy'),
                    'EPNET_IMG_CACHE'),
}


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """``MODEL_FLAGS`` on ``p``."""
    for flag, (kw, _) in MODEL_FLAGS.items():
        p.add_argument(flag, **kw)


def model_switches(args: argparse.Namespace) -> Dict:
    """``EPNet``'s keyword arguments from ``MODEL_FLAGS``: ``queries``,
    ``fp_block`` and ``img_f32``."""
    from ..ops.pointops import QueryOptions

    return dict(queries=QueryOptions(args.ball_policy, args.exact_ops, args.ball_f32,
                                     args.three_nn_f32),
                fp_block=not args.dense_fp, img_f32=args.img_f32)


def model_flag_argv(args: argparse.Namespace) -> List[str]:
    """The ``MODEL_FLAGS`` given in ``args`` (set, and not empty), as a
    command line in ``MODEL_FLAGS``' order: the pin and the campaign hand
    them on, and leave out a flag not given, so that its CLI takes its
    default."""
    argv = []
    for flag in MODEL_FLAGS:
        value = getattr(args, flag[2:])
        if value is True:
            argv.append(flag)
        elif value not in (None, False, ''):
            argv += [flag, str(value)]
    return argv
