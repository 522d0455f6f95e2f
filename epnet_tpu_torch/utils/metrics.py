"""Scalar logging of training and evaluation.

Port of ``epnet_tpu/utils/metrics.py`` (the reference logs every loss
component to tensorboardX, ``train_utils.py:182,208-212``): one JSON record
a scalar in ``<log_dir>/scalars.jsonl``, the source of truth, and a
TensorBoard mirror when ``torch.utils.tensorboard`` can be imported.
"""

from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, 'scalars.jsonl'), 'a', buffering=1)
        self._tb = None
        try:  # the optional TF-events mirror
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._tb = TBWriter(log_dir)
        except Exception:
            pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({'t': time.time(), 'tag': tag, 'value': float(value),
                                  'step': int(step)}) + '\n')
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
