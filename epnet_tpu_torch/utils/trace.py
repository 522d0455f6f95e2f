"""Spans and counters inside the program, off unless ``recording()``.

``span(name)`` marks a stage. Off, it returns one shared no-op context
after a single check of a module flag: no allocation, no clock read, no
device work. Recording, it opens ``torch.profiler.record_function(
'epnet::<name>')``, so that under ``torch.profiler`` the stage lies in the
same event list, on the same clock, as the CUDA kernels, and it records a
``Span`` (name, enclosing span, request id, start and end in
``time.perf_counter_ns()``). A span never synchronizes. A span opened when
none is open starts a new request id, which every span inside it carries:
``request`` (``eval.detect.joint_eval_step``) and ``step``
(``train.trainer.train_step``) hold the stages ``rpn``, ``proposal``,
``target``, ``rcnn`` (``models.epnet.EPNet``), ``detect``, ``loss``,
``backward`` and ``optimizer``.

``count(name, n)`` adds ``n`` to the counter ``(innermost open span,
name)`` while recording. ``n`` is an int, or a tensor on the device, kept
by reference and summed only in ``Recorder.snapshot()``, so that counting
adds no device op and no host sync. ``host_int(t)`` is ``int(t)``, a read
of a device value to the host, counted as ``host_syncs``.

    with trace.recording() as rec:
        joint_eval_step(cfg, model, batch)
    snap = rec.snapshot()  # {'spans': [Span, ...], 'counts': {(span, name): int}}

The kernel wrappers keep their own ``.launches``; ``snapshot()`` reports
what each added while recording as the counter ``(None,
'launches.<wrapper>')``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple, Optional

import torch

PREFIX = 'epnet::'  # of each span's range in the profiler's events


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    request: int
    start_ns: int
    end_ns: int


_OFF = contextlib.nullcontext()
_recorder = None  # the Recorder while recording(), else None


def kernel_wrappers() -> list:
    """The CUDA kernel wrappers that count their launches (``.launches``)."""
    from ..ops import conv2d, fps, nms, sa_fused

    found = {}
    for mod in (fps, sa_fused, conv2d, nms):
        for f in vars(mod).values():
            if callable(f) and hasattr(f, 'launches'):
                found[f.__name__] = f
    return list(found.values())


class Recorder:
    """What one ``recording()`` saw: the closed spans in the order they
    closed, and the counters."""

    def __init__(self):
        self.spans = []
        self.stack = []  # names of the open spans, innermost last
        self.requests = 0
        self._counts = collections.Counter()
        self._device = collections.defaultdict(list)
        self._start = {f: f.launches for f in kernel_wrappers()}
        self._end = None

    def close(self) -> None:
        """The end of the recording: the launches counted so far."""
        self._end = {f: f.launches for f in self._start}

    def add(self, name: str, n) -> None:
        key = (self.stack[-1] if self.stack else None, name)
        if isinstance(n, torch.Tensor):
            self._device[key].append(n)
        else:
            self._counts[key] += n

    def snapshot(self) -> dict:
        """The spans and the counters, the device counts summed now (a
        host sync each)."""
        counts = dict(self._counts)
        for key, tensors in self._device.items():
            counts[key] = counts.get(key, 0) + sum(int(t.sum()) for t in tensors)
        for f, start in self._start.items():
            end = f.launches if self._end is None else self._end[f]
            counts[(None, 'launches.' + f.__name__)] = end - start
        return {'spans': list(self.spans), 'counts': counts}


class _Open:
    """A span while recording."""

    __slots__ = ('rec', 'name', 'parent', 'request', 'range', 'start')

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if not rec.stack:
            rec.requests += 1
        self.parent = rec.stack[-1] if rec.stack else None
        self.request = rec.requests - 1
        rec.stack.append(self.name)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.rec.stack.pop()
        self.rec.spans.append(Span(self.name, self.parent, self.request, self.start, end))
        return False


def span(name: str):
    """The stage ``name``: a no-op unless recording."""
    if _recorder is None:
        return _OFF
    return _Open(_recorder, name)


def on() -> bool:
    """Whether a ``recording()`` is under way."""
    return _recorder is not None


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or a device tensor summed at the snapshot) to the
    counter ``name`` of the innermost open span, when recording."""
    if _recorder is not None:
        _recorder.add(name, n)


def host_int(t) -> int:
    """``int(t)``: a read of a device value to the host, which waits for the
    device; counted as ``host_syncs`` when recording."""
    if _recorder is not None:
        _recorder.add('host_syncs', 1)
    return int(t)


@contextlib.contextmanager
def recording():
    """Turn tracing on for the block; yields its ``Recorder``."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError('trace.recording() is already under way')
    rec = Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
        rec.close()
