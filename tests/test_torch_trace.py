"""The port's tracer (``epnet_tpu_torch/utils/trace.py``) on the CPU, at
``utils/testing.tiny_config``: off by default; recording changes no result
and adds no ATen op; the span tree of ``joint_eval_step`` and
``train_step``; the ``epnet::`` ranges on the profiler's clock around their
stages' work; ``host_syncs`` per stage against a spy on the host reads.

One module-scoped fixture runs a TEST ``joint_eval_step`` and a TRAIN
``train_step`` each twice under ``torch.profiler``, tracing off and on,
with the spy and the stage markers in place in both runs; the checks are
cases of one parametrised test. No JAX."""

import contextlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from epnet_tpu_torch.eval import detect
from epnet_tpu_torch.models import epnet
from epnet_tpu_torch.models.epnet import EPNet
from epnet_tpu_torch.train import trainer
from epnet_tpu_torch.train.trainer import create_train_state, device_batch, train_step
from epnet_tpu_torch.utils import trace
from epnet_tpu_torch.utils.testing import synthetic_batch, tiny_config

STAGES = {'eval': ('request', ('rpn', 'proposal', 'rcnn', 'detect')),
          'train': ('step', ('rpn', 'proposal', 'target', 'rcnn', 'loss', 'backward',
                             'optimizer'))}
# the Tensor methods that read a value to the host (a sync on the card)
READS = ('__int__', '__float__', '__bool__', '__index__', 'item', 'tolist', 'numpy', 'cpu')
# reads of no device value: ``ops/pointops.in_radius`` rounds radius^2
# through a CPU scalar of its own making
NOT_DEVICE_READS = ('in_radius',)


def _marked(fn, name):
    """``fn`` inside the profiler range ``check::<name>``."""
    def wrapped(*args, **kwargs):
        with record_function('check::' + name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def _instrumented(model, optimizer=None):
    """Each stage's entry points inside a ``check::`` range, and a spy that
    counts the host reads by the innermost open span."""
    reads = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model.rpn, 'forward', _marked(model.rpn.forward, 'rpn'))
        mp.setattr(model, 'proposal', _marked(model.proposal, 'proposal'))
        mp.setattr(model.rcnn, 'forward', _marked(model.rcnn.forward, 'rcnn'))
        mp.setattr(epnet, 'pool_for_eval', _marked(epnet.pool_for_eval, 'rcnn'))
        mp.setattr(epnet, 'proposal_target_layer',
                   _marked(epnet.proposal_target_layer, 'target'))
        mp.setattr(detect, 'decode_bbox_target', _marked(detect.decode_bbox_target, 'detect'))
        mp.setattr(detect, 'nms_bev', _marked(detect.nms_bev, 'detect'))
        mp.setattr(trainer, 'joint_loss', _marked(trainer.joint_loss, 'loss'))
        mp.setattr(torch.Tensor, 'backward', _marked(torch.Tensor.backward, 'backward'))
        if optimizer is not None:
            mp.setattr(optimizer, 'step', _marked(optimizer.step, 'optimizer'))
        for name in READS:
            mp.setattr(torch.Tensor, name, _spied(getattr(torch.Tensor, name), reads))
        yield reads


def _spied(method, reads):
    def spy(self, *args, **kwargs):
        if sys._getframe(1).f_code.co_name not in NOT_DEVICE_READS:
            rec = trace._recorder
            reads.append(rec.stack[-1] if rec is not None and rec.stack else None)
        return method(self, *args, **kwargs)
    return spy


def _profiled(fn, tracing):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() if tracing else contextlib.nullcontext() as rec:
            out = fn()
    snap = rec.snapshot() if tracing else None
    # the profiler's own records, on its clock (``prof.events()`` builds
    # the same intervals some 30 times slower)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, snap, events


def _run(mode, tracing):
    cfg = tiny_config()
    batch = device_batch(synthetic_batch(np.random.RandomState(0), cfg, batch=2,
                                         structured=True), 'cpu')
    if mode == 'eval':
        model = EPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(0))
        model.eval()
        with _instrumented(model) as reads:
            out, snap, events = _profiled(lambda: detect.joint_eval_step(cfg, model, batch),
                                          tracing)
        params = {}
    else:
        state = create_train_state(cfg, 10, device='cpu',
                                   generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        with _instrumented(state.model, state.optimizer) as reads:
            out, snap, events = _profiled(lambda: train_step(state, batch, 0.1, gen), tracing)
        params = dict(state.model.named_parameters())
    return {'out': out, 'params': params, 'snap': snap, 'events': events, 'reads': reads}


@pytest.fixture(scope='module')
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {(mode, on): _run(mode, on) for mode in STAGES for on in (False, True)}
    finally:
        torch.set_num_threads(threads)


def _ranges(events, prefix):
    return [(n[len(prefix):], s, e) for n, s, e in events if n.startswith(prefix)]


def check_off_by_default(off, on, mode):
    assert not trace.on() and trace.span('a') is trace.span('b')
    trace.count('x')  # no recorder: nothing to add to
    assert trace.host_int(torch.tensor(3)) == 3
    assert off['snap'] is None and not _ranges(off['events'], trace.PREFIX)
    with trace.recording() as rec:
        assert trace.on()
    assert not trace.on()
    snap = rec.snapshot()
    assert snap['spans'] == [] and not any(snap['counts'].values())


def check_same_results(off, on, mode):
    keys = sorted(off['out'])
    assert keys == sorted(on['out'])
    for k in keys:
        assert torch.equal(off['out'][k], on['out'][k]), k
    assert sorted(off['params']) == sorted(on['params'])
    for k, p in off['params'].items():
        assert torch.equal(p, on['params'][k]), k


def check_same_aten_ops(off, on, mode):
    def ops(run):
        return [n for n, s, e in sorted(run['events'], key=lambda ev: ev[1])
                if n.startswith('aten::')]
    assert ops(off) and ops(off) == ops(on)


def check_span_tree(off, on, mode):
    top, stages = STAGES[mode]
    spans = on['snap']['spans']
    assert [s.name for s in spans if s.parent is None] == [top]
    assert sorted(s.name for s in spans if s.parent == top) == sorted(stages)
    assert len(spans) == len(stages) + 1 and {s.request for s in spans} == {0}
    outer = next(s for s in spans if s.name == top)
    for s in spans:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    inner = sorted((s.start_ns, s.end_ns) for s in spans if s.parent == top)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(inner, inner[1:]))  # siblings


def check_profiler_clock(off, on, mode):
    top, stages = STAGES[mode]
    spans = _ranges(on['events'], trace.PREFIX)
    assert sorted(n for n, _, _ in spans) == sorted((top,) + stages)
    marks = _ranges(on['events'], 'check::')
    assert {n for n, _, _ in marks} == set(stages)
    aten = [(s, e) for n, s, e in on['events'] if n.startswith('aten::')]
    for name, s0, e0 in marks:
        inside = [(s, e) for s, e in aten if s0 <= s and e <= e0]
        assert inside, name
        assert any(n == name and s <= s0 and e0 <= e for n, s, e in spans), name
    (_, r0, r1), = [r for r in spans if r[0] == top]
    assert all(r0 <= s and e <= r1 for _, s, e in spans)


def check_host_syncs(off, on, mode):
    counted = {span: n for (span, name), n in on['snap']['counts'].items()
               if name == 'host_syncs'}
    spied = {}
    for span in on['reads']:
        spied[span] = spied.get(span, 0) + 1
    assert spied.get('proposal', 0) > 0
    assert counted == spied
    assert len(off['reads']) == len(on['reads'])


CHECKS = [check_off_by_default, check_same_results, check_same_aten_ops, check_span_tree,
          check_profiler_clock, check_host_syncs]


@pytest.mark.parametrize('mode', sorted(STAGES))
@pytest.mark.parametrize('check', CHECKS, ids=lambda f: f.__name__[len('check_'):])
def test_trace(runs, check, mode):
    check(runs[(mode, False)], runs[(mode, True)], mode)


def test_counts_and_launches():
    """A device count is summed at the snapshot, counters are keyed by the
    innermost open span, and each kernel wrapper's launches while
    recording are reported; one recording at a time."""
    wrappers = trace.kernel_wrappers()
    assert {'furthest_point_sample_kernel', 'fused_point_mlp_max_kernel',
            'fused_point_mlp_max_bwd_kernel', 'dw3x3_s2_kernel',
            'conv3x3_s2_fwd_kernel'} <= {f.__name__ for f in wrappers}
    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
        trace.count('rows', torch.tensor([1, 2, 3], dtype=torch.int32))
        with trace.span('outer'):
            trace.count('rows', torch.tensor([4], dtype=torch.int32))
            trace.count('n', 2)
            with trace.span('inner'):
                trace.count('n')
        wrappers[0].launches += 2
    wrappers[0].launches -= 2
    snap = rec.snapshot()
    counts = snap['counts']
    assert counts[(None, 'rows')] == 6 and counts[('outer', 'rows')] == 4
    assert counts[('outer', 'n')] == 2 and counts[('inner', 'n')] == 1
    assert counts[(None, 'launches.' + wrappers[0].__name__)] == 2
    assert [(s.name, s.parent, s.request) for s in snap['spans']] == [
        ('inner', 'outer', 0), ('outer', None, 0)]
