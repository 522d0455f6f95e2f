"""``program_spans``: the reduction of the program's spans against the
device intervals on synthetic intervals, and the whole traced path of its
readers rehearsed on the CPU at test widths (``tiny.py``), through
``harness.run_cell`` as a run calls them."""

import time
import types

import pytest
import torch

from bench_port import harness, program_spans
from bench_port.tests import tiny

NEW = {'eval': ['idle_ms.rpn.eval', 'idle_ms.proposal.eval', 'idle_ms.detect.eval',
                'host_syncs.proposal.eval', 'host_syncs.detect.eval',
                'sa_distinct_rows_pct.eval'],
       'train': ['idle_ms.proposal.train', 'idle_ms.target.train', 'idle_ms.backward.train',
                 'host_syncs.train', 'sa_distinct_rows_pct.train']}


def test_reduce_nested_and_sibling_spans():
    """Two requests in a window of 0-100 µs. Request 0 (0-40) holds rpn
    (0-20) and proposal (20-35); request 1 (50-90) holds rpn (50-70). The
    device runs 5-15 and 10-18 (overlapping: 5-18 once), 30-60 and 95-120
    (clipped to the window at 100)."""
    ranges = [('request', 0, 40), ('rpn', 0, 20), ('proposal', 20, 35),
              ('request', 50, 90), ('rpn', 50, 70)]
    device = [(10, 18), (5, 15), (30, 60), (95, 120)]
    r = program_spans.reduce(ranges, device, (0, 100), 'request')
    assert r['requests'] == 2
    ms = 1e-3 / 2
    # rpn: 0-20 busy 5-18 (13), 50-70 busy 50-60 (10)
    assert r['spans']['rpn'] == pytest.approx(
        {'wall_ms': 40 * ms, 'busy_ms': 23 * ms, 'idle_ms': 17 * ms})
    # proposal 20-35: busy 30-35
    assert r['spans']['proposal'] == pytest.approx(
        {'wall_ms': 15 * ms, 'busy_ms': 5 * ms, 'idle_ms': 10 * ms})
    # the requests, children included: 0-40 busy 13 + 10, 50-90 busy 10
    assert r['spans']['request'] == pytest.approx(
        {'wall_ms': 80 * ms, 'busy_ms': 33 * ms, 'idle_ms': 47 * ms})
    # the window: busy 13 + 30 + 5
    assert r['window_ms'] == pytest.approx(100 * ms) and r['busy_ms'] == pytest.approx(48 * ms)
    assert r['idle_ms'] == pytest.approx(52 * ms) and r['idle_pct'] == pytest.approx(52.0)
    # outside the stages: 35-50 (busy 35-50), 70-100 (busy 95-100)
    assert r['idle_outside_ms'] == pytest.approx(25 * ms)
    stages = sum(v['idle_ms'] for k, v in r['spans'].items() if k != 'request')
    assert stages + r['idle_outside_ms'] == pytest.approx(r['idle_ms'])


def test_split_leaves_out_the_spans_projected_on_the_device():
    """The profiler gives each host range a device event of the same name
    from its first kernel to its last: not device work."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, kind, s, e):  # as the profiler's kineto records, in ns
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: kind,
                                     start_ns=lambda: 1000 * s,
                                     duration_ns=lambda: 1000 * (e - s))
    events = [ev(program_spans.PASS, cpu, 0, 100), ev('epnet::request', cpu, 0, 40),
              ev('epnet::rpn', cpu, 1, 20), ev('aten::mm', cpu, 2, 3),
              ev('epnet::rpn', cuda, 5, 18), ev(program_spans.PASS, cuda, 5, 60),
              ev('gemm', cuda, 5, 9), ev('gemm', cuda, 10, 18)]
    ranges, device, window = program_spans.split(events, 'epnet::')
    assert ranges == [('request', 0, 40), ('rpn', 1, 20)]
    assert device == [(5, 9), (10, 18)] and window == (0, 100)


def test_reduce_needs_the_outermost_span():
    with pytest.raises(ValueError):
        program_spans.reduce([('rpn', 0, 1)], [], (0, 1), 'request')


@pytest.mark.parametrize('kind', sorted(NEW))
def test_traced_readers_on_the_cpu(kind):
    """A run at test widths with the new readers: every metric has a value,
    the span idle times add up to the pass's idle time, and the counters
    are those of the tracer."""
    cell, mix = ('lifusion_eval_b8', 'eval_b8') if kind == 'eval' else \
        ('lifusion_train_b4', 'train_b4')
    over = {'sample_from': 2, 'check_requests': 1} if kind == 'eval' else {}
    t = tiny.traffic(mix, batch=2, distinct_batches=2 if kind == 'eval' else 4, **over)
    readers = {m: ('', harness.metric_reader(m)) for m in NEW[kind]}
    seen = {}
    readers['seen'] = ('', types.SimpleNamespace(read=lambda obs: seen.update(obs)))
    out = harness.run_cell(cell, tiny.config_file('epnet_lifusion_f32'), t, 2 ** 31 + 7, 0.2,
                           False, torch.device('cpu'), time.perf_counter(), readers,
                           harness.cell_limits(cell))
    got = {k: v['value'] for k, v in out['metrics'].items()}
    assert set(got) == set(NEW[kind]) - {'sa_distinct_rows_pct.' + kind}  # no kernel here
    assert all(v >= 0 for v in got.values())
    assert got.get('host_syncs.proposal.eval', 1) > 0 and got.get('host_syncs.train', 1) > 0
    p = seen['program']
    top = program_spans.TOP[kind]
    assert p['requests'] == t['profile_steps'] and p['busy_ms'] == 0  # no device here
    stages = sum(v['idle_ms'] for k, v in p['spans'].items() if k != top)
    assert stages + p['idle_outside_ms'] == pytest.approx(p['idle_ms'])
    assert p['counts'][(None, 'launches.fused_point_mlp_max_kernel')] == 0
