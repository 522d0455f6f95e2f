"""The program's own spans and counters (``epnet_tpu_torch/utils/trace.py``)
in one more pass of a traced run, reduced to what the per-layer metrics
``idle_ms.*``, ``host_syncs.*`` and ``sa_distinct_rows_pct.*`` read.

``observed(obs)`` is the pass's result, measured at the first reader that
asks and kept as ``obs['program']``; None where the program has no tracer
(a checkout from before it), so that those metrics are left out of the
line. The harness hands its readers ``obs`` alone, after it has freed the
run's entry; so the pass takes the entry from ``harness.run_cell``'s frame,
builds a fresh one from its configuration file, traffic, seed and device
(set-up and warm-up again, after the window and the comparison), and runs
``profile_steps`` of the cell's calls under ``torch.profiler`` with the
tracer recording. Every existing pass and metric reads what it read
before.

``reduce`` charges the device's idle time to the program's spans: for
each span name, wall, device-busy and device-idle ms a request (or step)
inside its ``epnet::`` range, on the profiler's clock, children included;
the pass's own window, busy and idle time, and the idle time outside the
stages (the spans inside the outermost one), all per request.
"""

from __future__ import annotations

import bisect
import sys

import torch

from bench_port import harness, spans

PASS = 'bench_port::program_pass'  # the pass's window, a range on the profiler's clock
TOP = {'eval': 'request', 'train': 'step'}  # the outermost span of each entry's call


def observed(obs: dict):
    """The program pass of this run (``measure``), made once and kept in
    ``obs['program']``; None without the program's tracer."""
    if 'program' not in obs:
        obs['program'] = measure(_run_entry(), obs['entry'])
    return obs['program']


def _run_entry():
    """The entry of the ``harness.run_cell`` under way (its local ``prog``)."""
    f = sys._getframe()
    while f is not None and f.f_code is not harness.run_cell.__code__:
        f = f.f_back
    if f is None:
        raise RuntimeError('program_spans.observed reads inside harness.run_cell')
    return f.f_locals['prog']


def measure(entry, kind: str):
    """A fresh entry like ``entry`` (an ``entries/<kind>.py`` ``Entry``), its
    call ``profile_steps`` times under ``torch.profiler`` with the program's
    tracer recording: ``reduce``'s result and the counters a request."""
    try:
        from epnet_tpu_torch.utils import trace
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    device = torch.device(entry.device)
    prog = type(entry)(entry.cfg_file, entry.traffic, entry.seed, device)
    call = prog.request if kind == 'eval' else prog.step
    steps = entry.traffic['profile_steps']
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    harness.sync(device)
    with profile(activities=activities) as prof:
        with trace.recording() as rec:
            with record_function(PASS):
                for _ in range(steps):
                    call(prog.next_batch())
                harness.sync(device)
    prog.free()
    del prog
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    snap = rec.snapshot()
    # the profiler's own records: ``prof.events()`` builds the same
    # intervals some 30 times slower (20-33 s a pass of a b8 or train cell)
    out = reduce(*split(prof.profiler.kineto_results.events(), trace.PREFIX), TOP[kind])
    n = sum(1 for s in snap['spans'] if s.parent is None)
    if n != out['requests']:
        raise RuntimeError(f'{n} outermost spans recorded, {out["requests"]} in the profile')
    out['counts'] = {key: v / n for key, v in snap['counts'].items()}
    return out


def split(events, prefix: str):
    """The profiler's ``events`` (its kineto records: ``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``) as ``reduce``
    takes them, in µs: the spans' (name, start, end) from their host ranges
    (``prefix`` + name), the device's (start, end) intervals and the pass's
    window. The profiler also projects each host range onto the device's
    timeline, from its first kernel to its last (a device event of the same
    name): those are no device work and are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, device, window = [], [], None
    for e in events:
        name = e.name()
        ours = name == PASS or name.startswith(prefix)
        span = (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
        if e.device_type() == cuda:
            if not ours:
                device.append(span)
        elif name == PASS:
            window = span
        elif ours:
            ranges.append((name[len(prefix):], *span))
    return ranges, device, window


def _busy_in(merged: list, starts: list, s: float, e: float) -> float:
    """Time of the merged intervals inside (s, e)."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < e:
        total += max(0.0, min(merged[i][1], e) - max(merged[i][0], s))
        i += 1
    return total


def reduce(ranges: list, device: list, window: tuple, top: str) -> dict:
    """Per request of the pass, in ms, from the profiler's µs: ``ranges``,
    the spans' (name, start, end); ``device``, the device's (start, end)
    intervals, overlapping ones counted once; ``window``, the pass's (start,
    end); ``top``, the outermost span's name. ``spans``: {name: {wall_ms,
    busy_ms, idle_ms}}, each summed over the span's ranges, children
    included; ``window_ms``, ``busy_ms``, ``idle_ms`` and ``idle_pct`` of
    the window; ``idle_outside_ms``, the window's idle time outside every
    span inside ``top`` (the rest of ``top`` and the time between
    requests)."""
    merged = spans._merged((max(s, window[0]), min(e, window[1])) for s, e in device
                           if e > window[0] and s < window[1])
    starts = [s for s, _ in merged]
    n = sum(1 for name, _, _ in ranges if name == top)
    if n == 0:
        raise ValueError(f'no {top!r} span in the pass')
    per = 1e3 * n  # µs -> ms a request
    out = {}
    for name, s, e in ranges:
        b = _busy_in(merged, starts, s, e)
        d = out.setdefault(name, {'wall_ms': 0.0, 'busy_ms': 0.0, 'idle_ms': 0.0})
        d['wall_ms'] += (e - s) / per
        d['busy_ms'] += b / per
        d['idle_ms'] += (e - s - b) / per
    wall = window[1] - window[0]
    busy = sum(e - s for s, e in merged)
    stages = spans._merged((s, e) for name, s, e in ranges if name != top)
    in_stages = sum(e - s for s, e in stages)
    busy_in_stages = sum(_busy_in(merged, starts, s, e) for s, e in stages)
    return {'requests': n, 'spans': out, 'window_ms': wall / per, 'busy_ms': busy / per,
            'idle_ms': (wall - busy) / per, 'idle_pct': 100.0 * (wall - busy) / wall,
            'idle_outside_ms': ((wall - in_stages) - (busy - busy_in_stages)) / per}


def span_idle_ms(obs: dict, kind: str, name: str):
    """Device-idle ms a request inside span ``name`` of a ``kind`` entry's
    pass, or None (another entry, no tracer, no such span)."""
    if obs['entry'] != kind:
        return None
    p = observed(obs)
    return None if p is None or name not in p['spans'] else p['spans'][name]['idle_ms']


def counted(obs: dict, kind: str, name: str, span: str = None):
    """Counter ``name`` a request of a ``kind`` entry's pass, in ``span``
    (every span when None), or None (another entry, no tracer)."""
    if obs['entry'] != kind:
        return None
    p = observed(obs)
    if p is None:
        return None
    return sum(v for (s, k), v in p['counts'].items()
               if k == name and (span is None or s == span))


def distinct_rows_pct(obs: dict, kind: str, direction: str):
    """100 x the fused SA kernels' distinct rows over the rows their balls
    gather, ``direction`` 'fwd' (B, G) or 'bwd' (C, H), in a ``kind``
    entry's pass; None without a launch, another entry or no tracer."""
    gathered = counted(obs, kind, 'sa_rows_gathered.' + direction)
    if not gathered:
        return None
    return 100.0 * counted(obs, kind, 'sa_rows_distinct.' + direction) / gathered
