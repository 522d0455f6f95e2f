"""One run of one benchmark cell: set-up, the measured window, the traced
passes, the comparison, the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration file (``configs/<config>.json``, the
model tree as it is run under ``model``), its traffic mix
(``traffic/<mix>.json``, read by its entry), each metric's reader
(``metrics/<metric>.py``), the kernels a roofline sums
(``kernels/<op>/*.json``) and the limits of its comparison
(``limits/<cell>.json``). Adding any of them adds a file.

The entry that a mix names (``entries/<entry>.py``, found by name too)
holds the system under test and the loop that drives it: ``eval`` drives
``epnet_tpu_torch.eval.detect.joint_eval_step`` in a closed loop of one
caller, ``train`` drives ``epnet_tpu_torch.train.trainer.train_step``. An
entry builds the program with the benchmark's weights and scenes, warms up
every shape its traffic uses, runs the window, and hands what the window
produced to ``judge.py``. It lists the traffic keys it reads (``KEYS``),
and a mix that sets another is refused.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'epnet_tpu')
MIX_KEYS = {'entry', 'why'}  # read by the harness itself


def read_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, benchmark: dict = None):
    """(benchmark, workload entry, configuration file, traffic mix) of the
    cell ``name``."""
    bm = benchmark or read_json(ROOT / 'BENCHMARK.json')
    found = [w for w in bm['workloads'] if w['name'] == name]
    if not found:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json: '
                         f'{[w["name"] for w in bm["workloads"]]}')
    w = found[0]
    conf = [c for c in bm['configs'] if c['name'] == w['config']][0]
    traffic = read_json(HERE / 'traffic' / f'{w["traffic"]}.json')
    unread = set(traffic) - MIX_KEYS - entry_module(traffic['entry']).KEYS
    if unread:
        raise SystemExit(f'traffic mix {w["traffic"]!r} sets keys that its entry '
                         f'{traffic["entry"]!r} does not read: {sorted(unread)}')
    return bm, w, read_json(ROOT / conf['file']), traffic


def cell_limits(workload: str) -> dict:
    """The limit of each number the comparison reads for ``workload``
    (``limits/<cell>.json``)."""
    return read_json(HERE / 'limits' / f'{workload}.json')['limits']


def cell_metrics(bm: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload`` reports."""
    return [m for m in bm[kind] if workload in m.get('workloads', [workload])]


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder."""
    spec = importlib.util.spec_from_file_location(
        f'bench_port_{kind}_' + name.replace('.', '_').replace('-', '_'),
        HERE / kind / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    return load_file('metrics', name)


def entry_module(name: str):
    """The entry module ``name`` of a traffic mix (``entries/<name>.py``):
    ``Entry``, the system under test and its loop, and ``KEYS``, the
    mix's keys that it reads."""
    return load_file('entries', name)


def kernel_patterns(op: str) -> list:
    """The kernel-name fragments of ``op``, from every ``kernels/<op>/*.json``."""
    return [p for f in sorted((HERE / 'kernels' / op).glob('*.json'))
            for p in read_json(f)['patterns']]


def kernel_seconds(obs: dict, op: str) -> float:
    """Device seconds a step of the profiled pass spent in ``op``'s kernels."""
    pats = kernel_patterns(op)
    prof = obs['profile']
    total = sum(s for k, s in prof['kernel_s'].items() if any(p in k for p in pats))
    return total / prof['steps']


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``epnet_tpu_torch`` is not ``epnet_tpu``)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def sample_ids(seed: int, traffic: dict) -> list:
    """The requests of the window whose outputs the comparison checks,
    drawn from the seed among the first ``sample_from``."""
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in rng.choice(traffic['sample_from'], traffic['check_requests'],
                                             replace=False))


def closed_loop(one, seconds: float, batch: int, device) -> dict:
    """``one(i)`` for request i = 0, 1, ..., each sent when the one before
    has ended, until ``seconds`` have passed: the window's length, its
    requests and scans, and each request's latency."""
    lat = []
    sync(device)
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        one(len(lat))
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    return {'seconds': t1 - t_start, 'requests': len(lat), 'scans': len(lat) * batch,
            'latency_s': lat}


def generator_seed(seed: int) -> int:
    """The seed of the generator that draws a train step's dropout masks
    and RoI sampling."""
    return int(np.random.SeedSequence(seed).generate_state(4)[3])




def run_cell(workload: str, cfg_file: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, t0: float, readers: dict, limits: dict,
             trace_path: str = None) -> dict:
    """One run; returns the result line's object (``correct`` from the
    comparison against ``limits``)."""
    tree = cfg_file['model']
    prog = entry_module(traffic['entry']).Entry(cfg_file, traffic, seed, device)
    sync(device)
    obs = {'workload': workload, 'entry': traffic['entry'], 'config': tree,
           'dtype': cfg_file['dtype'], 'batch': traffic['batch'],
           'setup_s': time.perf_counter() - t0}
    obs['window'] = prog.window(seconds)
    if trace:
        obs['stages_ms'] = prog.stage_ms()
        obs['profile'] = prog.profile(trace_path)
    foreign = foreign_modules()
    if foreign:
        raise SystemExit(f'modules of JAX or the JAX package are loaded: {foreign}')
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == 'cuda' else 0
    prog.free()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    checks = prog.judge()
    metrics = {}
    for name, (unit, reader) in readers.items():
        v = reader.read(obs)
        if v is not None:
            metrics[name] = {'value': v, 'unit': unit}
    device_info = {'platform': 'gpu' if torch.device(device).type == 'cuda' else 'cpu',
                   'kind': (torch.cuda.get_device_name(device)
                            if torch.device(device).type == 'cuda' else 'cpu'),
                   'count': 1, 'memory_peak_bytes': peak}
    # every number read has its limit, and every limit its number
    out = {'correct': set(checks) == set(limits) and all(v <= limits[k] for k, v in checks.items()),
           'attempted': obs['window']['scans'], 'failed': 0, 'metrics': metrics,
           'device': device_info}
    if trace:
        prof = obs['profile']
        device_info.update(busy_s=prof['busy_s'], window_s=prof['window_s'])
        out['breakdown'] = {'device_ops': prof['device_ops'], 'idle_gaps': prof['idle_gaps']}
    out['checks'] = {k: {'value': v, 'limit': limits.get(k)} for k, v in checks.items()}
    return out


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description='One run of one cell of BENCHMARK.json.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bm, w, cfg_file, traffic = cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w['chips']:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'{args.workload} needs {w["chips"]} CUDA device(s) and finds {have}: '
              f'the benchmark measures the card and does not run on the CPU', file=sys.stderr)
        return 2
    kind = 'per_layer' if args.trace else 'end_to_end'
    readers = {m['name']: (m['unit'], metric_reader(m['name']))
               for m in cell_metrics(bm, args.workload, kind)}
    limits = cell_limits(args.workload)
    trace_path = None
    if args.trace:
        tdir = Path(tempfile.gettempdir()) / 'bench_port'
        tdir.mkdir(parents=True, exist_ok=True)
        trace_path = str(tdir / f'{args.workload}-trace.json.gz')
    out = run_cell(args.workload, cfg_file, traffic, args.seed, args.seconds, bool(args.trace),
                   torch.device('cuda:0'), t0, readers, limits, trace_path)
    if trace_path:
        print(f'trace: {trace_path}', file=sys.stderr)
    for k, c in out['checks'].items():
        print(f'check {k}: {c["value"]!r} (limit {c["limit"]!r})', file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
