"""``BENCHMARK.json`` against the benchmark's contract, and every file of
``configs/``, ``traffic/``, ``entries/``, ``metrics/``, ``kernels/`` and
``limits/`` found by its name and validated."""

import json
import re
import shutil
from pathlib import Path

import pytest

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / 'bench_port'
BM = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
CHECKS = {'eval': {'rpn_gap', 'roi_gap', 'rcnn_gap', 'det_gap'},
          'train': {'first_loss_gap', 'grad_gap', 'delta_median_gap', 'roi_gap'}}
# what `reduced` may never name: a width (contract of BENCHMARK.json)
WIDTHS = re.compile(r'(_DIM|_RANK|_FC|MLPS|CHANNELS?|FEATURES|_LAYER|Reduce|Kernels|Strides)$',
                    re.IGNORECASE)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_top_level():
    assert set(BM) == {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end',
                       'per_layer'}
    assert BM['command'] == ['python3', 'bench_port/run.py'] and BM['paths'] == ['bench_port']
    assert isinstance(BM['run_seconds'], int) and 1 <= BM['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    # a full check of 24 cells, every run its length and a minute more,
    # fits in 43200 s
    assert (2 + 14 * 24) * (BM['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_and_cells():
    names = [c['name'] for c in BM['configs']]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in BM['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source']) and _line(c['why'])
        assert c['file'].startswith('bench_port/') and (ROOT / c['file']).is_file()
        assert len(c['reduced']) <= 16 and all(NAME.match(k) for k in c['reduced'])
        assert c['reduced'] == json.loads((ROOT / c['file']).read_text())['reduced']
        assert any(w['config'] == c['name'] for w in BM['workloads'])
    cells = [w['name'] for w in BM['workloads']]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    assert len({(w['config'], w['traffic']) for w in BM['workloads']}) == len(cells)
    for w in BM['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic']) and _line(w['why'])
        assert w['config'] in names and w['chips'] == 1


def test_metrics():
    e2e = {m['name']: m for m in BM['end_to_end']}
    per = {m['name']: m for m in BM['per_layer']}
    assert not set(e2e) & set(per) and 'setup_s' in e2e
    assert e2e['setup_s']['bound'] == 0.25 and 'workloads' not in e2e['setup_s']
    cells = {w['name'] for w in BM['workloads']}
    for m in BM['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    for m in BM['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert m['source'] in SOURCES and _line(m['layer'])
        # what it moves is an end-to-end metric that every cell reporting it reports
        assert m['moves'] in e2e
        for w in m['workloads']:
            assert w in cells
            assert m['moves'] in {x['name'] for x in harness.cell_metrics(BM, w, 'end_to_end')}
    for m in BM['end_to_end'] + BM['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower',
                                                                                   'higher')
        assert set(m.get('workloads', cells)) <= cells
    for w in cells:
        reported = harness.cell_metrics(BM, w, 'end_to_end')
        assert 'setup_s' in {m['name'] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(BM, w, 'per_layer')
    layers = {}
    for m in BM['per_layer']:  # one layer, one name, letter for letter
        layers.setdefault(m['layer'].split(' ')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize('m', BM['end_to_end'] + BM['per_layer'], ids=lambda m: m['name'])
def test_metric_reader_found_by_name(m):
    reader = harness.metric_reader(m['name'])
    assert (reader.UNIT, reader.SOURCE, reader.BETTER) == (m['unit'], m['source'], m['better'])
    if 'layer' in m:
        assert (reader.LAYER, reader.MOVES) == (m['layer'], m['moves'])
    assert callable(reader.read)


def test_every_file_is_found_and_valid():
    from epnet_tpu_torch.config import Config

    for f in sorted((HERE / 'configs').glob('*.json')):
        c = json.loads(f.read_text())
        assert c['name'] == f.stem and c['dtype'] in ('float32', 'bfloat16')
        assert len(c['image_hw']) == 2
        Config().merged(c['model'])  # the program takes the tree as it stands
    for f in sorted((HERE / 'traffic').glob('*.json')):
        t = json.loads(f.read_text())
        entry = harness.entry_module(t['entry'])
        assert set(t) <= harness.MIX_KEYS | entry.KEYS and callable(entry.Entry)
        assert t['batch'] >= 1 and t['distinct_batches'] >= 1 and _line(t['why'])
    names = {m['name'] for m in BM['end_to_end'] + BM['per_layer']}
    assert {f.name[:-3] for f in (HERE / 'metrics').glob('*.py')} == names
    for d in sorted((HERE / 'kernels').iterdir()):
        assert harness.kernel_patterns(d.name)
    for w in BM['workloads']:
        _, _, _, traffic = harness.cell(w['name'], BM)
        limits = harness.cell_limits(w['name'])
        assert set(limits) == CHECKS[traffic['entry']]
        assert all(v > 0 for v in limits.values())


@pytest.mark.parametrize('name', [f.stem for f in sorted((HERE / 'configs').glob('*.json'))])
def test_config_equals_its_source_but_reduced(name):
    """Key by key, the model tree a configuration runs equals the repo's copy
    of its source (``yaml``, loaded by the port's ``load_config``) except
    under the top-level keys of ``reduced``; no width changes even there."""
    from epnet_tpu_torch.config import Config, load_config

    c = json.loads((HERE / 'configs' / f'{name}.json').read_text())
    src = json.loads(json.dumps(load_config(str(ROOT / c['yaml'])).asdict()))
    run = json.loads(json.dumps(Config().merged(c['model']).asdict()))
    assert run == c['model']
    changed = {k for k in set(src) | set(run) if src.get(k) != run.get(k)}
    assert changed == set(c['reduced']) and set(c['reduced']) <= set(c['assumed'])

    def leaves(d, pre=''):
        for k, v in d.items():
            yield from leaves(v, f'{pre}{k}.') if isinstance(v, dict) else [(pre + k, v)]

    for key in c['reduced']:
        s, r = dict(leaves({key: src[key]})), dict(leaves({key: run[key]}))
        assert not [k for k in set(s) | set(r) if s.get(k) != r.get(k) and WIDTHS.search(k)]


def test_a_mix_setting_a_key_its_entry_does_not_read_is_refused(tmp_path, monkeypatch):
    here = tmp_path / 'bench_port'
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns('__pycache__'))
    monkeypatch.setattr(harness, 'HERE', here)
    mix = json.loads((here / 'traffic' / 'eval_b8.json').read_text())
    (here / 'traffic' / 'four_clients.json').write_text(json.dumps(dict(mix, clients=4)))
    bm = dict(BM, workloads=[{'name': 'four', 'config': 'epnet_lifusion_f32',
                              'traffic': 'four_clients', 'chips': 1, 'why': 'x'}])
    with pytest.raises(SystemExit, match='clients'):
        harness.cell('four', bm)


def test_a_new_file_is_found_without_an_edit(tmp_path, monkeypatch):
    """A configuration, a traffic mix with an entry (its loop) of its own, a
    metric, a kernel name and a cell's limits, each added as a file beside
    the others (in a copy of the folder), are found by name."""
    root = tmp_path / 'repo'
    shutil.copytree(HERE, root / 'bench_port', ignore=shutil.ignore_patterns('__pycache__'))
    here = root / 'bench_port'
    monkeypatch.setattr(harness, 'HERE', here)
    monkeypatch.setattr(harness, 'ROOT', root)
    cfg = json.loads((here / 'configs' / 'epnet_lifusion_f32.json').read_text())
    cfg['name'] = 'throwaway_cfg'
    (here / 'configs' / 'throwaway_cfg.json').write_text(json.dumps(cfg))
    (here / 'entries' / 'throwaway_loop.py').write_text(
        "KEYS = {'batch', 'distinct_batches', 'callers'}\n\n\nclass Entry:\n    pass\n")
    (here / 'traffic' / 'throwaway_mix.json').write_text(json.dumps(
        {'entry': 'throwaway_loop', 'batch': 2, 'distinct_batches': 2, 'callers': 4,
         'why': 'x'}))
    (here / 'metrics' / 'throwaway.metric.py').write_text(
        "UNIT, SOURCE, BETTER = 'ms', 'host_clock', 'lower'\n"
        "LAYER, MOVES = 'device', 'eval_scans_per_s'\n\n\ndef read(obs):\n    return 1.0\n")
    (here / 'kernels' / 'fps' / 'throwaway.json').write_text('{"patterns": ["fps_v2_kernel"]}')
    (here / 'limits' / 'throwaway_cell.json').write_text('{"limits": {"rpn_gap": 0.5}}')
    bm = dict(BM, configs=BM['configs'] + [dict(BM['configs'][0], name='throwaway_cfg',
                                                 file='bench_port/configs/throwaway_cfg.json')],
              workloads=BM['workloads'] + [{'name': 'throwaway_cell', 'config': 'throwaway_cfg',
                                            'traffic': 'throwaway_mix', 'chips': 1, 'why': 'x'}])
    _, w, c, t = harness.cell('throwaway_cell', bm)
    assert c['name'] == 'throwaway_cfg' and t['batch'] == 2 and t['callers'] == 4
    assert harness.entry_module(t['entry']).Entry.__name__ == 'Entry'
    assert harness.metric_reader('throwaway.metric').read({}) == 1.0
    assert 'fps_v2_kernel' in harness.kernel_patterns('fps')
    assert harness.cell_limits('throwaway_cell') == {'rpn_gap': 0.5}
