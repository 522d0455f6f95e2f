"""``run.py`` and the modules a run loads: no CPU fallback, nothing of JAX
or of the JAX package, and a reference that imports nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / 'bench_port'
FOREIGN = {'jax', 'jaxlib', 'flax', 'epnet_tpu'}


def _py(code):
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)


def test_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, 'bench_port/run.py', '--workload', 'lifusion_eval_b8',
                        '--seed', str(2 ** 31 + 5), '--seconds', '1', '--trace', '0'], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ''
    assert 'CUDA device' in p.stderr and 'does not run on the CPU' in p.stderr


def test_a_run_loads_nothing_of_jax():
    """A whole eval run and a train run at test widths, then the loaded
    modules' top-level names, compared whole."""
    code = '''
import sys, time, torch
from bench_port import calibrate, harness
from bench_port.tests import tiny
for cell, cfg, mix in (('lifusion_eval_b8', 'epnet_lifusion_f32', 'eval_b8'),
                       ('lifusion_train_b4', 'epnet_lifusion_f32', 'train_b4')):
    t = tiny.traffic(mix, batch=2, distinct_batches=2 if mix == 'eval_b8' else 4,
                     **({'sample_from': 2, 'check_requests': 1} if mix == 'eval_b8' else {}))
    harness.run_cell(cell, tiny.config_file(cfg), t, 1, 0.2, False, torch.device('cpu'),
                     time.perf_counter(), {}, harness.cell_limits(cell))
print(sorted({m.split('.')[0] for m in sys.modules}))
'''
    p = _py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert 'epnet_tpu_torch' in loaded and not loaded & FOREIGN


def test_reference_imports_nothing_of_the_program():
    p = _py('import sys; import bench_port.judge, bench_port.control, bench_port.scenes, '
            'bench_port.weights; print(sorted({m.split(".")[0] for m in sys.modules}))')
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & (FOREIGN | {'epnet_tpu_torch'})
    for f in sorted((HERE / 'reference').glob('*.py')) + [HERE / 'judge.py',
                                                          HERE / 'control.py']:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or '']
                assert not {n.split('.')[0] for n in names} & (FOREIGN | {'epnet_tpu_torch'}), f
