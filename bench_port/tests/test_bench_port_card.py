"""A short run of every cell on the card (``python -m pytest bench_port/tests
-m cuda`` on a machine with one): each comes out correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w['name'] for w in json.loads((ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the benchmark runs only on the card')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run([sys.executable, 'bench_port/run.py', '--workload', cell, '--seed',
                        str(2 ** 31 + 77), '--seconds', '3', '--trace', '0'], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])['correct'] is True
