"""The AP-pin campaign over the port's pin: a seed ladder of paired cells.

    python -m epnet_tpu_torch.tools.ap_pin_campaign [--seeds 0 1 2 3] [--epochs 40]
        [--val 72] [--cells parity block,queries] [--skip parity:0 ...]
        [--workdir output/ap_pin_campaign]

Counterpart of ``tools/ap_pin_campaign.py``: for each seed, the port's pin
(``python -m epnet_tpu_torch.tools.synthetic_ap_pin``, one process a run)
for each cell, every run's record appended to ``<workdir>/campaign.jsonl``
(seed, cell, epochs, wall seconds, exit status, and the easy / moderate /
hard Car 3D AP R40 or the output's tail), then the paired table: each
seed's parity triple beside each other cell's, with the cell's moderate AP
less parity's. A seed shares its tree, initialization and data order
across cells, so the paired delta removes the spread between seeds.

A cell is ``parity`` (the recipe), ``speed`` (the pin's ``--speed-mode``)
or a comma set of the pin's ``--knobs`` (``block,queries``, ``queries``,
``residual``, ``fps``, ``fpwin``, ...), each of which runs in bf16 as the
pin's knobs do. ``--cells`` defaults to JAX's ladder, ``parity`` and
``block,queries``. ``--skip`` takes ``cell:seed`` tags already done.
Each cell's pin works under ``<workdir>/<cell>`` (a comma becomes ``_``);
a relative ``--workdir`` is taken from the current directory.

No reproduction gate: JAX's campaign first holds parity seed 0 to the
triple [5.0, 13.0132, 13.0132], a JAX figure that needs its eval and train
graphs pinned to an older form (``EPNET_FUSED_HEAD_EVAL`` and
``EPNET_GS_SLOT_BWD`` off). The port has one graph and reads neither
switch (ROADMAP: not ported, on purpose), so that triple has nothing to
hold it to.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULT = re.compile(r'\{"metric": "synthetic Car 3D AP[^\n]*\}')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="paired AP-pin ladder over the port's pin")
    p.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2, 3])
    p.add_argument('--epochs', type=int, default=40)
    p.add_argument('--val', type=int, default=72)
    p.add_argument('--cells', type=str, nargs='+', default=['parity', 'block,queries'],
                   help="'parity', 'speed' or a comma set of the pin's knobs")
    p.add_argument('--skip', type=str, nargs='*', default=[],
                   help='"cell:seed" runs to skip (already done)')
    p.add_argument('--workdir', type=str, default='output/ap_pin_campaign')
    return p.parse_args(argv)


def pin_command(cell: str, seed: int, args: argparse.Namespace) -> List[str]:
    """The pin's command line for ``cell`` at ``seed``."""
    cmd = [sys.executable, '-m', 'epnet_tpu_torch.tools.synthetic_ap_pin', '--seed', str(seed),
           '--epochs', str(args.epochs), '--val', str(args.val),
           '--workdir', os.path.join(os.path.abspath(args.workdir), cell.replace(',', '_'))]
    if cell == 'speed':
        return cmd + ['--speed-mode']
    return cmd if cell == 'parity' else cmd + ['--knobs', cell]


def log_path(args: argparse.Namespace) -> str:
    return os.path.join(args.workdir, 'campaign.jsonl')


def run_pin(cell: str, seed: int, args: argparse.Namespace) -> dict:
    """One pin run; its record is appended to the log and returned."""
    t0 = time.time()
    res = subprocess.run(pin_command(cell, seed, args), cwd=REPO, capture_output=True,
                         text=True)
    out = res.stdout + res.stderr
    rec = {'seed': seed, 'cell': cell, 'epochs': args.epochs,
           'wall_s': round(time.time() - t0, 1), 'ok': res.returncode == 0}
    found = RESULT.findall(out)
    if found:
        rec['ap'] = json.loads(found[-1])['value']
    else:
        rec['tail'] = out[-2000:]
    with open(log_path(args), 'a') as f:
        f.write(json.dumps(rec) + '\n')
    print(json.dumps({k: v for k, v in rec.items() if k != 'tail'}), flush=True)
    return rec


def paired_table(args: argparse.Namespace) -> List[str]:
    """The table's lines from the log's records at ``args.epochs``: a row a
    seed and cell with both its and parity's triples."""
    table = {}
    if os.path.exists(log_path(args)):
        with open(log_path(args)) as f:
            for line in f:
                r = json.loads(line)
                if 'ap' in r and r['epochs'] == args.epochs:
                    table[(r['cell'], r['seed'])] = r['ap']
    lines = ['seed | cell | parity (e/m/h) | cell (e/m/h) | d(moderate)']
    for cell in args.cells:
        if cell == 'parity':
            continue
        for seed in args.seeds:
            p, c = table.get(('parity', seed)), table.get((cell, seed))
            if p and c:
                lines.append(f'{seed} | {cell} | {p} | {c} | {c[1] - p[1]:+.1f}')
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    done = set(args.skip)
    for seed in args.seeds:
        for cell in args.cells:
            if f'{cell}:{seed}' not in done:
                run_pin(cell, seed, args)
    lines = paired_table(args)
    print('\n' + '\n'.join(lines), flush=True)
    return lines


if __name__ == '__main__':
    main()
