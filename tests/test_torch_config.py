"""The port's config and test scenes against the JAX package's, and the
port's import rule: ``epnet_tpu_torch`` (and ``chip_smoke.py``) never
import jax or ``epnet_tpu``."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from epnet_tpu import config as jcfg
from epnet_tpu.utils import testing as jtesting
from epnet_tpu_torch import config as tcfg
from epnet_tpu_torch.utils import testing as ttesting

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_default_config_equal():
    assert tcfg.Config().asdict() == jcfg.Config().asdict()


def test_tiny_config_equal():
    assert ttesting.tiny_config().asdict() == jtesting.tiny_config().asdict()
    over = dict(EXACT_QUERIES=True)
    assert (ttesting.tiny_config(**over).asdict()
            == jtesting.tiny_config(**over).asdict())


def test_parity_config_matches_yaml():
    want = jcfg.load_config(str(ROOT / 'cfgs' / 'LI_Fusion_with_attention_use_ce_loss.yaml'))
    assert tcfg.parity_config().asdict() == want.asdict()
    assert tcfg.load_config(str(tcfg.PARITY_YAML)).asdict() == want.asdict()
    cfg = tcfg.parity_config()
    assert cfg.EXACT_QUERIES is True and cfg.MIXED_PRECISION is False


@pytest.mark.parametrize('seed,n,hw', [(0, 512, (384, 1280)), (3, 1000, (32, 64))])
def test_structured_scene_identical(seed, n, hw):
    a = jtesting.structured_scene(np.random.RandomState(seed), n, img_hw=hw)
    b = ttesting.structured_scene(np.random.RandomState(seed), n, img_hw=hw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _port_modules():
    pkg = ROOT / 'epnet_tpu_torch'
    for path in sorted(pkg.rglob('*.py')):
        rel = path.relative_to(ROOT).with_suffix('')
        yield '.'.join(rel.parts[:-1] if rel.name == '__init__' else rel.parts)


def test_port_imports_no_jax():
    code = ('import sys, importlib\n'
            f'for m in {list(_port_modules())!r}: importlib.import_module(m)\n'
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'epnet_tpu'))\n"
            'assert not bad, bad\n'
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('ok')


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
    return roots


@pytest.mark.parametrize('path', [ROOT / 'chip_smoke.py',
                                  *sorted((ROOT / 'epnet_tpu_torch').rglob('*.py'))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert not _imported_roots(path) & {'jax', 'jaxlib', 'flax', 'epnet_tpu'}
