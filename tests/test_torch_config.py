"""The port's config, box geometry and test scenes against the JAX
package's, and the port's import rule: ``epnet_tpu_torch`` (and
``chip_smoke.py``) never import jax or ``epnet_tpu`` and read no file of
``epnet_tpu/``."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from epnet_tpu import config as jcfg
from epnet_tpu.data import box_np as jbox
from epnet_tpu.utils import testing as jtesting
from epnet_tpu_torch import config as tcfg
from epnet_tpu_torch.utils import box_np as tbox
from epnet_tpu_torch.utils import testing as ttesting

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECTIONS = ('', 'LI_FUSION', 'RPN', 'RPN.SA_CONFIG', 'RCNN', 'RCNN.SA_CONFIG', 'TRAIN', 'TEST')
PROPERTIES = {'': ('num_classes',), 'RPN': ('per_loc_bin_num', 'reg_channel'),
              'RCNN': ('per_loc_bin_num', 'loc_y_bin_num', 'reg_channel', 'input_channel')}


def _section(cfg, path):
    for part in filter(None, path.split('.')):
        cfg = getattr(cfg, part)
    return cfg


def _assert_same_tree(got, want, path=''):
    """Field by field: the same names in the same order, the same declared
    types, the same values (nested sections recursively) and the same
    derived properties."""
    assert type(got).__name__ == type(want).__name__, path
    gf, wf = dataclasses.fields(got), dataclasses.fields(want)
    assert [(f.name, str(f.type)) for f in gf] == [(f.name, str(f.type)) for f in wf], path
    for f in gf:
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            _assert_same_tree(a, b, f'{path}.{f.name}')
        else:
            assert type(a) is type(b) and a == b, (f'{path}.{f.name}', a, b)
    for name in PROPERTIES.get(path.lstrip('.'), ()):
        assert getattr(got, name) == getattr(want, name), (path, name)


def test_default_config_equal():
    assert tcfg.Config().asdict() == jcfg.Config().asdict()


@pytest.mark.parametrize('section', SECTIONS, ids=lambda s: s or 'Config')
def test_default_sections_field_by_field(section):
    path = f'.{section}' if section else ''
    _assert_same_tree(_section(tcfg.Config(), section), _section(jcfg.Config(), section), path)


@pytest.mark.parametrize('yaml_file', sorted((ROOT / 'cfgs').glob('*.yaml')),
                         ids=lambda p: p.name)
def test_every_yaml_loads_the_same(yaml_file):
    got, want = tcfg.load_config(str(yaml_file)), jcfg.load_config(str(yaml_file))
    _assert_same_tree(got, want)
    for section in SECTIONS[1:]:
        _assert_same_tree(_section(got, section), _section(want, section), f'.{section}')
    over = [('RPN.LOC_SCOPE', '2.5'), ('TRAIN.DECAY_STEP_LIST', '[3, 7]'), ('TAG', 'x')]
    _assert_same_tree(tcfg.load_config(str(yaml_file), over),
                      jcfg.load_config(str(yaml_file), over))


@pytest.mark.parametrize('bad', [{'NOPE': 1}, {'RPN': {'NOPE': 1}}, {'RPN': 3},
                                 {'RPN': {'USE_BN': 1}}, {'TRAIN': {'MOMS': 0.9}},
                                 {'CLASSES': 3}],
                         ids=['unknown', 'nested-unknown', 'not-a-mapping', 'bool-vs-int',
                              'tuple-vs-scalar', 'str-vs-int'])
def test_merge_refuses_what_jax_refuses(bad):
    with pytest.raises(Exception) as want:
        jcfg.Config().merged(bad)
    with pytest.raises(want.type):
        tcfg.Config().merged(bad)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_box_functions_equal(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-6, 6, (2000, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-3, 3, (6, 3)), rng.uniform(1, 5, (6, 3)),
                            rng.uniform(-np.pi, np.pi, (6, 1))], axis=1).astype(np.float32)
    for width in (0.0, 0.2, 1.5):
        got, want = tbox.enlarge_box3d(boxes, width), jbox.enlarge_box3d(boxes, width)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for box in boxes:
        inside = tbox.points_in_box3d(pts, box)
        np.testing.assert_array_equal(inside, jbox.points_in_box3d(pts, box))
    assert 0 < sum(tbox.points_in_box3d(pts, b).sum() for b in boxes) < len(pts)
    got, want = tbox.boxes3d_to_corners3d(boxes), jbox.boxes3d_to_corners3d(boxes)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for angle in (0.3, -1.2):
        got, want = tbox.rotate_pc_along_y(boxes, angle), jbox.rotate_pc_along_y(boxes, angle)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


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


PORT_SOURCES = [ROOT / 'chip_smoke.py', *sorted((ROOT / 'epnet_tpu_torch').rglob('*.py'))]


@pytest.mark.parametrize('path', PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert not _imported_roots(path) & {'jax', 'jaxlib', 'flax', 'epnet_tpu'}


def _docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, 'body', None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            yield body[0].value


def _names_jax_path(text):
    """A literal that loads from the JAX package: its directory as a path
    segment (``root / 'epnet_tpu'``), a module name for importlib
    (``'epnet_tpu.config'``), or a path to a file or directory that exists
    under ``epnet_tpu/``, whole or inside a longer path. A citation such as
    ``'epnet_tpu/ops/conv2d.py:294'`` names no file that exists."""
    text = text.strip().replace('\\', '/')
    if text.rstrip('/') == 'epnet_tpu' or text.startswith('epnet_tpu.'):
        return True
    at = text.find('epnet_tpu/')
    while at >= 0:
        if (at == 0 or text[at - 1] in '/.') and (ROOT / text[at:]).exists():
            return True
        at = text.find('epnet_tpu/', at + 1)
    return False


def _jax_paths(path):
    """String literals of ``path`` outside docstrings that name a path
    under ``epnet_tpu/`` (f-string pieces included)."""
    tree = ast.parse(path.read_text())
    docs = {id(n) for n in _docstrings(tree)}
    return sorted(n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and id(n) not in docs and _names_jax_path(n.value))


@pytest.mark.parametrize('path', PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_reads_no_jax_file(path):
    assert not _jax_paths(path)


def test_jax_path_check_catches_loads_by_path(tmp_path):
    """The check is not vacuous: each way of loading a JAX-package file by
    path is caught, a citation and a docstring are not."""
    bad = {"root / 'epnet_tpu' / 'config.py'", "importlib.import_module('epnet_tpu.config')",
           "open('epnet_tpu/data/box_np.py')", "Path(f'{root}/epnet_tpu/config.py')",
           "os.path.join(root, 'epnet_tpu/')"}
    for i, line in enumerate(sorted(bad)):
        src = tmp_path / f'bad{i}.py'
        src.write_text(f'x = {line}\n')
        assert _jax_paths(src), line
    ok = tmp_path / 'ok.py'
    ok.write_text('"""Port of ``epnet_tpu/config.py``."""\n'
                  "ref = 'epnet_tpu/ops/conv2d.py:294'\nname = 'epnet_tpu_torch.config'\n")
    assert not _jax_paths(ok)
