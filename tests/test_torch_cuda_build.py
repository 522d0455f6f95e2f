"""The build cache key of ``epnet_tpu_torch/ops/cuda_build.py``: a library
is rebuilt when its source, a local header it includes, or the flags
change."""

from epnet_tpu_torch.ops import cuda_build


def test_digest_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
    (tmp_path / 'common.cuh').write_text('int a;\n')
    (tmp_path / 'other.cuh').write_text('int b;\n')
    src = tmp_path / 'k.cu'
    src.write_text('#include <cstdint>\n#include "common.cuh"\nint k;\n')
    first = cuda_build._digest(src)
    assert cuda_build._digest(src) == first
    (tmp_path / 'other.cuh').write_text('int c;\n')  # not included: same key
    assert cuda_build._digest(src) == first
    (tmp_path / 'common.cuh').write_text('int d;\n')
    second = cuda_build._digest(src)
    assert second != first
    monkeypatch.setattr(cuda_build, 'NVCC_FLAGS', cuda_build.NVCC_FLAGS + ('-G',))
    assert cuda_build._digest(src) not in (first, second)


def test_every_kernel_source_has_a_key():
    """Each csrc/*.cu and the headers it names exist, so the key is defined."""
    sources = sorted(cuda_build.CSRC.glob('*.cu'))
    assert sources
    keys = {cuda_build._digest(s) for s in sources}
    assert len(keys) == len(sources)


def test_fused_sa_libraries_follow_their_shared_header(tmp_path, monkeypatch):
    """Kernels B (``sa_fused.cu``) and C/H (``sa_fused_bwd.cu``) share one
    copy of their device helpers, ``sa_common.cuh``: a change to it changes
    both libraries' keys, and nothing else's."""
    names = ('sa_fused.cu', 'sa_fused_bwd.cu', 'fps.cu', 'sa_common.cuh', 'common.cuh',
             'wgmma_common.cuh')
    for name in names:
        (tmp_path / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
    libs = ('sa_fused', 'sa_fused_bwd', 'fps')
    before = {n: cuda_build._digest(tmp_path / f'{n}.cu') for n in libs}
    header = tmp_path / 'sa_common.cuh'
    header.write_text(header.read_text() + '\n// changed\n')
    after = {n: cuda_build._digest(tmp_path / f'{n}.cu') for n in libs}
    assert after['sa_fused'] != before['sa_fused']
    assert after['sa_fused_bwd'] != before['sa_fused_bwd']
    assert after['fps'] == before['fps']


def test_digest_follows_nested_headers(tmp_path, monkeypatch):
    """A header that only another header includes keys the library too."""
    monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
    (tmp_path / 'inner.cuh').write_text('int a;\n')
    (tmp_path / 'outer.cuh').write_text('#pragma once\n#include "inner.cuh"\nint b;\n')
    src = tmp_path / 'k.cu'
    src.write_text('#include "outer.cuh"\nint k;\n')
    first = cuda_build._digest(src)
    (tmp_path / 'inner.cuh').write_text('int c;\n')
    assert cuda_build._digest(src) != first


def test_tensor_core_libraries_follow_the_shared_split(tmp_path, monkeypatch):
    """One TF32 split and one copy of the wgmma helpers,
    ``wgmma_common.cuh``: a change to it rebuilds the conv kernels (D, E,
    F, F-bf16) and the fused-SA kernels (B, C, H, through
    ``sa_common.cuh``), and not FPS."""
    for path in cuda_build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
    libs = ('conv3x3_dw', 'conv3x3_s2_fwd', 'sa_fused', 'sa_fused_bwd', 'fps')
    before = {n: cuda_build._digest(tmp_path / f'{n}.cu') for n in libs}
    header = tmp_path / 'wgmma_common.cuh'
    header.write_text(header.read_text() + '\n// changed\n')
    after = {n: cuda_build._digest(tmp_path / f'{n}.cu') for n in libs}
    assert [n for n in libs if after[n] != before[n]] == list(libs[:4])
