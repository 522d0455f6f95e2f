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
