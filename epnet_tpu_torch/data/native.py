"""The host kernels of the input pipeline (``csrc/host_ops.cpp``) through
ctypes.

The port's counterpart of ``epnet_tpu/data/native.py``:
``points_in_boxes3d`` (point-in-rotated-box masks, for the gt-paste
augmentation) and ``roipool3d_cpu`` (the offline RCNN samples' RoI
pooling). The library is built with the host C++ compiler (``$CXX``, else
``g++``) at first use, with ``native/Makefile``'s flags, under
``build/epnet_tpu_torch/`` at the root of the checkout, keyed by a hash of
the source, the flags and the compiler's resolution of ``-march=native``
(a copy of the tree on another host builds its own), and written
atomically, as ``ops/cuda_build.py`` builds the CUDA kernels. Where it
cannot be built or loaded, the call raises: there is no numpy fallback.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / 'host_ops.cpp'
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-shared', '-std=c++17')

_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get('CXX') or 'g++'
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f'the host C++ compiler {cxx!r} was not found: set CXX or put '
                           f'g++ on PATH to build {SOURCE.name}')
    return found


def _target(cxx: str) -> bytes:
    """The compiler's expansion of ``-march=native`` on this host."""
    proc = subprocess.run([cxx, '-march=native', '-E', '-v', '-x', 'c++', '-'], input=b'',
                          capture_output=True)
    return b'\n'.join(line for line in proc.stderr.splitlines() if b'-march=' in line)


def library_path() -> pathlib.Path:
    """Where the library of this source, these flags and this host lives."""
    cxx = _cxx()
    key = hashlib.sha256(SOURCE.read_bytes() + ' '.join(CXX_FLAGS).encode()
                         + cxx.encode() + _target(cxx)).hexdigest()[:16]
    return BUILD_DIR / f'host_ops-{key}.so'


def _build(so: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.{threading.get_ident()}.tmp')
    proc = subprocess.run([_cxx(), *CXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'the host C++ compiler failed to build {SOURCE.name} '
                           f'(exit {proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """Build the library if this key is not built yet, and load it."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
            u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
            i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
            lib.pts_in_boxes3d_cpu.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, u8p]
            lib.pts_in_boxes3d_cpu.restype = None
            lib.roipool3d_cpu.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int64, f32p,
                                          ctypes.c_int64, ctypes.c_int64, f32p, i32p]
            lib.roipool3d_cpu.restype = None
            _lib = lib
        return _lib


def points_in_boxes3d(pts: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, >=3) points x (M, 7) boxes -> (M, N) bool membership."""
    lib = load()
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    out = np.empty((boxes.shape[0], pts.shape[0]), np.uint8)
    lib.pts_in_boxes3d_cpu(pts, pts.shape[0], boxes, boxes.shape[0], out)
    return out.astype(bool)


def roipool3d_cpu(pts: np.ndarray, feats: np.ndarray, boxes: np.ndarray,
                  sampled_pt_num: int):
    """The first ``sampled_pt_num`` points inside each box, in point order
    (repeated cyclically when fewer): (pooled (M, S, 3 + C), empty flag
    (M,) int32, 1 for a box with no point, whose rows are zeros)."""
    lib = load()
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    feats = np.ascontiguousarray(feats, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    m, c = boxes.shape[0], feats.shape[1]
    out = np.empty((m, sampled_pt_num, 3 + c), np.float32)
    empty = np.empty((m,), np.int32)
    lib.roipool3d_cpu(pts, feats, pts.shape[0], c, boxes, m, sampled_pt_num, out, empty)
    return out, empty
