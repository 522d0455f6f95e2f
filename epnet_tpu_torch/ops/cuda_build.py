"""Build and load the hand-written CUDA kernels in ``../csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc into
its own shared library, loaded with ctypes (no PyTorch headers, so a build
takes seconds). The build happens at first use and is keyed by a hash of
the source and the flags, under ``build/epnet_tpu_torch/`` at the root of
the checkout; delete that directory to force a rebuild. ptxas's register
and shared-memory report for each build is kept beside the library
(``<name>-<hash>.log``, see ``build_log``).

Nothing here runs at import time, so the CPU tests import the kernel
modules freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'epnet_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_libs: dict = {}
_logs: dict = {}
_locks: dict = {}
_lock = threading.Lock()  # guards _locks; each library builds under its own lock


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and (pathlib.Path(home) / 'bin' / 'nvcc').exists():
        return str(pathlib.Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = pathlib.Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _compile(src: pathlib.Path, so: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed to build {src.name} '
                           f'(exit {proc.returncode}):\n{proc.stderr}')
    so.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hash is not built yet, and load it.
    Different libraries may build at the same time from several threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f'{name}.cu'
        digest = hashlib.sha256(src.read_bytes()
                                + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f'{name}-{digest}.so'
        if not so.exists():
            _compile(src, so)
        lib = ctypes.CDLL(str(so))
        lib.epnet_error_string.argtypes = [ctypes.c_int]
        lib.epnet_error_string.restype = ctypes.c_char_p
        log = so.with_suffix('.log')
        _logs[name] = log.read_text() if log.exists() else ''
        _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) of a loaded kernel."""
    return _logs.get(name, '')


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.epnet_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
