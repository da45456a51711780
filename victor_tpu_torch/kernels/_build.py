"""Build and load the hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface. At first use it
is compiled by nvcc for Hopper (sm_90a) into a shared library under
`build/victor_tpu_torch/` beside the package, named by a hash of the source
and the flags, and loaded with ctypes. Nothing is prebuilt and nothing falls
back: without nvcc the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'victor_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
DEFAULT_NVCC = '/usr/local/cuda/bin/nvcc'

_LOADED: dict = {}


def nvcc_path() -> str:
    path = shutil.which('nvcc') or DEFAULT_NVCC
    if not os.path.isfile(path):
        raise RuntimeError(
            'nvcc not found (looked on PATH and at /usr/local/cuda/bin): the '
            'CUDA kernels of victor_tpu_torch are built from source at first '
            'use and need the CUDA toolkit')
    return path


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile csrc/<name>.cu unless a library for this exact source and
    these flags exists; return the library's path. nvcc's report (including
    ptxas register and shared-memory use) is kept beside it as `.log`."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib = build_dir / f'{name}-{digest}.so'
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {src} (exit {proc.returncode})'
                               f':\n{proc.stdout}{proc.stderr}')
        lib.with_suffix('.log').write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
