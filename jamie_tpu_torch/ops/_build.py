"""Build the package's CUDA C++ kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C function, so it compiles in seconds
without PyTorch's headers. The shared library lands in
`jamie_tpu_torch/_build/lib<name>-<hash>.so`, keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is reused;
nvcc's output (with ptxas's register and shared-memory report) is kept
beside it as `lib<name>-<hash>.log`. Nothing is compiled at import:
`load(name)` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put it on PATH); '
                           'the CUDA kernels are built from csrc/ on first use')
    return found


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def build_log(name: str) -> str:
    """nvcc's output for the built library of csrc/<name>.cu."""
    return library_path(name).with_suffix('.log').read_text()


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, compiled on first use."""
    if name not in _loaded:
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
                 str(CSRC / f'{name}.cu')],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for csrc/{name}.cu:\n'
                                   f'{proc.stdout}')
            out.with_suffix('.log').write_text(proc.stdout)
            os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
        _loaded[name] = ctypes.CDLL(str(out))
    return _loaded[name]
