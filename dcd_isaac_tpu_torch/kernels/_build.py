"""Build and load the port's CUDA kernels.

All sources in ``csrc/*.cu`` are compiled by ONE ``nvcc -shared`` call into
``_build/libdcd_kernels_<hash>.so`` (the hash covers the sources and the
flags) and loaded with ``ctypes``.  Each kernel exposes a plain C entry
point that takes device pointers and a stream as ``void*`` and returns
``cudaGetLastError()`` after its launch, so nothing includes PyTorch's
headers and the build takes seconds.

Nothing is built at import: the first launch on a CUDA tensor calls
:func:`library`, which builds when the hashed library is missing and then
loads it once per process.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each entry point: (argtypes); every restype is int.
SIGNATURES = {
    'dcd_multigrid_step': [_P] * 14 + [_I] * 5 + [_P],
    'dcd_multigrid_obs': [_P] * 4 + [_I] * 4 + [_P],
    'dcd_gae': [_P] * 7 + [_I, _I, _F, _F, _I, _P],
}


def find_nvcc() -> str:
    """nvcc under torch's CUDA_HOME, else on PATH; raises if absent."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, 'bin', 'nvcc')
        if os.path.exists(cand):
            return cand
    cand = shutil.which('nvcc')
    if cand is None:
        raise RuntimeError(
            'nvcc not found (no CUDA_HOME/bin/nvcc and none on PATH): the '
            'CUDA kernels of dcd_isaac_tpu_torch cannot be built')
    return cand


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, '*.cu')))


def library_path() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, 'rb') as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'libdcd_kernels_{h.hexdigest()[:16]}.so')


def build(verbose: bool = False) -> tuple:
    """Compile the kernels unless the hashed library exists.

    Returns ``(path, seconds spent building)``; 0 seconds when the library
    was already there.
    """
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ['-Xptxas', '-v']
    cmd += ['-o', tmp, *sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n'
            f'{proc.stdout}\n{proc.stderr}')
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, path)
    return path, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {rc}')
