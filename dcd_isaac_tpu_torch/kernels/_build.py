"""Build and load the port's CUDA kernels.

Each source in ``csrc/*.cu`` is compiled by its own ``nvcc -c``, all of
them started together, and one ``nvcc -shared`` links the objects into
``_build/libdcd_kernels_<hash>.so`` (the hash covers the sources and the
flags), loaded with ``ctypes``.  Each kernel exposes a plain C entry
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
_D = ctypes.c_double
# C signature of each entry point: (argtypes); every restype is int.
SIGNATURES = {
    'dcd_multigrid_step': [_P] * 14 + [_I] * 5 + [_P],
    'dcd_multigrid_obs': [_P] * 4 + [_I] * 4 + [_P],
    'dcd_gae': [_P] * 7 + [_I, _I, _F, _F, _I, _P],
    'dcd_adversary_step': [_P] * 24 + [_I] * 8 + [_F, _I, _P],
    'dcd_multigrid_shortest_path': [_P] * 5 + [_I] * 4 + [_P],
    'dcd_teacher_proj': [_P] * 7 + [_I] * 6 + [_P],
    'dcd_teacher_proj_workspace': [_I] * 5,
    'dcd_teacher_proj_backward': [_P] * 11 + [_I] * 7 + [_P],
    'dcd_teacher_proj_backward_workspace': [_I] * 5,
    'dcd_policy_step': [_P] * 32 + [_I] * 5 + [_P],
    'dcd_lstm_seq_plan': [_I, _I, _I, _P],
    'dcd_lstm_seq_forward': [_P] * 8 + [_I] * 3 + [_P],
    'dcd_lstm_seq_backward': [_P] * 12 + [_I] * 3 + [_P],
    'dcd_ppo_loss_workspace': [_I],
    'dcd_ppo_loss_forward': [_P] * 9 + [_I, _I, _F, _F, _F, _I, _F, _F, _P],
    'dcd_ppo_loss_backward': [_P] * 10 + [_I, _I, _F, _F, _F, _I, _F, _F,
                                          _P],
    'dcd_normalize_advantages_workspace': [_I],
    'dcd_normalize_advantages': [_P] * 4 + [_I, _P],
    'dcd_plr_score_fold': [_P] * 14 + [_I] * 7 + [_F] * 5 + [_P],
    'dcd_plr_sample_weights': [_P] * 6 + [_I, _I, _F, _I, _I] + [_F] * 4
                              + [_P],
    'dcd_plr_promote': [_P] * 19 + [_I] * 7 + [_I, _F, _I, _I] + [_F] * 6
                       + [_P],
    'dcd_multigrid_mutate': [_P] * 8 + [_I] * 5 + [_P],
    'dcd_multigrid_reset_random': [_P] * 6 + [_I] * 6 + [_P],
    'dcd_ppo_gauss_workspace': [_I],
    'dcd_ppo_gauss_forward': [_P] * 10 + [_I, _I, _F, _F, _F, _I, _F, _F,
                                          _F, _F, _P],
    'dcd_ppo_gauss_backward': [_P] * 13 + [_I, _I, _F, _F, _F, _I, _F, _F,
                                           _F, _P],
    'dcd_walker_consts_count': [],
    'dcd_walker_step': [_P] * 27 + [_I, _I, _P],
    'dcd_walker_terrain_consts_count': [],
    'dcd_walker_terrain': [_P] * 11 + [_I, _P],
    'dcd_carracing_track_consts_count': [],
    'dcd_carracing_track': [_P] * 13 + [_I, _P],
    'dcd_carracing_render_consts_count': [],
    'dcd_carracing_render': [_P] * 14 + [_I] * 5 + [_P],
    'dcd_carracing_step_consts_count': [],
    'dcd_carracing_step': [_P] * 47 + [_I] * 5 + [_F] * 3 + [_P],
    'dcd_ppo_beta_workspace': [_I],
    'dcd_ppo_beta_forward': [_P] * 10 + [_I, _F, _D, _D, _I, _F, _F, _P],
    'dcd_ppo_beta_backward': [_P] * 12 + [_I, _F, _D, _D, _I, _F, _F, _P],
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
    was already there.  Every ``nvcc`` it starts has ended when it returns
    or raises.
    """
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f'{path}.{os.getpid()}'
    compile_flags = [f for f in NVCC_FLAGS if f != '-shared']
    if verbose:
        compile_flags += ['-Xptxas', '-v']
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in sources():
            obj = f'{stem}.{os.path.basename(src)}.o'
            cmd = [nvcc, *compile_flags, '-c', '-o', obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                                   f'{" ".join(cmd)}\n{out}')
            logs.append(out)
        cmd = [nvcc, *NVCC_FLAGS, '-o', f'{stem}.tmp',
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{proc.stdout}\n'
                               f'{proc.stderr}')
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    if verbose:
        print(''.join(logs), flush=True)
    os.replace(f'{stem}.tmp', path)
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


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` has this dtype, shape and device and is
    contiguous: what a kernel's raw pointer assumes."""
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {rc}')
