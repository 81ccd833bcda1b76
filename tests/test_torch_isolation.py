"""The port stands alone: it imports no JAX and nothing of the JAX
package, it refuses a missing card instead of moving to the CPU, and its
kernel wrappers take their plain twins only for CPU tensors."""

import glob
import os
import subprocess
import sys

import pytest
import torch

from dcd_isaac_tpu_torch import resolve_device
from dcd_isaac_tpu_torch.kernels import _build
from dcd_isaac_tpu_torch.kernels import gae as gae_mod
from dcd_isaac_tpu_torch.kernels import multigrid_step as mg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Refuses jax, flax, optax and the JAX package by exact top-level name, so
# dcd_isaac_tpu_torch (which merely starts with 'dcd_isaac_tpu') passes.
IMPORT_ALL = r'''
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {'jax', 'flax', 'optax', 'dcd_isaac_tpu'}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'refused import of {name}')
        return None

sys.meta_path.insert(0, Refuse())
import dcd_isaac_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    dcd_isaac_tpu_torch.__path__, 'dcd_isaac_tpu_torch.'))
for name in (names if sys.argv[1] == 'forward' else names[::-1]):
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split('.')[0] in BLOCKED]
assert not leaked, leaked
print(len(names))
'''


@pytest.mark.parametrize('order', ['forward', 'reverse'])
def test_port_and_smoke_import_without_jax(order):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', IMPORT_ALL, order],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_kernels_build_without_torch_headers():
    for src in glob.glob(os.path.join(ROOT, 'dcd_isaac_tpu_torch', 'csrc',
                                      '*')):
        with open(src) as f:
            assert 'torch/extension.h' not in f.read(), src
    with open(_build.__file__) as f:
        assert 'cpp_extension.load' not in f.read()
    assert _build.sources() and all(
        s.endswith(".cu") for s in _build.sources())


def test_resolve_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, 'CUDA_HOME', None)
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build()


def _state(n, device='cpu'):
    g = torch.Generator().manual_seed(0)
    grid = torch.randint(1, 3, (n, 7, 7), generator=g, dtype=torch.uint8)
    grid[:, 3, 3] = 8
    return (grid.to(device),
            torch.randint(1, 6, (n, 2), generator=g).int().to(device),
            torch.randint(0, 4, (n,), generator=g).int().to(device))


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError('kernel build requested')
    monkeypatch.setattr(_build, 'build', refuse)
    monkeypatch.setattr(_build, 'library', refuse)


def test_wrappers_take_plain_twins_on_cpu_without_building(monkeypatch):
    _no_build(monkeypatch)
    n = 6
    grid, pos, d = _state(n)
    step = torch.zeros(n, dtype=torch.int32)
    done = torch.zeros(n, dtype=torch.bool)
    action = torch.tensor([0, 1, 2, 2, 3, 6], dtype=torch.int32)
    counts = (mg.multigrid_step.launches, mg.multigrid_obs.launches,
              gae_mod.gae.launches)
    got = mg.multigrid_step(grid, pos, d, step, done, action, 5, 10)
    want = mg.step_plain(grid, pos, d, step, done, action, 5, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(mg.multigrid_obs(grid, pos, d, 5),
                       mg.obs_plain(grid, pos, d, 5))
    T = 5
    x = dict(rewards=torch.rand(T, n), values=torch.rand(T, n),
             dones=torch.rand(T, n) < 0.3, bad_masks=torch.ones(T, n),
             trunc_values=torch.rand(T, n), next_value=torch.rand(n))
    assert torch.equal(gae_mod.gae(**x, gamma=0.99, gae_lambda=0.95),
                       gae_mod.gae_plain(**x, gamma=0.99, gae_lambda=0.95))
    assert counts == (mg.multigrid_step.launches, mg.multigrid_obs.launches,
                      gae_mod.gae.launches)


def test_non_cpu_tensors_never_fall_back_to_the_twin(monkeypatch):
    """A tensor off the CPU goes to the kernel (here the refused build
    raises); the plain twin is not a fallback."""
    _no_build(monkeypatch)
    grid, pos, d = _state(4, 'meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        mg.multigrid_obs(grid, pos, d, 5)
    z = torch.zeros((3, 4), device='meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        gae_mod.gae(z, z, z.bool(), z, z, z[0], 0.99, 0.95)


@pytest.mark.parametrize('device', ['cpu', 'meta'])
@pytest.mark.parametrize('wrapper', ['multigrid_step', 'multigrid_obs'])
def test_opaque_walls_raise_on_every_device(monkeypatch, device, wrapper):
    """Opaque walls are not ported: the wrappers raise for them whatever
    the device, so the CPU cannot run what the card cannot."""
    _no_build(monkeypatch)
    n = 4
    grid, pos, d = _state(n, device)
    if wrapper == 'multigrid_obs':
        call = lambda: mg.multigrid_obs(grid, pos, d, 5,
                                        see_through_walls=False)
    else:
        z = lambda dtype: torch.zeros(n, dtype=dtype, device=device)
        call = lambda: mg.multigrid_step(
            grid, pos, d, z(torch.int32), z(torch.bool), z(torch.int32), 5,
            10, see_through_walls=False)
    with pytest.raises(NotImplementedError, match='opaque walls'):
        call()


def test_wrappers_check_their_inputs():
    grid, pos, d = _state(4)
    with pytest.raises(TypeError):
        mg.multigrid_obs(grid.int(), pos, d, 5)
    with pytest.raises(ValueError):
        mg.multigrid_obs(grid, pos[:3], d, 5)
    with pytest.raises(ValueError):
        mg.multigrid_obs(grid.transpose(1, 2), pos, d, 5)
    z = torch.zeros((3, 4))
    with pytest.raises(ValueError):
        gae_mod.gae(z, z, z, z, z, z[0], 0.99, 0.95)      # float dones
    with pytest.raises(ValueError):
        gae_mod.gae(z, z.T, z.bool(), z, z, z[0], 0.99, 0.95)
