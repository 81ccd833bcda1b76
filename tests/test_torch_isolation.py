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
    assert int(proc.stdout.split()[-1]) >= 40


# the CarRacing slice's modules, imported alone with JAX refused
CARRACING_MODULES = (
    'envs.carracing', 'envs.carracing.bezier', 'envs.carracing.track',
    'envs.carracing.dynamics', 'envs.carracing.env',
    'envs.carracing.adversarial', 'models.car_racing_models',
    'kernels.carracing_track', 'kernels.carracing_render',
    'kernels.carracing_step', 'utils.geo_complexity')


@pytest.mark.parametrize('module', CARRACING_MODULES)
def test_carracing_modules_import_without_jax(module):
    code = IMPORT_ALL.split('import dcd_isaac_tpu_torch')[0] + (
        f'import dcd_isaac_tpu_torch.{module}\n'
        'leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]\n'
        'assert not leaked, leaked\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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


def test_teacher_kernel_wrappers_take_plain_twins_on_cpu(monkeypatch):
    """Kernels B4 and B5 on CPU tensors: the plain twins, no build, no
    launch counted."""
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    _no_build(monkeypatch)
    env = make_env('MultiGrid-MiniAdversarial-v0')
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(3, gen, 'cpu')
    loc = torch.tensor([0, 5, 9], dtype=torch.int32)
    u = torch.rand((3, 3), generator=gen)
    counts = (ma.step.launches, ma.shortest_path.launches,
              tp.teacher_proj.launches)
    got, want = ma.step(state, loc, u, env.params), ma.step_plain(
        state, loc, u, env.params)
    assert all(torch.equal(got[k], want[k]) for k in want)
    grid, pos, _ = _state(3)
    assert all(torch.equal(a, b) for a, b in zip(
        ma.shortest_path(grid, pos, pos.flip(1).contiguous(), 26),
        ma.shortest_path_plain(grid, pos, pos.flip(1).contiguous(), 26)))
    img = torch.randint(0, 11, (2, 7, 7, 3), dtype=torch.uint8)
    w = (torch.rand(32, 3, 3, 3), torch.rand(32), torch.rand(2, 4),
         torch.rand(8, 25 * 32 + 4))
    assert torch.equal(tp.teacher_proj(img, *w),
                       tp.teacher_proj_plain(img, *w))
    assert counts == (ma.step.launches, ma.shortest_path.launches,
                      tp.teacher_proj.launches)


def test_teacher_kernel_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    _no_build(monkeypatch)
    grid, pos, _ = _state(4, 'meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        ma.shortest_path(grid, pos, pos, 26)
    img = torch.zeros((2, 7, 7, 3), dtype=torch.uint8, device='meta')
    w = [torch.zeros(s, device='meta')
         for s in ((32, 3, 3, 3), (32,), (2, 4), (8, 25 * 32 + 4))]
    with pytest.raises(RuntimeError, match='kernel build requested'):
        tp.teacher_proj(img, *w)
    with pytest.raises(ValueError, match='multiple of 32'):
        tp.teacher_proj(img, w[0][:16].contiguous(), w[1][:16].contiguous(),
                        w[2], torch.zeros((8, 25 * 16 + 4), device='meta'))


def _to(x, device):
    """A (nested) dataclass of tensors on ``device``."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), device)
                          for f in dataclasses.fields(x)})
    return x.to(device)


def test_walker_kernel_wrappers_take_plain_twins_on_cpu(monkeypatch):
    """Kernels B10, B11 and B7's Gaussian branch on CPU tensors: the plain
    twins, no build, no launch counted."""
    from dcd_isaac_tpu_torch.envs.walker.adversarial import (
        AdversarialWalker, WalkerParams,
    )
    from dcd_isaac_tpu_torch.envs.walker.env import step_walker_plain
    from dcd_isaac_tpu_torch.envs.walker.terrain import (
        generate_terrain, terrain_draws,
    )
    from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
    from dcd_isaac_tpu_torch.kernels import walker_step, walker_terrain
    _no_build(monkeypatch)
    counts = (walker_step.step.launches, walker_terrain.generate.launches,
              pl.ppo_loss_gaussian.launches)
    env = AdversarialWalker(WalkerParams(mode='easy'))
    state, _ = env.reset_random(3, torch.Generator().manual_seed(0), 'cpu')
    a = torch.rand(3, 4) * 2 - 1
    got, want = walker_step.step(state, a), step_walker_plain(state, a)
    assert all(torch.equal(x, y) for x, y in zip(got[1:], want[1:]))
    params = state.level_params
    terrain, _ = walker_terrain.generate(params, state.level_seed)
    assert torch.equal(terrain.ys, generate_terrain(
        params, terrain_draws(state.level_seed)).ys)
    x = [torch.rand(5, 4), torch.zeros(4), torch.rand(5), torch.rand(5, 4)]
    x += [torch.rand(5) for _ in range(4)]
    assert all(torch.equal(p, q) for p, q in zip(
        pl.ppo_loss_gaussian(*x, 0.2, False, 0.5, 0.01),
        pl.ppo_loss_gaussian_plain(*x, 0.2, False, 0.5, 0.01)))
    assert counts == (walker_step.step.launches,
                      walker_terrain.generate.launches,
                      pl.ppo_loss_gaussian.launches)


def test_walker_kernel_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    from dcd_isaac_tpu_torch.envs.walker.adversarial import (
        AdversarialWalker, WalkerParams,
    )
    from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
    from dcd_isaac_tpu_torch.kernels import walker_step, walker_terrain
    env = AdversarialWalker(WalkerParams(mode='easy'))
    state, _ = env.reset_random(2, torch.Generator().manual_seed(0), 'cpu')
    _no_build(monkeypatch)
    meta = _to(state, 'meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        walker_step.step(meta, torch.zeros((2, 4), device='meta'))
    with pytest.raises(RuntimeError, match='kernel build requested'):
        walker_terrain.generate(meta.level_params, meta.level_seed)
    z = lambda *s: torch.zeros(s, device='meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        pl.ppo_loss_gaussian(z(5, 4), z(4), z(5), z(5, 4), z(5), z(5),
                             z(5), z(5), 0.2, False, 0.5, 0.01)
    with pytest.raises(ValueError, match='at most 8'):
        pl.ppo_loss_gaussian(z(5, 9), z(9), z(5), z(5, 9), z(5), z(5),
                             z(5), z(5), 0.2, False, 0.5, 0.01)


def test_carracing_kernel_wrappers_take_plain_twins_on_cpu(monkeypatch):
    """Kernels B12, B13a, B13b and B7's Beta branch on CPU tensors: the
    plain twins, no build, no launch counted."""
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing, build_level_plain,
    )
    from dcd_isaac_tpu_torch.envs.carracing.env import (
        CarRacingConfig, stack_frames_plain, step_dynamics_plain,
    )
    from dcd_isaac_tpu_torch.kernels import carracing_render as cr
    from dcd_isaac_tpu_torch.kernels import carracing_step as cs
    from dcd_isaac_tpu_torch.kernels import carracing_track as ct
    from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
    _no_build(monkeypatch)
    counts = (ct.build.launches, cr.render.launches, cs.step.launches,
              pl.ppo_loss_beta.launches)
    env = AdversarialCarRacing()
    state, _ = env.reset_random(2, torch.Generator().manual_seed(0), 'cpu')
    cfg = CarRacingConfig()
    cps, n, alpha, _, _ = env.decode_level(env.get_level(state))
    got, want = ct.build(cps, n, alpha), build_level_plain(cps, n, alpha)
    assert torch.equal(got[0].points, want[0].points)
    a = torch.rand(2, 3)
    got, want = cs.step(cfg, state, a), step_dynamics_plain(cfg, state, a)
    assert all(torch.equal(x, y) for x, y in zip(got[1:], want[1:]))
    assert torch.equal(
        cr.render(cfg, state.car, state.track, state.t, state.frames),
        stack_frames_plain(cfg, state.car, state.track, state.t,
                           state.frames))
    x = [1 + torch.rand(5, 3), 1 + torch.rand(5, 3), torch.rand(5),
         torch.rand(5, 3)] + [torch.rand(5) for _ in range(4)]
    assert all(torch.equal(p, q) for p, q in zip(
        pl.ppo_loss_beta(*x, 0.2, False, 0.5, 0.01),
        pl.ppo_loss_beta_plain(*x, 0.2, False, 0.5, 0.01)))
    assert counts == (ct.build.launches, cr.render.launches,
                      cs.step.launches, pl.ppo_loss_beta.launches)


def test_carracing_kernel_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing,
    )
    from dcd_isaac_tpu_torch.envs.carracing.env import CarRacingConfig
    from dcd_isaac_tpu_torch.kernels import carracing_render as cr
    from dcd_isaac_tpu_torch.kernels import carracing_step as cs
    from dcd_isaac_tpu_torch.kernels import carracing_track as ct
    from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
    env = AdversarialCarRacing()
    state, _ = env.reset_random(2, torch.Generator().manual_seed(0), 'cpu')
    _no_build(monkeypatch)
    meta = _to(state, 'meta')
    cfg = CarRacingConfig()
    z = lambda *s: torch.zeros(s, device='meta')
    for call in (
            lambda: ct.build(z(2, 12, 2), z(2).int(), z(2)),
            lambda: cs.step(cfg, meta, z(2, 3)),
            lambda: cr.render(cfg, meta.car, meta.track, meta.t,
                              meta.frames),
            lambda: pl.ppo_loss_beta(z(5, 3), z(5, 3), z(5), z(5, 3), z(5),
                                     z(5), z(5), z(5), 0.2, False, 0.5,
                                     0.01)):
        with pytest.raises(RuntimeError, match='kernel build requested'):
            call()
