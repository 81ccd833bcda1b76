"""Kernel B13a: one control step (8 physics substeps) of N CarRacing cars.

Replaces ``dcd_isaac_tpu/envs/carracing/env.py:step`` (:186-309) with
``dynamics.py:car_step``, ``_visit_tiles`` and ``_goal_eval``, all but the
frame (kernel B12).  The CUDA source is ``csrc/carracing_step.cu``: one
warp a car, the track and the visited tiles in shared memory, the
nearest-point searches split across the lanes.  It is bound by the 8
dependent substeps, not by its 9 kB a car.

:func:`step` takes the env config, a ``CarRacingState`` and (N, 3)
actions and returns (state with the old frames, reward, done, truncated).
CPU tensors take the plain twin
``envs/carracing/env.py:step_dynamics_plain``; CUDA tensors launch the
kernel (counted in ``step.launches``) or raise.  The kernel's constants
are one float32 table (:func:`consts`) built with the twin's arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Table layout (csrc/carracing_step.cu: C_*): name → width.
CONSTS = (('wheel_x', 4), ('wheel_y', 4), ('front', 4), ('rear', 4),
          ('gas', 1), ('r_moment', 1), ('r_mass', 1), ('r_inertia', 1),
          ('dt', 1), ('wheel_r', 1), ('force_coef', 1),
          ('friction_limit', 1), ('grass', 1), ('steer_limit', 1),
          ('track_width', 1), ('t_step', 1), ('r_history', 1), ('tiny', 1))
NUM_CONSTS = sum(w for _, w in CONSTS)


@functools.lru_cache(maxsize=None)
def consts(device: torch.device) -> torch.Tensor:
    """The (NUM_CONSTS,) float32 table on ``device``."""
    from ..envs.carracing import dynamics as dy
    from ..envs.carracing import track as tr
    from ..envs.carracing.env import HISTORY
    v = lambda *x: torch.tensor(x, dtype=torch.float64).float()
    parts = {
        'wheel_x': v(*dy.WHEEL_X), 'wheel_y': v(*dy.WHEEL_Y),
        'front': v(*dy.FRONT), 'rear': v(*dy.REAR), 'gas': v(dy.C_GAS),
        'r_moment': v(dy.R_MOMENT), 'r_mass': v(dy.R_MASS),
        'r_inertia': v(dy.R_INERTIA), 'dt': v(dy.DT),
        'wheel_r': v(dy.WHEEL_R), 'force_coef': v(dy.FORCE_COEF),
        'friction_limit': v(dy.FRICTION_LIMIT), 'grass': v(0.6),
        'steer_limit': v(dy.STEER_LIMIT), 'track_width': v(tr.TRACK_WIDTH),
        't_step': v(1.0 / tr.FPS), 'r_history': v(tr.recip(HISTORY)),
        'tiny': v(1e-9)}
    table = torch.cat([parts[name] for name, _ in CONSTS])
    assert table.numel() == NUM_CONSTS
    return table.to(device)


def step(cfg, state, action: torch.Tensor):
    """→ (state with the old frames, summed shaped reward (N,), done (N,),
    truncated (N,))."""
    if action.device.type == 'cpu':
        from ..envs.carracing.env import step_dynamics_plain
        return step_dynamics_plain(cfg, state, action)
    car, tr = state.car, state.track
    N, dev = action.shape[0], action.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    P, H = tr.capacity, state.reward_history.shape[1]
    ins = (('pos', car.pos, f32, (N, 2)), ('angle', car.angle, f32, (N,)),
           ('vel', car.vel, f32, (N, 2)), ('angvel', car.angvel, f32, (N,)),
           ('wheel_omega', car.wheel_omega, f32, (N, 4)),
           ('steer_angle', car.steer_angle, f32, (N,)),
           ('gas', car.gas, f32, (N,)),
           ('fuel_spent', car.fuel_spent, f32, (N,)),
           ('points', tr.points, f32, (N, 480, 2)),
           ('valid', tr.valid, b8, (N, 480)),
           ('n_points', tr.n_points, i32, (N,)),
           ('visited', state.visited, b8, (N, P)),
           ('tile_visited_count', state.tile_visited_count, i32, (N,)),
           ('reward_total', state.reward_total, f32, (N,)),
           ('prev_reward', state.prev_reward, f32, (N,)),
           ('t', state.t, f32, (N,)),
           ('inner_steps', state.inner_steps, i32, (N,)),
           ('reward_history', state.reward_history, f32, (N, 100)),
           ('hist_ptr', state.hist_ptr, i32, (N,)),
           ('done_latch', state.done_latch, b8, (N,)),
           ('goal_bin', state.goal_bin, i32, (N,)),
           ('goal_reached', state.goal_reached, b8, (N,)),
           ('sparse_accum', state.sparse_accum, f32, (N,)),
           ('action', action, f32, (N, 3)))
    for name, x, dtype, shape in ins:
        _build.check_tensor(name, x, dtype, shape, dev)
    out = {k: torch.empty(s, dtype=d, device=dev) for k, s, d in (
        ('pos', (N, 2), f32), ('angle', (N,), f32), ('vel', (N, 2), f32),
        ('angvel', (N,), f32), ('wheel_omega', (N, 4), f32),
        ('steer_angle', (N,), f32), ('gas', (N,), f32),
        ('fuel_spent', (N,), f32), ('visited', (N, P), b8),
        ('tile_visited_count', (N,), i32), ('reward_total', (N,), f32),
        ('prev_reward', (N,), f32), ('t', (N,), f32),
        ('inner_steps', (N,), i32), ('reward_history', (N, H), f32),
        ('hist_ptr', (N,), i32), ('done_latch', (N,), b8),
        ('goal_reached', (N,), b8), ('sparse_accum', (N,), f32),
        ('reward', (N,), f32), ('done', (N,), b8), ('truncated', (N,), b8))}
    flags = (int(cfg.reward_shaping) | 2 * int(cfg.sparse_rewards)
             | 4 * int(cfg.clip_reward is not None))
    lib = _build.library()
    if lib.dcd_carracing_step_consts_count() != NUM_CONSTS:
        raise RuntimeError('dcd_carracing_step: the kernel and the wrapper '
                           'disagree on the constant table')
    from ..envs.carracing.track import recip
    rc = lib.dcd_carracing_step(
        *(x.data_ptr() for _, x, _, _ in ins), consts(dev).data_ptr(),
        *(x.data_ptr() for x in out.values()), N, cfg.num_action_repeat,
        cfg.max_inner_steps, flags, cfg.num_goal_bins,
        ctypes.c_float(cfg.playfield),
        ctypes.c_float(cfg.clip_reward or 0.0),
        ctypes.c_float(recip(cfg.num_goal_bins)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'carracing_step')
    step.launches += 1
    new_car = type(car)(**{f: out[f] for f in (
        'pos', 'angle', 'vel', 'angvel', 'wheel_omega', 'steer_angle', 'gas',
        'fuel_spent')})
    state = state.replace(car=new_car, **{f: out[f] for f in (
        'visited', 'tile_visited_count', 'reward_total', 'prev_reward', 't',
        'inner_steps', 'reward_history', 'hist_ptr', 'done_latch',
        'goal_reached', 'sparse_accum')})
    return state, out['reward'], out['done'], out['truncated']


step.launches = 0
