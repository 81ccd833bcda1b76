"""BipedalWalker environment core, batched over N walkers.

Port of ``dcd_isaac_tpu/envs/walker/env.py``: body placement, the action's
motor mapping, the 24-d observation, the shaping reward and termination.
A level is its 8 params and a terrain seed; ``reset_walker`` builds its
terrain and placement (kernel B11, ``kernels/walker_terrain.py``) and takes
the reference's zero-action first step; ``step_walker`` is kernel B10
(``kernels/walker_step.py``).  ``step_walker_plain`` is B10's plain twin,
built from ``physics.physics_step``, ``hull_origin`` and
``gen_walker_obs``; like them it divides by a constant through the
constant's float32 reciprocal, as XLA compiles the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...kernels import walker_step, walker_terrain
from ..seeds import hash_uniform
from . import physics as ph


@dataclasses.dataclass(frozen=True)
class WalkerState:
    bodies: ph.Bodies
    terrain: ph.Terrain
    prev_shaping: torch.Tensor      # (N,)
    game_over: torch.Tensor         # (N,) bool (hull ground contact)
    step_count: torch.Tensor        # (N,) int32
    lower_contact: torch.Tensor     # (N, 2) bool
    joint_angle: torch.Tensor       # (N, 4)
    joint_speed: torch.Tensor       # (N, 4)
    level_params: torch.Tensor      # (N, 8) float32
    level_seed: torch.Tensor        # (N,) int32
    adv_step_count: torch.Tensor    # (N,) int32

    def replace(self, **kw) -> 'WalkerState':
        return dataclasses.replace(self, **kw)

    def where(self, mask: torch.Tensor, other: 'WalkerState'
              ) -> 'WalkerState':
        """Per walker: this state where ``mask`` (N,) is True, else
        ``other``."""
        return tree_where(mask, self, other)


def tree_where(mask, a, b):
    """``torch.where`` over the fields of two equal dataclasses of tensors
    (nested), the mask broadcast from the leading axis."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: tree_where(mask, getattr(a, f.name),
                                             getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, b)


# The hull's velocity from a unit push over one step, fx / mass * dt as XLA
# folds it: fx * (1 / mass * dt), the constants in float32.
PUSH_DV = float(np.float32(ph.recip(ph.BODY_MASS[0])) * np.float32(ph.DT))


def hull_origin(bodies: ph.Bodies) -> torch.Tensor:
    """(N, 2) Box2D body position (polygon local origin) of the hull."""
    c, s = ph.rot(bodies.angle[:, 0])
    hc = ph.HULL_CENTROID
    rx, ry = ph.rotate(c, s, float(hc[0]), float(hc[1]))
    return torch.stack([bodies.pos[:, 0, 0] - rx, bodies.pos[:, 0, 1] - ry],
                       -1)


def placement_draw(seeds: torch.Tensor) -> torch.Tensor:
    """(N,) uniforms of the initial nudge: slot 0 of column 200."""
    return hash_uniform(seeds, ph.TERRAIN_LENGTH, 0)


def place_walker(u: torch.Tensor) -> ph.Bodies:
    """Initial placement of N walkers (walker_env.py:427-486); the hull's
    push U(-5, 5) for one step, from the uniforms ``u`` (N,)."""
    n, dev = u.shape[0], u.device
    init_x = ph.TERRAIN_STEP * ph.TERRAIN_STARTPAD / 2
    init_y = ph.TERRAIN_HEIGHT + 2 * ph.LEG_H
    hull = ph.f32([init_x, init_y], dev) + ph.f32(ph.HULL_CENTROID, dev)
    leg_y = init_y - ph.LEG_H / 2 - ph.LEG_DOWN
    low_y = init_y - ph.LEG_H * 3 / 2 - ph.LEG_DOWN
    pos = torch.stack([hull, ph.f32([init_x, leg_y], dev),
                       ph.f32([init_x, low_y], dev),
                       ph.f32([init_x, leg_y], dev),
                       ph.f32([init_x, low_y], dev)])
    angle = ph.f32([0.0, -0.05, -0.05, 0.05, 0.05], dev)
    lim = torch.full((n,), ph.INITIAL_RANDOM, device=dev)
    fx = torch.maximum(-lim, u * (lim - (-lim)) + (-lim))
    vel = torch.zeros((n, 5, 2), device=dev)
    vel[:, 0, 0] = fx * PUSH_DV
    return ph.Bodies(pos=pos.expand(n, 5, 2).clone(),
                     angle=angle.expand(n, 5).clone(), vel=vel,
                     angvel=torch.zeros((n, 5), device=dev))


def gen_walker_obs(state: WalkerState) -> torch.Tensor:
    """(N, 24) observation (walker_env.py:543-563)."""
    b = state.bodies
    lidar = ph.lidar(b, state.terrain)
    ja, js = state.joint_angle, state.joint_speed
    lc = state.lower_contact.float()
    vel = b.vel[:, 0]
    fps, hip, knee = (ph.recip(c) for c in (ph.FPS, ph.SPEED_HIP,
                                             ph.SPEED_KNEE))
    return torch.cat([torch.stack([
        b.angle[:, 0],
        2.0 * b.angvel[:, 0] * fps,
        0.3 * vel[:, 0] * (ph.VIEWPORT_W / ph.SCALE) * fps,
        0.3 * vel[:, 1] * (ph.VIEWPORT_H / ph.SCALE) * fps,
        ja[:, 0], js[:, 0] * hip,
        ja[:, 1] + 1.0, js[:, 1] * knee,
        lc[:, 0],
        ja[:, 2], js[:, 2] * hip,
        ja[:, 3] + 1.0, js[:, 3] * knee,
        lc[:, 1]], -1), lidar], -1)


def step_walker_plain(state: WalkerState, action: torch.Tensor,
                      first: bool = False):
    """→ (state, obs, reward, done, finish), walker_env.py:503-588: kernel
    B10's plain twin."""
    a = torch.clamp(action.abs(), 0.0, 1.0)
    motor_speed = torch.sign(action) * ph.f32(ph.JOINT_SPEED, action.device)
    motor_torque = ph.MOTORS_TORQUE * a
    bodies, lower_contact, j_angle, j_speed, hull_contact = ph.physics_step(
        state.bodies, state.terrain, motor_speed, motor_torque)
    game_over = state.game_over | hull_contact
    state = state.replace(
        bodies=bodies, lower_contact=lower_contact, joint_angle=j_angle,
        joint_speed=j_speed, game_over=game_over,
        step_count=state.step_count + (0 if first else 1))

    pos = hull_origin(bodies)
    shaping = (130.0 * pos[:, 0] * ph.recip(ph.SCALE)
               - 5.0 * bodies.angle[:, 0].abs())
    reward = (torch.zeros_like(shaping) if first
              else shaping - state.prev_shaping)
    state = state.replace(prev_shaping=shaping)
    cost = 0.00035 * ph.MOTORS_TORQUE * a
    reward = reward - (((cost[:, 0] + cost[:, 1]) + cost[:, 2]) + cost[:, 3])
    fell = game_over | (pos[:, 0] < 0)
    finish = pos[:, 0] > ((ph.TERRAIN_LENGTH - ph.TERRAIN_GRASS)
                          * ph.TERRAIN_STEP)
    reward = torch.where(fell, torch.full_like(reward, -100.0), reward)
    done = fell | finish
    return state, gen_walker_obs(state), reward, done, finish


def step_walker(state: WalkerState, action: torch.Tensor,
                first: bool = False):
    """→ (state, obs, reward, done, finish): kernel B10 on CUDA tensors,
    :func:`step_walker_plain` on CPU tensors."""
    return walker_step.step(state, action, first)


def _reset_with_terrain(terrain: ph.Terrain, bodies: ph.Bodies,
                        level_params: torch.Tensor,
                        level_seed: torch.Tensor):
    """A fresh state on a built terrain, after the reference's zero-action
    first step (walker_env.py:498), whose shaping becomes the baseline."""
    n, dev = level_params.shape[0], level_params.device
    zeros = lambda *s: torch.zeros((n, *s), device=dev)
    i32 = torch.zeros((n,), dtype=torch.int32, device=dev)
    state = WalkerState(
        bodies=bodies, terrain=terrain, prev_shaping=zeros(),
        game_over=torch.zeros((n,), dtype=torch.bool, device=dev),
        step_count=i32,
        lower_contact=torch.zeros((n, 2), dtype=torch.bool, device=dev),
        joint_angle=zeros(4), joint_speed=zeros(4),
        level_params=level_params, level_seed=level_seed.int(),
        adv_step_count=i32)
    state, obs, _, _, _ = step_walker(state, zeros(4), first=True)
    return state, obs


def reset_walker(level_params: torch.Tensor, level_seed: torch.Tensor):
    """N states built from (params (N, 8), seeds (N,)) → (state, obs).

    The terrain and placement are a pure function of (params, seed)
    (kernel B11), so every reset of a level replays it exactly.
    """
    terrain, bodies = walker_terrain.generate(level_params.contiguous(),
                                              level_seed.int().contiguous())
    return _reset_with_terrain(terrain, bodies, level_params, level_seed)
