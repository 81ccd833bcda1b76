"""The CarRacing environment core over a batch of N cars (port of
``dcd_isaac_tpu/envs/carracing/env.py``).

The wrapper's semantics are folded into one step as in the JAX package:
the action repeated for 8 physics substeps with tile-visit rewards, the
shaping (+100 at the finish, −0.05 with the hull off the road), the
100-entry early-termination ring, done latching within the repeat, the
TimeLimit of 1000 inner steps, then the frame, its preprocessing and the
frame stack.  On the card a step is two kernels: B13a
(``kernels/carracing_step.py``: the 8 substeps) and B12
(``kernels/carracing_render.py``: the frame into the stack); their plain
twins here (``step_dynamics_plain``, ``stack_frames_plain``) are what the
CPU runs.  ``sparse_rewards`` (the goal bins of REPAIRED's CarRacing) and
``clip_reward`` are branches of the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...kernels import carracing_render, carracing_step
from ..walker.env import tree_where
from .bezier import f32
from .dynamics import CarState, car_step, init_car, wheel_positions
from .track import (
    FPS, PLAYFIELD, STATE_H, STATE_W, Track, on_road, recip, render_frame,
    tree_sum,
)

HISTORY = 100


@dataclasses.dataclass(frozen=True)
class CarRacingConfig:
    max_inner_steps: int = 1000      # TimeLimit (registration)
    num_action_repeat: int = 8
    frame_stack: int = 4
    grayscale: bool = False
    crop: bool = False
    reward_shaping: bool = True
    playfield: float = PLAYFIELD
    sparse_rewards: bool = False
    num_goal_bins: int = 24
    clip_reward: Optional[float] = None

    @property
    def obs_hw(self):
        return (84, 84) if self.crop else (STATE_H, STATE_W)

    @property
    def obs_channels(self):
        return (1 if self.grayscale else 3) * self.frame_stack


@dataclasses.dataclass(frozen=True)
class CarRacingState:
    car: CarState
    track: Track
    visited: torch.Tensor             # (N, P) bool
    tile_visited_count: torch.Tensor  # (N,) int32
    reward_total: torch.Tensor        # (N,) env cumulative reward
    prev_reward: torch.Tensor         # (N,)
    t: torch.Tensor                   # (N,) sim time (s)
    inner_steps: torch.Tensor         # (N,) int32
    reward_history: torch.Tensor      # (N, 100) shaped-reward ring
    hist_ptr: torch.Tensor            # (N,) int32
    frames: torch.Tensor              # (N, H, W, C·stack) float32
    done_latch: torch.Tensor          # (N,) bool
    goal_bin: torch.Tensor            # (N,) int32; -1 = dense rewards
    goal_reached: torch.Tensor        # (N,) bool
    sparse_accum: torch.Tensor        # (N,) hidden accumulated reward
    control_points: torch.Tensor      # (N, 28) encoded level
    level_seed: torch.Tensor          # (N,) int32

    def replace(self, **kw) -> 'CarRacingState':
        return dataclasses.replace(self, **kw)

    def where(self, mask: torch.Tensor, other: 'CarRacingState'
              ) -> 'CarRacingState':
        """Per car: this state where ``mask`` (N,) is True, else
        ``other``."""
        return tree_where(mask, self, other)


# ---- B12's twin: the frame, preprocessed, into the stack -------------------

GRAY = (f32(0.299), f32(0.587), f32(0.114))


def preprocess(cfg: CarRacingConfig, frame_u8: torch.Tensor) -> torch.Tensor:
    """Crop, grayscale and scale (car_racing_wrappers.py:59-70; JAX
    env.py:89-97): uint8 (N, 96, 96, 3) → float32 (N, h, w, c)."""
    obs = frame_u8.float()
    if cfg.crop:
        obs = obs[:, :-12, 6:-6]
    if cfg.grayscale:
        obs = ((obs[..., 0] * GRAY[0] + obs[..., 1] * GRAY[1])
               + obs[..., 2] * GRAY[2])[..., None]
    return obs * recip(128.0) - 1.0


def stack_frames_plain(cfg: CarRacingConfig, car: CarState, track: Track,
                       t: torch.Tensor, frames: torch.Tensor = None
                       ) -> torch.Tensor:
    """Kernel B12's twin: the new frame after the stack's older frames
    (JAX env.py:296-298), or replicated over the whole stack when
    ``frames`` is None (a reset, JAX env.py:180-182)."""
    obs = preprocess(cfg, render_frame(track, car, t))
    if frames is None:
        return torch.cat([obs] * cfg.frame_stack, -1)
    return torch.cat([frames[..., obs.shape[-1]:], obs], -1)


# ---- B13a's twin: 8 substeps -----------------------------------------------

def goal_eval(track: Track, new: torch.Tensor, goal_bin: torch.Tensor,
              num_goal_bins: int) -> torch.Tensor:
    """Whether a newly visited tile (``new`` (N, P)) lands in the goal bin
    (FrictionDetector._eval_tile_index; JAX env.py:120-139)."""
    n = track.n_points.float()[:, None]
    goal_step = n * recip(num_goal_bins)
    idx = torch.arange(track.capacity, dtype=torch.float32,
                       device=n.device)[None]
    distance = n - idx
    tile_bin = torch.floor(distance / goal_step.clamp(min=1e-6))
    gb = goal_bin[:, None]
    force_false = (((gb == 0) & (distance < 10))
                   | ((gb == num_goal_bins - 1) & (idx < 10)))
    reach = (tile_bin == gb.float()) & ~force_false & track.valid
    return (new & reach).any(1)


def visit_tiles(track: Track, visited: torch.Tensor, car: CarState):
    """Wheel-tile contacts (JAX env.py:108-117) → (visited, newly visited
    count (N,), new-tile mask (N, P))."""
    wx, wy = wheel_positions(car)
    road, idx = on_road(track, wx, wy)
    hits = torch.zeros_like(visited, dtype=torch.float32).scatter_reduce(
        1, idx, road.float(), 'amax') > 0
    new = hits & ~visited
    return visited | new, new.sum(1).int(), new


def step_dynamics_plain(cfg: CarRacingConfig, state: CarRacingState,
                        action: torch.Tensor):
    """Kernel B13a's twin (JAX env.py:186-291): the action (N, 3) =
    (steer, gas, brake) repeated for ``num_action_repeat`` substeps → (state
    with the old frames, summed shaped reward (N,), done (N,), truncated
    (N,))."""
    track = state.track
    steer, gas, brake = -action[:, 0], action[:, 1], action[:, 2]
    car, visited = state.car, state.visited
    count, reward_total = state.tile_visited_count, state.reward_total
    prev_reward, t, steps = state.prev_reward, state.t, state.inner_steps
    hist, ptr, done = state.reward_history, state.hist_ptr, state.done_latch
    goal_reached, sparse_accum = state.goal_reached, state.sparse_accum
    n_track = track.n_points.clamp(min=1).float()
    tile_reward = torch.full_like(n_track, 1000.0) / n_track
    rows = torch.arange(action.shape[0], device=action.device)
    shaped_sum = None
    for _ in range(cfg.num_action_repeat):
        wx, wy = wheel_positions(car)
        car2 = car_step(car, steer, gas, brake, on_road(track, wx, wy)[0])
        visited2, n_new, new = visit_tiles(track, visited, car2)
        t2 = t + f32(1.0 / FPS)
        steps2 = steps + 1
        reward_total2 = (reward_total - 0.1) + tile_reward * n_new
        step_reward = reward_total2 - prev_reward
        all_visited = visited2.sum(1) >= track.n_points
        off_field = (car2.pos.abs() > cfg.playfield).any(1)
        die = all_visited | off_field
        step_reward = torch.where(off_field,
                                  torch.full_like(step_reward, -100.0),
                                  step_reward)
        if cfg.sparse_rewards:
            reached = goal_eval(track, new, state.goal_bin,
                                cfg.num_goal_bins)
            goal_reached2 = goal_reached | reached
            sparse_accum2 = sparse_accum + step_reward
            zero = torch.zeros_like(step_reward)
            step_reward = torch.where(goal_reached2, sparse_accum2, zero)
            sparse_accum2 = torch.where(goal_reached2, zero, sparse_accum2)
            die = die | goal_reached2
        else:
            goal_reached2, sparse_accum2 = goal_reached, sparse_accum
        if cfg.clip_reward is not None:
            step_reward = step_reward.clamp(-cfg.clip_reward,
                                            cfg.clip_reward)
        shaped = step_reward
        if cfg.reward_shaping:
            zero = torch.zeros_like(shaped)
            shaped = shaped + torch.where(die & ~off_field,
                                          torch.full_like(shaped, 100.0),
                                          zero)
            hull_off = ~on_road(track, car2.pos[:, :1], car2.pos[:, 1:])[0][:, 0]
            shaped = shaped - torch.where(hull_off,
                                          torch.full_like(shaped, 0.05), zero)
            slot = (ptr % HISTORY).long()
            old = hist[rows, slot]
            hist2 = hist.clone()
            hist2[rows, slot] = torch.where(done, old, shaped)
            ptr2 = torch.where(done, ptr, ptr + 1)
            early = tree_sum(hist2) * recip(HISTORY) <= -0.1
        else:
            hist2, ptr2 = hist, ptr
            early = torch.zeros_like(done)
        new_done = done | die | early
        car2 = tree_where(done, car, car2)
        visited2 = torch.where(done[:, None], visited, visited2)
        reward_total2 = torch.where(done, reward_total, reward_total2)
        shaped = torch.where(done, torch.zeros_like(shaped), shaped)
        prev2 = torch.where(done, prev_reward, reward_total2)
        t2 = torch.where(done, t, t2)
        steps2 = torch.where(done, steps, steps2)
        goal_reached2 = torch.where(done, goal_reached, goal_reached2)
        sparse_accum2 = torch.where(done, sparse_accum, sparse_accum2)
        count = count + torch.where(done, torch.zeros_like(n_new), n_new)
        (car, visited, reward_total, prev_reward, t, steps, hist, ptr, done,
         goal_reached, sparse_accum) = (
            car2, visited2, reward_total2, prev2, t2, steps2, hist2, ptr2,
            new_done, goal_reached2, sparse_accum2)
        shaped_sum = shaped if shaped_sum is None else shaped_sum + shaped
    timeout = steps >= cfg.max_inner_steps
    state = state.replace(
        car=car, visited=visited, tile_visited_count=count,
        reward_total=reward_total, prev_reward=prev_reward, t=t,
        inner_steps=steps, reward_history=hist, hist_ptr=ptr,
        done_latch=done, goal_reached=goal_reached,
        sparse_accum=sparse_accum)
    return state, shaped_sum, done | timeout, timeout & ~done


def step(cfg: CarRacingConfig, state: CarRacingState, action: torch.Tensor):
    """→ (state, frames, reward, done, truncated): kernels B13a and B12 on
    CUDA tensors, the twins on CPU tensors."""
    state, reward, done, truncated = carracing_step.step(cfg, state, action)
    frames = carracing_render.render(cfg, state.car, state.track, state.t,
                                     state.frames)
    return state.replace(frames=frames), frames, reward, done, truncated


def fresh_state(cfg: CarRacingConfig, track: Track, car: CarState,
                control_points: torch.Tensor, level_seed: torch.Tensor,
                goal_bin: torch.Tensor):
    """N fresh states on built tracks, the car at its start (JAX
    env.py:145-184) → (state, frames), the first frame replicated over the
    stack."""
    n, dev = control_points.shape[0], control_points.device
    z = torch.zeros((n,), device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    frames = carracing_render.render(cfg, car, track, z)
    state = CarRacingState(
        car=car, track=track,
        visited=torch.zeros((n, track.capacity), dtype=torch.bool,
                            device=dev),
        tile_visited_count=zi, reward_total=z, prev_reward=z, t=z,
        inner_steps=zi, reward_history=torch.zeros((n, HISTORY), device=dev),
        hist_ptr=zi, frames=frames, done_latch=zb,
        goal_bin=goal_bin.int(), goal_reached=zb, sparse_accum=z,
        control_points=control_points, level_seed=level_seed.int())
    return state, frames


def start_car(track: Track, start_idx: torch.Tensor) -> CarState:
    """The car at rest on tile ``start_idx`` facing its normal angle."""
    rows = torch.arange(start_idx.shape[0], device=start_idx.device)
    i = start_idx.long()
    p = track.points[rows, i]
    return init_car(track.beta[rows, i], p[:, 0], p[:, 1])
