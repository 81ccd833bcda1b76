"""Adversarial (UED) CarRacing, batched PyTorch port of
``dcd_isaac_tpu/envs/carracing/adversarial.py`` for the methods DR, PLR
and PLR⊥ use: ``reset_random``, ``reset_to_level``, ``get_level``,
``reset_agent`` and ``step``.

A level is (28,) float32: 12 control points (x, y), their count n, the
start angle (−1: start at tile 0), the goal bin (−1: dense rewards) and
the seed's value.  Building a level's track (the ccw sort, the Bézier
samples, ``build_track``, the start tile and the car) is kernel B13b
(``kernels/carracing_track.py``); the seed takes no part in it, so a
level saved by the JAX package builds the same track here.  DR's control
points come from (N, 100, 12, 2) uniforms of a ``torch.Generator`` (the
``draws`` argument replaces them) by the JAX package's rejection rule.
Every method takes and returns a batch; observations are ``{'obs':
(N, H, W, C·stack)}``.  The teacher's construction (``reset``,
``step_adversary``) and ``mutate_level`` wait for the CarRacing-teacher
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...kernels import carracing_track
from ..seeds import draw_seed, f32_to_seed, seed_to_f32
from .bezier import (
    N_CP, TWO_PI, atan2, get_bezier_track, random_control_points, seq_sum,
)
from .env import CarRacingConfig, CarRacingState, fresh_state, start_car, step
from .track import CAPACITY, PLAYFIELD, Track, build_track

SKETCH_DIM = 10
SKETCH_RATIO = PLAYFIELD / SKETCH_DIM
LEVEL_DIM = N_CP * 2 + 4
TRIES = 100
RANDOM_DRAWS = TRIES * N_CP * 2 + 2     # control points, seed, goal bin
_TEACHER = ('the CarRacing teacher (CarRacingAdversaryNetwork: PAIRED, '
            'REPAIRED) is not ported yet; it waits for its slice')


def alpha_from_xy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Polar angle in [0, 2π) (car_racing_adversarial.py:154-159)."""
    a = atan2(y, x)
    return torch.where(a < 0, a + TWO_PI, a)


def closest_track_index(track: Track, cps: torch.Tensor, n: torch.Tensor,
                        start_alpha: torch.Tensor) -> torch.Tensor:
    """(N,) int32 tile whose polar angle around the control points' mean
    is nearest ``start_alpha``; 0 where it is unset (< 0) (JAX
    adversarial.py:46-59).  The mean sums the 12 points from the first,
    the unused ones as zeros."""
    use = (torch.arange(N_CP, device=cps.device)[None] < n[:, None])
    zero = torch.zeros_like(cps[..., 0])
    s = lambda x: seq_sum(torch.where(use, x, zero))
    nf = n.clamp(min=1).float()
    ux = s(cps[..., 0]) / nf - track.offset[:, 0]
    uy = s(cps[..., 1]) / nf - track.offset[:, 1]
    alphas = alpha_from_xy(track.points[..., 0] - ux[:, None],
                           track.points[..., 1] - uy[:, None])
    diff = torch.where(track.valid, (alphas - start_alpha[:, None]).abs(),
                       torch.full_like(alphas, float('inf')))
    idx = diff.argmin(1).int()
    return torch.where(start_alpha < 0, torch.zeros_like(idx), idx)


def bezier_track_padded(cps: torch.Tensor, n: torch.Tensor) -> Track:
    """Variable-count control points → tracks of CAPACITY points (JAX
    adversarial.py:62-86): n clipped to [3, 12]."""
    curve, valid = get_bezier_track(cps, n, CAPACITY)
    return build_track(curve, valid)


def build_level_plain(cps: torch.Tensor, n: torch.Tensor,
                      start_alpha: torch.Tensor):
    """Kernel B13b's twin: (N, 12, 2) control points, (N,) counts and
    start angles → (Track, start tile (N,), CarState at rest there)."""
    track = bezier_track_padded(cps, n)
    start = closest_track_index(track, cps, n, start_alpha)
    return track, start, start_car(track, start)


@dataclasses.dataclass(frozen=True)
class CarRacingUEDParams:
    """The env's settings; the teacher's (``random_z_dim``, ``use_skip``,
    ``choose_start_pos``) come with its slice."""
    cfg: CarRacingConfig = CarRacingConfig()


class AdversarialCarRacing:
    """Functional UED CarRacing over a batch of N levels."""

    adversary_discrete = False
    level_dtype = torch.float32

    def __init__(self, params: Optional[CarRacingUEDParams] = None,
                 **kwargs):
        self.params = params or CarRacingUEDParams(**kwargs)
        self.cfg = self.params.cfg

    @property
    def obs_shapes(self):
        h, w = self.cfg.obs_hw
        return (h, w, self.cfg.obs_channels)

    @property
    def num_actions(self) -> int:
        return 3    # steer, gas, brake (continuous)

    @property
    def level_shape(self) -> tuple:
        return (LEVEL_DIM,)

    @property
    def max_episode_steps(self) -> int:
        return self.cfg.max_inner_steps // self.cfg.num_action_repeat

    # -- levels --------------------------------------------------------------
    @staticmethod
    def make_level(cps, n, start_alpha, goal_bin, seed) -> torch.Tensor:
        """(N, 28) float32 encodings (JAX adversarial.py:174-179)."""
        return torch.cat([cps.reshape(cps.shape[0], -1).float(),
                          n.float()[:, None], start_alpha.float()[:, None],
                          goal_bin.float()[:, None],
                          seed_to_f32(seed)[:, None]], 1)

    @staticmethod
    def decode_level(level: torch.Tensor):
        """(N, 28) → cps (N, 12, 2), n, start_alpha, goal_bin, seed."""
        cps = level[:, :N_CP * 2].reshape(-1, N_CP, 2)
        n = torch.round(level[:, N_CP * 2]).int()
        start_alpha = level[:, N_CP * 2 + 1]
        goal_bin = torch.round(level[:, N_CP * 2 + 2]).int()
        seed = f32_to_seed(level[:, N_CP * 2 + 3])
        return cps, n, start_alpha, goal_bin, seed

    def _build_state(self, cps, n, start_alpha, goal_bin, seed):
        cps = cps.float().contiguous()
        track, _, car = carracing_track.build(cps, n.int().contiguous(),
                                              start_alpha.float().contiguous())
        level = self.make_level(cps, n, start_alpha, goal_bin, seed)
        state, frames = fresh_state(self.cfg, track, car, level, seed,
                                    goal_bin)
        return state, {'obs': frames}

    # -- UED protocol --------------------------------------------------------
    def reset(self, *args, **kw):
        raise NotImplementedError(_TEACHER)

    def step_adversary(self, *args, **kw):
        raise NotImplementedError(_TEACHER)

    def mutate_level(self, *args, **kw):
        raise NotImplementedError(
            'CarRacing mutate_level (ACCEL) is not ported yet: no config in '
            'train_scripts/ uses it; it waits for the CarRacing-teacher '
            'slice')

    def reset_random(self, n: int, generator: torch.Generator = None,
                     device=None, draws: Optional[torch.Tensor] = None):
        """N random Bézier levels (car_racing_bezier reset; JAX
        adversarial.py:287-299).  ``draws`` (N, RANDOM_DRAWS) uniforms: the
        (100, 12, 2) control-point trials, the seed, and the goal bin
        (used in sparse mode: 1 + floor(u · (bins − 1)))."""
        if draws is None:
            device = device if device is not None else generator.device
            draws = torch.rand((n, RANDOM_DRAWS), generator=generator,
                               device=device)
        dev = draws.device
        cps = random_control_points(
            draws[:, :RANDOM_DRAWS - 2].reshape(n, TRIES, N_CP, 2),
            scale=PLAYFIELD)
        seed = draw_seed(n, u=draws[:, RANDOM_DRAWS - 2])
        if self.cfg.sparse_rewards:
            bins = self.cfg.num_goal_bins
            goal = 1 + (draws[:, RANDOM_DRAWS - 1].double() * (bins - 1)
                        ).floor().clamp(max=bins - 2).int()
        else:
            goal = torch.full((n,), -1, dtype=torch.int32, device=dev)
        return self._build_state(
            cps, torch.full((n,), N_CP, dtype=torch.int32, device=dev),
            torch.full((n,), -1.0, device=dev), goal, seed)

    def reset_to_level(self, levels: torch.Tensor):
        """N states from (N, 28) level encodings."""
        return self._build_state(*self.decode_level(levels))

    def get_level(self, state: CarRacingState) -> torch.Tensor:
        return state.control_points

    def reset_agent(self, state: CarRacingState):
        return self.reset_to_level(state.control_points)

    def step(self, state: CarRacingState, action: torch.Tensor):
        """→ (state, obs, reward, done, info) with ``info['truncated']``
        at the TimeLimit."""
        state, frames, reward, done, truncated = step(self.cfg, state,
                                                      action)
        return state, {'obs': frames}, reward, done, {'truncated': truncated}

    def solvable(self, state: CarRacingState) -> None:
        """None: every CarRacing level counts as solvable."""
        return None

    def env_stats(self, state: CarRacingState, max_return) -> dict:
        """The tracks' polygon complexity, host-side (JAX runner
        :856-861, :1011-1017): 'track_' + area, perimeter, amplitude,
        convex, notches and complexity, as Python floats."""
        from ...utils.geo_complexity import batch_track_complexity
        tr = state.track
        stats = batch_track_complexity(tr.points.cpu().numpy(),
                                       tr.valid.cpu().numpy())
        return {'track_' + k: float(v) for k, v in stats.items()}


def make_carracing_env(env_name: str, args=None) -> AdversarialCarRacing:
    """The env of a CarRacing training name with the reference's kwargs
    (util/__init__.py:146-171; JAX adversarial.py:329-352); shaping is
    forced off in sparse mode."""
    if not ('Adversarial' in env_name
            or env_name.startswith('CarRacing-Bezier')):
        raise ValueError(env_name)
    if args is None:
        return AdversarialCarRacing()
    if getattr(args, 'use_editor', False):
        raise NotImplementedError(
            'ACCEL on CarRacing (--use_editor true: mutate_level) is not '
            'ported yet: no config in train_scripts/ uses it; it waits for '
            'the CarRacing-teacher slice')
    sparse = getattr(args, 'sparse_rewards', False)
    cfg = CarRacingConfig(
        grayscale=args.grayscale, crop=args.crop_frame,
        frame_stack=args.frame_stack,
        num_action_repeat=args.num_action_repeat,
        reward_shaping=args.reward_shaping and not sparse,
        sparse_rewards=sparse,
        num_goal_bins=getattr(args, 'num_goal_bins', 24),
        clip_reward=args.clip_reward)
    return AdversarialCarRacing(CarRacingUEDParams(cfg=cfg))
