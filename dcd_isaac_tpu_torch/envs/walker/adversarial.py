"""Adversarial (UED) BipedalWalker environment, batched PyTorch port.

Port of ``dcd_isaac_tpu/envs/walker/adversarial.py:26-227`` for the
methods the DR, PLR⊥ and ACCEL paths use: ``reset_random``,
``reset_to_level``, ``get_level``, ``reset_agent``, ``mutate_level`` and
``step``.  A level is (9,) float32: the 8 params and the seed's value.
Every method takes and returns a batch of N walkers; the observations are
``{'obs': (N, 24)}``.  Building a level is kernel B11 and every step
kernel B10 (``env.py``).  The random draws are uniforms from a
``torch.Generator``; the ``draws`` arguments replace them (the parity
tests inject them).  The teacher's construction (``reset``,
``step_adversary``) and ``reset_alp_gmm`` wait for their slices: the
walker teacher and ALP-GMM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..seeds import draw_seed, f32_to_seed, seed_to_f32
from .env import WalkerState, reset_walker, step_walker
from .terrain import randint_range, uniform_range

# (lo, hi) per design dimension (adversarial.py:54-63)
PARAM_RANGES_FULL = np.array([
    [0.0, 10.0], [0.0, 10.0], [0.0, 10.0], [0.0, 5.0],
    [0.0, 5.0], [0.0, 5.0], [0.0, 5.0], [1.0, 9.0],
])
PARAM_RANGES_EASY = np.array([
    [0.0, 0.6], [0.0, 0.0], [0.8, 0.8], [0.0, 0.0],
    [0.4, 0.4], [0.0, 0.0], [0.4, 0.4], [1.0, 1.0],
])
# mutation deltas (adversarial.py:66-75): scalar delta or uniform range
PARAM_MUT_LO = np.array([0.0, 0.4, 0.4, 0.2, 0.2, 0.2, 0.2, 1.0])
PARAM_MUT_HI = np.array([0.6, 0.4, 0.4, 0.2, 0.2, 0.2, 0.2, 1.0])


@dataclasses.dataclass(frozen=True)
class WalkerParams:
    mode: str = 'full'        # 'full' | 'easy'
    poet: bool = False
    max_steps: int = 2000
    random_z_dim: int = 10


def mutate_draws(num_edits: int) -> int:
    """Uniforms ``mutate_level`` takes a level: (which param, direction,
    magnitude) per edit, then the new seed."""
    return 3 * num_edits + 1


class AdversarialWalker:
    """Functional UED walker env over a batch of N levels."""

    adversary_discrete = False
    level_dtype = torch.float32

    def __init__(self, params: Optional[WalkerParams] = None, **kwargs):
        self.params = params or WalkerParams(**kwargs)

    @property
    def obs_shapes(self):
        return (24,)

    @property
    def num_actions(self) -> int:
        return 4  # continuous dims

    @property
    def level_shape(self) -> tuple:
        return (9,)

    @property
    def max_episode_steps(self) -> int:
        return self.params.max_steps

    def _ranges(self, device) -> torch.Tensor:
        r = (PARAM_RANGES_EASY if self.params.mode == 'easy'
             else PARAM_RANGES_FULL)
        return torch.tensor(r, dtype=torch.float32, device=device)

    def _poet_mask(self, params: torch.Tensor) -> torch.Tensor:
        if self.params.poet:       # POET: the first 5 dims, no stairs
            params = params.clone()
            params[:, 5:] = 0.0
        return params

    def _fresh_state(self, params, seeds):
        state, obs = reset_walker(self._poet_mask(params), seeds)
        return state, {'obs': obs}

    def reset_agent(self, state: WalkerState):
        """Every walker back to its level's start (adversarial.py:162)."""
        return self._fresh_state(state.level_params, state.level_seed)

    def reset_random(self, n: int, generator: torch.Generator = None,
                     device=None, draws: Optional[torch.Tensor] = None):
        """N levels uniform over the env's ranges (adversarial.py:166-174):
        ``draws`` (N, 9) are the 8 params' uniforms and the seed's."""
        if draws is None:
            device = device if device is not None else generator.device
            draws = torch.rand((n, 9), generator=generator, device=device)
        r = self._ranges(draws.device)
        params = draws[:, :8] * (r[:, 1] - r[:, 0]) + r[:, 0]
        return self._fresh_state(params, draw_seed(n, u=draws[:, 8]))

    def reset_to_level(self, levels: torch.Tensor):
        """N states from (N, 9) level encodings (adversarial.py:187)."""
        return self._fresh_state(levels[:, :8].contiguous(),
                                 f32_to_seed(levels[:, 8]))

    def get_level(self, state: WalkerState) -> torch.Tensor:
        """(N, 9) float32: params and the seed's value."""
        return torch.cat([state.level_params,
                          seed_to_f32(state.level_seed)[:, None]], 1)

    def mutate_level(self, state: WalkerState, num_edits: int,
                     generator: torch.Generator = None,
                     draws: Optional[torch.Tensor] = None):
        """ACCEL's edit (adversarial.py:198-219): ``num_edits`` times a
        param (of the first 5 under POET) moves by -1, 0 or +1 times its
        delta, clipped to the full range; then a new seed.  ``draws`` are
        (N, 3 num_edits + 1) uniforms (:func:`mutate_draws`)."""
        n, dev = state.level_params.shape[0], state.level_params.device
        if draws is None:
            draws = torch.rand((n, mutate_draws(num_edits)),
                               generator=generator, device=dev)
        n_mut = 5 if self.params.poet else 8
        lo_t = torch.tensor(PARAM_MUT_LO, dtype=torch.float32, device=dev)
        hi_t = torch.maximum(
            torch.tensor(PARAM_MUT_HI, dtype=torch.float32, device=dev),
            lo_t + 1e-9)
        full = torch.tensor(PARAM_RANGES_FULL, dtype=torch.float32,
                            device=dev)
        rows = torch.arange(n, device=dev)
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        params = state.level_params.clone()
        for e in range(num_edits):
            u = draws[:, 3 * e:3 * e + 3]
            a = randint_range(u[:, 0], zero, zero + n_mut).long()
            d = randint_range(u[:, 1], zero, zero + 3) - 1
            mag = uniform_range(u[:, 2], lo_t[a], hi_t[a])
            new = params[rows, a] + d.float() * mag
            params[rows, a] = torch.minimum(torch.maximum(new, full[a, 0]),
                                            full[a, 1])
        return self._fresh_state(params,
                                 draw_seed(n, u=draws[:, 3 * num_edits]))

    def step(self, state: WalkerState, action: torch.Tensor):
        """→ (state, obs, reward, done, info) with ``info['truncated']``
        at the step limit."""
        state, obs, reward, env_done, _ = step_walker(state, action)
        timeout = state.step_count >= self.params.max_steps
        done = env_done | timeout
        return (state, {'obs': obs}, reward, done,
                {'truncated': timeout & ~env_done})

    def solvable(self, state: WalkerState) -> None:
        """None: every walker level counts as solvable (JAX runner
        :629-632)."""
        return None

    def env_stats(self, state: WalkerState, max_return) -> dict:
        """The levels' stats for the log (JAX runner :847-854)."""
        p = state.level_params
        return {
            'ground_roughness': p[:, 0].mean(),
            'pit_gap_high': torch.maximum(p[:, 1], p[:, 2]).mean(),
            'stump_height_high': torch.maximum(p[:, 3], p[:, 4]).mean(),
            'stair_height_high': torch.maximum(p[:, 5], p[:, 6]).mean(),
        }


def make_walker_env(env_name: str) -> AdversarialWalker:
    return AdversarialWalker(WalkerParams(
        mode='easy' if 'Easy' in env_name else 'full',
        poet='POET' in env_name))
