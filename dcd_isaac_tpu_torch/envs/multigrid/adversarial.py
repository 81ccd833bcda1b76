"""Adversarial (UED) MultiGrid environment, batched PyTorch port.

Port of ``dcd_isaac_tpu/envs/multigrid/adversarial.py``: the teacher's
construction (``reset``, ``step_adversary``), ``reset_random``,
``get_level``, ``reset_to_level``, ``reset_agent`` and ``step``.  Every
method takes and returns a batch of N envs.  ``step_adversary`` is kernel
B5 (``kernels/multigrid_adversary.py``).  The random draws of the
construction come from a ``torch.Generator``; the ``draws`` arguments
replace them (the parity tests inject them).  ``mutate_level`` and
``reset_alp_gmm`` come with the slices that need them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels import multigrid_adversary
from .constants import EMPTY, GOAL, WALL
from .core import (
    MultiGridParams, MultiGridState, compute_metrics, decode_grid,
    encode_grid, init_state, reset_agent, sample_cell_from_mask, step_agent,
)


class AdversarialMultiGrid:
    """Functional UED MultiGrid env over a batch of N levels."""

    def __init__(self, params: Optional[MultiGridParams] = None, **kwargs):
        self.params = params or MultiGridParams(**kwargs)

    @property
    def num_actions(self) -> int:
        return 7

    @property
    def adversary_num_actions(self) -> int:
        return self.params.adversary_action_dim

    @property
    def adversary_rollout_steps(self) -> int:
        return self.params.adversary_max_steps

    @property
    def adversary_obs_shapes(self) -> dict:
        p = self.params
        return {'image': (p.width, p.height, 3), 'time_step': (),
                'random_z': (p.random_z_dim,)}

    def _adversary_obs(self, state: MultiGridState, image: torch.Tensor,
                       random_z: torch.Tensor) -> dict:
        return {'image': image, 'time_step': state.adv_step_count,
                'random_z': random_z}

    def _random_z(self, n, generator, device, draws):
        if draws is not None and 'random_z' in draws:
            return draws['random_z'].to(device=device, dtype=torch.float32)
        return torch.rand((n, self.params.random_z_dim), generator=generator,
                          device=device)

    def reset(self, n: int, generator: torch.Generator = None, device=None,
              draws: Optional[dict] = None):
        """N empty grids ready for construction (adversarial.py:93-100).

        A random start direction and ``random_z`` per level, drawn from
        ``generator`` unless ``draws`` gives ``start_dir`` (N,) and
        ``random_z`` (N, random_z_dim).  Returns (state, adversary obs).
        """
        draws = draws or {}
        device = torch.device(device if device is not None
                              else generator.device)
        if 'start_dir' in draws:
            start_dir = draws['start_dir'].to(device=device,
                                              dtype=torch.int32)
        else:
            start_dir = torch.randint(0, 4, (n,), generator=generator,
                                      device=device, dtype=torch.int32)
        state = init_state(self.params, n, device).replace(
            agent_start_dir=start_dir)
        random_z = self._random_z(n, generator, device, draws)
        return state, self._adversary_obs(state, encode_grid(state),
                                          random_z)

    def step_adversary(self, state: MultiGridState, loc: torch.Tensor,
                       generator: torch.Generator = None,
                       draws: Optional[dict] = None):
        """One construction move of every level → (state, obs, done).

        ``loc`` (N,) indexes the interior cells (adversarial.py:102-204).
        The draws (``u`` (N, 3): the noisy goal's coin and cell, the
        agent's cell when it lands on the goal; ``random_z`` of the next
        obs) come from ``generator`` unless ``draws`` gives them.
        """
        draws = draws or {}
        n = state.grid.shape[0]
        dev = state.grid.device
        u = draws.get('u')
        if u is None:
            u = torch.rand((n, 3), generator=generator, device=dev)
        out = multigrid_adversary.step(
            state, loc.to(torch.int32).contiguous(),
            u.to(dev, torch.float32).contiguous(), self.params)
        state = state.replace(
            **{k: out[k] for k in multigrid_adversary.STATE_OUT})
        random_z = self._random_z(n, generator, dev, draws)
        return (state, self._adversary_obs(state, out['image'], random_z),
                out['done'])

    def reset_random(self, n: int, generator: torch.Generator, device=None):
        """N domain-randomized levels (adversarial.py:206-257).

        Goal, then agent, uniform over empty cells; then ``n_clutter // 2``
        walls (U[0, n_clutter) in variable-block mode), one at a time, each
        on an empty cell other than the agent's.
        """
        p = self.params
        device = device if device is not None else generator.device
        state = init_state(p, n, device)
        grid = state.grid
        rows = torch.arange(n, device=device)

        goal = sample_cell_from_mask(grid == EMPTY, generator)
        grid[rows, goal[:, 0].long(), goal[:, 1].long()] = GOAL
        agent = sample_cell_from_mask(grid == EMPTY, generator)
        agent_dir = torch.randint(0, 4, (n,), generator=generator,
                                  device=device, dtype=torch.int32)
        if p.resample_n_clutter:
            n_walls = torch.randint(0, max(p.n_clutter, 1), (n,),
                                    generator=generator, device=device)
        else:
            n_walls = torch.full((n,), p.n_clutter // 2, device=device)
        max_walls = max(p.n_clutter // 2,
                        p.n_clutter if p.resample_n_clutter else 0)

        ax, ay = agent[:, 0].long(), agent[:, 1].long()
        placed = torch.zeros((n,), dtype=torch.int32, device=device)
        for i in range(max_walls):
            mask = grid == EMPTY
            mask[rows, ax, ay] = False
            pos = sample_cell_from_mask(mask, generator)
            do = (i < n_walls) & mask.flatten(1).any(1)
            px, py = pos[:, 0].long(), pos[:, 1].long()
            grid[rows, px, py] = torch.where(
                do, torch.full_like(grid[rows, px, py], WALL),
                grid[rows, px, py])
            placed += do.int()

        state = state.replace(
            grid=grid, goal_pos=goal, agent_start_pos=agent,
            agent_start_dir=agent_dir, n_clutter_placed=placed,
            adv_step_count=torch.full_like(placed, p.adversary_max_steps))
        state = compute_metrics(state, p)
        return reset_agent(state, p)

    def get_level(self, state: MultiGridState) -> torch.Tensor:
        """(N, W, H, 3) start-of-episode encodings (adversarial.py:259)."""
        return encode_grid(state.replace(agent_pos=state.agent_start_pos,
                                         agent_dir=state.agent_start_dir))

    def reset_to_level(self, levels: torch.Tensor):
        """N states from (N, W, H, 3) encodings (adversarial.py:266)."""
        p = self.params
        grid, agent_pos, agent_dir, goal_pos = decode_grid(levels)
        n = grid.shape[0]
        n_walls = (grid[:, 1:-1, 1:-1] == WALL).flatten(1).sum(1).int()
        state = init_state(p, n, grid.device).replace(
            grid=grid, agent_start_pos=agent_pos, agent_start_dir=agent_dir,
            goal_pos=goal_pos, n_clutter_placed=n_walls,
            adv_step_count=torch.full_like(n_walls, p.adversary_max_steps))
        state = compute_metrics(state, p)
        return reset_agent(state, p)

    def reset_agent(self, state: MultiGridState):
        return reset_agent(state, self.params)

    def step(self, state: MultiGridState, action: torch.Tensor):
        """→ (state, obs, reward, done, info) with ``info['truncated']``."""
        state, obs, reward, done, truncated = step_agent(
            state, action, self.params)
        return state, obs, reward, done, {'truncated': truncated}
