"""Adversarial (UED) MultiGrid environment, batched PyTorch port.

Port of ``dcd_isaac_tpu/envs/multigrid/adversarial.py``: the teacher's
construction (``reset``, ``step_adversary``), ``reset_random``,
``get_level``, ``reset_to_level``, ``mutate_level``, ``reset_agent`` and
``step``.  Every method takes and returns a batch of N envs.
``step_adversary`` is kernel B5 (``kernels/multigrid_adversary.py``),
``reset_random`` and ``mutate_level`` kernel B9
(``kernels/multigrid_edit.py``).  The random draws come from a
``torch.Generator``; the ``draws`` arguments replace them (the parity
tests inject them).  ``reset_alp_gmm`` comes with the ALP-GMM slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels import multigrid_adversary, multigrid_edit
from .constants import WALL
from .core import (
    MultiGridParams, MultiGridState, compute_metrics, decode_grid,
    encode_grid, init_state, reset_agent, step_agent,
)


class AdversarialMultiGrid:
    """Functional UED MultiGrid env over a batch of N levels."""

    adversary_discrete = True
    level_dtype = torch.uint8

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
    def level_shape(self) -> tuple:
        return (self.params.width, self.params.height, 3)

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

    def reset_random(self, n: int, generator: torch.Generator = None,
                     device=None, draws: Optional[torch.Tensor] = None):
        """N domain-randomized levels (adversarial.py:206-257), kernel B9.

        Goal, then agent, uniform over empty cells; a direction; then
        ``n_clutter // 2`` walls (U[0, n_clutter) in variable-block mode),
        one at a time, each on an empty cell other than the agent's.  The
        draws are ``draws`` (N, 4 + max_walls) uniforms (layout in
        ``kernels/multigrid_edit.py``), else taken from ``generator``.
        """
        p = self.params
        if draws is None:
            device = device if device is not None else generator.device
            draws = torch.rand((n, multigrid_edit.reset_random_draws(p)),
                               generator=generator, device=device)
        grid, goal, agent, direction, placed = multigrid_edit.reset_random(
            draws.contiguous(), p)
        state = init_state(p, n, grid.device).replace(
            grid=grid, goal_pos=goal, agent_start_pos=agent,
            agent_start_dir=direction, n_clutter_placed=placed,
            adv_step_count=torch.full_like(placed, p.adversary_max_steps))
        state = compute_metrics(state, p)
        return reset_agent(state, p)

    def mutate_level(self, state: MultiGridState, num_edits: int,
                     generator: torch.Generator = None,
                     draws: Optional[torch.Tensor] = None):
        """ACCEL's edit of every level (adversarial.py:284-372), kernel B9.

        ``num_edits`` interior cells drawn with replacement each get one of
        the env's editor actions (wall, clear, goal, agent), applied in
        order; a removed goal is re-placed on a free cell other than the
        agent's, a removed agent on an empty cell; then the BFS and the
        agents' reset.  The draws are ``draws`` (N, 2 num_edits + 2)
        uniforms, else taken from ``generator``.
        """
        p = self.params
        n = state.grid.shape[0]
        if draws is None:
            draws = torch.rand((n, multigrid_edit.mutate_draws(num_edits)),
                               generator=generator, device=state.grid.device)
        grid, goal, agent, n_walls = multigrid_edit.mutate(
            state.grid, state.goal_pos, state.agent_start_pos,
            draws.contiguous(), num_edits, p.editor_actions)
        state = state.replace(
            grid=grid, goal_pos=goal, agent_start_pos=agent,
            n_clutter_placed=n_walls,
            step_count=torch.zeros_like(state.step_count),
            adv_step_count=torch.full_like(n_walls, p.adversary_max_steps))
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

    def solvable(self, state: MultiGridState) -> torch.Tensor:
        """(N,) bool: a path leads to the goal (the BFS's flag)."""
        return state.passable

    def env_stats(self, state: MultiGridState,
                  max_return: torch.Tensor) -> dict:
        """The levels' stats for the log (JAX runner
        ``_get_env_stats_multigrid``); a level counts as solved where a
        student's best return is positive."""
        solved = max_return > 0
        spl = state.shortest_path_length.float()
        return {
            'num_blocks': state.n_clutter_placed.float().mean(),
            'passable_ratio': state.passable.float().mean(),
            'shortest_path_length': spl.mean(),
            'solved_path_length': torch.where(
                solved.any(),
                (spl * solved).sum() / solved.sum().clamp(min=1),
                torch.zeros_like(spl[0])),
        }
