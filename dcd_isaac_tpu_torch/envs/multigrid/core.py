"""Batched MultiGrid engine in PyTorch.

Port of ``dcd_isaac_tpu/envs/multigrid/core.py``.  The state is one batch of
N envs: a (N, W, H) uint8 grid of MiniGrid cell codes indexed ``[x, y]``
(``flat = x * H + y``, the JAX layout) and small int32/bool fields, so every
function works on the whole batch at once instead of under ``vmap``.  The
agent step and the view gather are kernel 1 (``kernels/multigrid_step.py``);
the rest is plain PyTorch on the state's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ...kernels.multigrid_step import multigrid_obs, multigrid_step
from .constants import AGENT, EMPTY, GOAL, TYPE_COLOR, UNSEEN, WALL


@dataclasses.dataclass(frozen=True)
class MultiGridParams:
    """Static configuration (copy of the JAX package's)."""
    size: int = 15
    agent_view_size: int = 5
    max_steps: int = 250
    see_through_walls: bool = True
    n_clutter: int = 50
    resample_n_clutter: bool = False
    choose_goal_last: bool = False
    goal_noise: float = 0.0
    random_z_dim: int = 50
    editor_actions: str = 'walls_none_agent_goal'
    full_obs: bool = False

    @property
    def width(self) -> int:
        return self.size

    @property
    def height(self) -> int:
        return self.size

    @property
    def adversary_max_steps(self) -> int:
        return self.n_clutter + 2

    @property
    def adversary_action_dim(self) -> int:
        return (self.size - 2) ** 2

    @property
    def max_shortest_path(self) -> int:
        return (self.size - 2) * (self.size - 2) + 1


@dataclasses.dataclass(frozen=True)
class MultiGridState:
    """Dynamic state of N envs; every field has the batch as dim 0."""
    grid: torch.Tensor                  # (N, W, H) uint8, no agent overlay
    agent_pos: torch.Tensor             # (N, 2) int32; (-1, -1) unplaced
    agent_dir: torch.Tensor             # (N,) int32
    agent_done: torch.Tensor            # (N,) bool
    step_count: torch.Tensor            # (N,) int32
    agent_start_pos: torch.Tensor       # (N, 2) int32
    agent_start_dir: torch.Tensor       # (N,) int32
    goal_pos: torch.Tensor              # (N, 2) int32
    adv_step_count: torch.Tensor        # (N,) int32
    n_clutter_placed: torch.Tensor      # (N,) int32
    passable: torch.Tensor              # (N,) bool
    shortest_path_length: torch.Tensor  # (N,) int32
    distance_to_goal: torch.Tensor      # (N,) int32

    def replace(self, **kw) -> 'MultiGridState':
        return dataclasses.replace(self, **kw)

    def where(self, mask: torch.Tensor, other: 'MultiGridState'
              ) -> 'MultiGridState':
        """Per env: this state where ``mask`` (N,) is True, else ``other``."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            out[f.name] = torch.where(m, a, b)
        return MultiGridState(**out)


def empty_grid(params: MultiGridParams, n: int, device) -> torch.Tensor:
    """(N, W, H) interior-empty grids with the surrounding wall rectangle."""
    grid = torch.full((n, params.width, params.height), EMPTY,
                      dtype=torch.uint8, device=device)
    grid[:, 0, :] = WALL
    grid[:, -1, :] = WALL
    grid[:, :, 0] = WALL
    grid[:, :, -1] = WALL
    return grid


def init_state(params: MultiGridParams, n: int, device) -> MultiGridState:
    i32 = dict(dtype=torch.int32, device=device)
    neg = torch.full((n, 2), -1, **i32)
    zero = torch.zeros((n,), **i32)
    return MultiGridState(
        grid=empty_grid(params, n, device),
        agent_pos=neg,
        agent_dir=zero,
        agent_done=torch.zeros((n,), dtype=torch.bool, device=device),
        step_count=zero,
        agent_start_pos=neg,
        agent_start_dir=zero,
        goal_pos=neg,
        adv_step_count=zero,
        n_clutter_placed=zero,
        passable=torch.zeros((n,), dtype=torch.bool, device=device),
        shortest_path_length=torch.full((n,), params.max_shortest_path, **i32),
        distance_to_goal=torch.full((n,), -1, **i32),
    )


def sample_cell_from_mask(mask: torch.Tensor, generator: torch.Generator
                          ) -> torch.Tensor:
    """Uniformly sample an (x, y) cell where ``mask`` (N, W, H) is True.

    Draws one uniform number per env and takes that quantile of the env's
    True cells in flat order (core.py:140-152 draws with a categorical; the
    distribution is the same, the random stream is not).  An empty mask
    gives cell (0, 0).  Returns (N, 2) int32.
    """
    n, _, h = mask.shape
    flat = mask.reshape(n, -1)
    count = flat.sum(1)
    u = torch.rand((n,), generator=generator, device=mask.device)
    k = torch.minimum((u * count).long(), (count - 1).clamp(min=0))
    idx = (flat.cumsum(1) > k[:, None]).int().argmax(1)
    idx = torch.where(count > 0, idx, torch.zeros_like(idx))
    return torch.stack([idx // h, idx % h], 1).int()


def encode_grid(state: MultiGridState) -> torch.Tensor:
    """(N, W, H, 3) uint8 encoding with the agent overlay (core.py:158)."""
    types = state.grid
    colors = torch.tensor(TYPE_COLOR, device=types.device)[types.long()]
    enc = torch.stack([types, colors, torch.zeros_like(types)], -1)
    n = types.shape[0]
    has_agent = state.agent_pos[:, 0] >= 0
    x = state.agent_pos[:, 0].clamp(min=0).long()
    y = state.agent_pos[:, 1].clamp(min=0).long()
    rows = torch.arange(n, device=types.device)
    code = torch.stack([torch.full_like(state.agent_dir, AGENT),
                        torch.zeros_like(state.agent_dir),
                        state.agent_dir], -1).to(torch.uint8)
    enc[rows, x, y] = torch.where(has_agent[:, None], code, enc[rows, x, y])
    return enc


def decode_grid(encoding: torch.Tensor):
    """Invert :func:`encode_grid` → (grid, agent_pos, agent_dir, goal)."""
    types = encoding[..., 0]
    n, _, h = types.shape

    def find(code):
        hit = (types == code).reshape(n, -1)
        any_hit = hit.any(1)
        flat = hit.int().argmax(1)
        pos = torch.stack([flat // h, flat % h], 1)
        return torch.where(any_hit[:, None], pos,
                           torch.full_like(pos, -1)).int(), any_hit

    agent_pos, has_agent = find(AGENT)
    goal_pos, _ = find(GOAL)
    rows = torch.arange(n, device=types.device)
    ax = agent_pos[:, 0].clamp(min=0).long()
    ay = agent_pos[:, 1].clamp(min=0).long()
    agent_dir = torch.where(has_agent, encoding[rows, ax, ay, 2].int(),
                            torch.zeros_like(agent_pos[:, 0]))
    grid = torch.where(types == AGENT, torch.full_like(types, EMPTY), types)
    grid = torch.where(grid == UNSEEN, torch.full_like(grid, EMPTY), grid)
    return grid.contiguous(), agent_pos, agent_dir, goal_pos


def gen_obs(state: MultiGridState, params: MultiGridParams) -> dict:
    """{'image': (N, v, v, 3) uint8, 'direction': (N,) int32} (core.py:265)."""
    image = multigrid_obs(state.grid, state.agent_pos, state.agent_dir,
                          params.agent_view_size, params.see_through_walls)
    return {'image': image, 'direction': state.agent_dir}


def step_agent(state: MultiGridState, action: torch.Tensor,
               params: MultiGridParams):
    """One step of every env → (state, obs, reward, done, truncated).

    core.py:step_agent with gen_obs, plus AdversarialMultiGrid.step's
    ``truncated`` (done by the step budget, not by goal or lava).
    """
    pos, d, step, agent_done, image, reward, done, truncated = multigrid_step(
        state.grid, state.agent_pos, state.agent_dir, state.step_count,
        state.agent_done, action.to(torch.int32).contiguous(),
        params.agent_view_size, params.max_steps, params.see_through_walls)
    state = state.replace(agent_pos=pos, agent_dir=d, step_count=step,
                          agent_done=agent_done)
    return state, {'image': image, 'direction': d}, reward, done, truncated


def reset_agent(state: MultiGridState, params: MultiGridParams
                ) -> Tuple[MultiGridState, dict]:
    """Agents back to their start, levels kept (core.py:349)."""
    state = state.replace(
        agent_pos=state.agent_start_pos,
        agent_dir=state.agent_start_dir,
        agent_done=torch.zeros_like(state.agent_done),
        step_count=torch.zeros_like(state.step_count),
    )
    return state, gen_obs(state, params)


# How many relaxation sweeps run between two checks for the fixed point; the
# check reads a flag on the host, and extra sweeps at the fixed point change
# nothing.
_BFS_SWEEPS_PER_CHECK = 8


def shortest_path(grid: torch.Tensor, start: torch.Tensor, goal: torch.Tensor,
                  params: MultiGridParams):
    """(passable, shortest_path_length) of each level (core.py:369-411).

    4-neighbour min-relaxation of the distance from ``start`` over open
    cells, iterated over the whole batch until no level changes.
    """
    inf = params.max_shortest_path
    n = grid.shape[0]
    open_mask = grid != WALL
    valid = (start[:, 0] >= 0) & (goal[:, 0] >= 0)
    rows = torch.arange(n, device=grid.device)
    dist = torch.full(grid.shape, inf, dtype=torch.int32, device=grid.device)
    dist[rows, start[:, 0].clamp(min=0).long(),
         start[:, 1].clamp(min=0).long()] = 0
    dist = torch.where(open_mask, dist, torch.full_like(dist, inf))
    full = torch.full_like(dist, inf)
    while True:
        before = dist
        for _ in range(_BFS_SWEEPS_PER_CHECK):
            nbr = torch.minimum(
                torch.minimum(
                    torch.cat([full[:, :, :1], dist[:, :, :-1]], 2),
                    torch.cat([dist[:, :, 1:], full[:, :, :1]], 2)),
                torch.minimum(
                    torch.cat([full[:, :1], dist[:, :-1]], 1),
                    torch.cat([dist[:, 1:], full[:, :1]], 1)))
            new = torch.minimum(dist, (nbr + 1).clamp(max=inf))
            dist = torch.where(open_mask, new, full)
        if not bool((dist != before).any()):
            break
    d = dist[rows, goal[:, 0].clamp(min=0).long(),
             goal[:, 1].clamp(min=0).long()]
    passable = valid & (d < inf)
    spl = torch.where(passable, d, torch.full_like(d, inf))
    return passable, spl


def compute_metrics(state: MultiGridState, params: MultiGridParams
                    ) -> MultiGridState:
    """Passability, shortest path and Manhattan distance (core.py:414)."""
    passable, spl = shortest_path(
        state.grid, state.agent_start_pos, state.goal_pos, params)
    dist = (state.goal_pos - state.agent_start_pos).abs().sum(1)
    has_both = (state.agent_start_pos[:, 0] >= 0) & (state.goal_pos[:, 0] >= 0)
    return state.replace(
        passable=passable,
        shortest_path_length=spl,
        distance_to_goal=torch.where(has_both, dist,
                                     torch.full_like(dist, -1)).int(),
    )
