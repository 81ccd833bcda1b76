"""Kernel B9: ACCEL's level edits and the domain-randomized levels.

Replaces ``dcd_isaac_tpu/envs/multigrid/adversarial.py:mutate_level``
(:284-372) and ``reset_random`` (:206-257), each up to its
``compute_metrics``; the BFS and the observation that follow are kernel
B5's and B1's.  The CUDA source is ``csrc/multigrid_edit.cu``: one thread
per level keeps its grid in shared memory and applies the edits, or drops
the goal, the agent and the walls, in order.  It is bound by its launch
and each thread's scans of its grid, not by its few kilobytes.

Every random choice is an input: ``u`` float32 uniforms per level, laid
out as the CUDA source's header says, turned into cells by
:func:`~.multigrid_adversary.sample_cell_from_uniform` on both sides, so
kernel and twin agree bit for bit.  ``mutate`` and ``reset_random`` take
the plain twins (``mutate_plain``, ``reset_random_plain``) for CPU tensors
and launch the kernel, or raise, for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..envs.multigrid.constants import EMPTY, GOAL, WALL
from . import _build
from .multigrid_adversary import MAX_CELLS, sample_cell_from_uniform

# EDITOR_ACTION_SPACES (adversarial.py:27-31) and the kernel's code of each.
EDITOR_ACTION_SPACES = {
    'walls_none': ('-', '.'),
    'walls_none_goal': ('-', '.', 'g'),
    'walls_none_agent_goal': ('-', '.', 'a', 'g'),
}
_ACTION_SET = {'walls_none': 0, 'walls_none_goal': 1,
               'walls_none_agent_goal': 2}


def mutate_draws(num_edits: int) -> int:
    """Uniforms per level of :func:`mutate`."""
    return 2 * num_edits + 2


def reset_random_draws(params) -> int:
    """Uniforms per level of :func:`reset_random`."""
    return 4 + max_walls(params)


def max_walls(params) -> int:
    return max(params.n_clutter // 2,
               params.n_clutter if params.resample_n_clutter else 0)


def _scaled(u, n: int) -> torch.Tensor:
    """min(trunc(u * n), n - 1) as int64."""
    return (u * n).long().clamp(max=max(n - 1, 0))


def _cell(flat_idx, H):
    return torch.stack([flat_idx // H, flat_idx % H], 1).int()


def mutate_plain(grid, goal_pos, agent_pos, u, num_edits: int,
                 editor_actions: str):
    """The edits of every level → (grid, goal_pos, agent_pos, n_walls).

    ``grid`` (N, W, H) uint8, ``goal_pos`` / ``agent_pos`` (N, 2) int32
    (the agent's start), ``u`` (N, 2 E + 2) float32.
    """
    actions = EDITOR_ACTION_SPACES[editor_actions]
    grid = grid.clone()
    n, W, H = grid.shape
    dev = grid.device
    rows = torch.arange(n, device=dev)
    interior = W - 2
    goal, agent = goal_pos.long(), agent_pos.long()
    none = torch.full_like(goal, -1)
    full = lambda v: torch.full((n,), v, dtype=grid.dtype, device=dev)
    for i in range(num_edits):
        loc = _scaled(u[:, i], interior * interior)
        a = _scaled(u[:, num_edits + i], len(actions))
        xy = torch.stack([loc % interior + 1, loc // interior + 1], 1)
        x, y = xy[:, 0], xy[:, 1]
        goal = torch.where((goal == xy).all(1, keepdim=True), none, goal)
        agent = torch.where((agent == xy).all(1, keepdim=True), none, agent)
        grid[rows, x, y] = EMPTY
        grid[rows, x, y] = torch.where(a == actions.index('-'), full(WALL),
                                       grid[rows, x, y])
        if 'g' in actions:
            is_goal = a == actions.index('g')
            gx, gy = goal[:, 0].clamp(min=0), goal[:, 1].clamp(min=0)
            grid[rows, gx, gy] = torch.where(is_goal & (goal[:, 0] >= 0),
                                             full(EMPTY), grid[rows, gx, gy])
            grid[rows, x, y] = torch.where(is_goal, full(GOAL),
                                           grid[rows, x, y])
            goal = torch.where(is_goal[:, None], xy, goal)
        if 'a' in actions:
            agent = torch.where((a == actions.index('a'))[:, None], xy, agent)

    mask = grid == EMPTY
    has = agent[:, 0] >= 0
    ax, ay = agent[:, 0].clamp(min=0), agent[:, 1].clamp(min=0)
    mask[rows, ax, ay] = mask[rows, ax, ay] & ~has
    g_cell = sample_cell_from_uniform(mask, u[:, 2 * num_edits]).long()
    need = goal[:, 0] < 0
    grid[rows, g_cell[:, 0], g_cell[:, 1]] = torch.where(
        need, full(GOAL), grid[rows, g_cell[:, 0], g_cell[:, 1]])
    goal = torch.where(need[:, None], g_cell, goal)
    a_cell = sample_cell_from_uniform(grid == EMPTY,
                                      u[:, 2 * num_edits + 1]).long()
    agent = torch.where((agent[:, 0] < 0)[:, None], a_cell, agent)
    n_walls = (grid[:, 1:-1, 1:-1] == WALL).flatten(1).sum(1).int()
    return grid, goal.int(), agent.int(), n_walls


def reset_random_plain(u, params):
    """N domain-randomized levels from ``u`` (N, 4 + max_walls) → (grid,
    goal_pos, agent_start_pos, agent_start_dir, n_walls)."""
    p = params
    n = u.shape[0]
    dev = u.device
    W, H = p.width, p.height
    grid = torch.full((n, W, H), EMPTY, dtype=torch.uint8, device=dev)
    grid[:, 0, :] = grid[:, -1, :] = WALL
    grid[:, :, 0] = grid[:, :, -1] = WALL
    rows = torch.arange(n, device=dev)
    goal = sample_cell_from_uniform(grid == EMPTY, u[:, 0])
    grid[rows, goal[:, 0].long(), goal[:, 1].long()] = GOAL
    agent = sample_cell_from_uniform(grid == EMPTY, u[:, 1])
    direction = _scaled(u[:, 2], 4).int()
    if p.resample_n_clutter:
        n_walls = _scaled(u[:, 3], max(p.n_clutter, 1))
    else:
        n_walls = torch.full((n,), p.n_clutter // 2, device=dev)
    ax, ay = agent[:, 0].long(), agent[:, 1].long()
    placed = torch.zeros((n,), dtype=torch.int32, device=dev)
    for i in range(max_walls(p)):
        mask = grid == EMPTY
        mask[rows, ax, ay] = False
        pos = sample_cell_from_uniform(mask, u[:, 4 + i])
        do = (i < n_walls) & mask.flatten(1).any(1)
        px, py = pos[:, 0].long(), pos[:, 1].long()
        grid[rows, px, py] = torch.where(
            do, torch.full_like(grid[rows, px, py], WALL), grid[rows, px, py])
        placed += do.int()
    return grid, goal, agent, direction, placed


def _check_cells(W, H):
    if W * H > MAX_CELLS:
        raise ValueError(f'grid: {W}x{H} has more than {MAX_CELLS} cells')


def mutate(grid, goal_pos, agent_pos, u, num_edits: int,
           editor_actions: str):
    """The edits of a batch; see :func:`mutate_plain`.  CPU tensors take
    the twin; CUDA tensors launch the kernel (``mutate.launches``) or
    raise."""
    if grid.dim() != 3:
        raise ValueError(f'grid: expected (N, W, H), got {tuple(grid.shape)}')
    n, W, H = grid.shape
    dev = grid.device
    if editor_actions not in EDITOR_ACTION_SPACES:
        raise ValueError(f'unknown editor actions {editor_actions!r}')
    for name, t, dtype, shape in (
            ('grid', grid, torch.uint8, (n, W, H)),
            ('goal_pos', goal_pos, torch.int32, (n, 2)),
            ('agent_pos', agent_pos, torch.int32, (n, 2)),
            ('u', u, torch.float32, (n, mutate_draws(num_edits)))):
        _build.check_tensor(name, t, dtype, shape, dev)
    _check_cells(W, H)
    if dev.type == 'cpu':
        return mutate_plain(grid, goal_pos, agent_pos, u, num_edits,
                            editor_actions)
    lib = _build.library()
    out_grid = torch.empty_like(grid)
    goal, agent = torch.empty_like(goal_pos), torch.empty_like(agent_pos)
    n_walls = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = lib.dcd_multigrid_mutate(
        grid.data_ptr(), goal_pos.data_ptr(), agent_pos.data_ptr(),
        u.data_ptr(), out_grid.data_ptr(), goal.data_ptr(), agent.data_ptr(),
        n_walls.data_ptr(), n, W, H, num_edits, _ACTION_SET[editor_actions],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'multigrid_edit.mutate')
    mutate.launches += 1
    return out_grid, goal, agent, n_walls


mutate.launches = 0


def reset_random(u, params):
    """N domain-randomized levels; see :func:`reset_random_plain`.  CPU
    tensors take the twin; CUDA tensors launch the kernel
    (``reset_random.launches``) or raise."""
    p = params
    n = u.shape[0]
    dev = u.device
    _build.check_tensor('u', u, torch.float32, (n, reset_random_draws(p)),
                        dev)
    _check_cells(p.width, p.height)
    if dev.type == 'cpu':
        return reset_random_plain(u, p)
    lib = _build.library()
    i32 = dict(dtype=torch.int32, device=dev)
    grid = torch.empty((n, p.width, p.height), dtype=torch.uint8, device=dev)
    goal, agent = torch.empty((n, 2), **i32), torch.empty((n, 2), **i32)
    direction, n_walls = torch.empty((n,), **i32), torch.empty((n,), **i32)
    rc = lib.dcd_multigrid_reset_random(
        u.data_ptr(), grid.data_ptr(), goal.data_ptr(), agent.data_ptr(),
        direction.data_ptr(), n_walls.data_ptr(), n, p.width, p.height,
        p.n_clutter, int(p.resample_n_clutter), max_walls(p),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'multigrid_edit.reset_random')
    reset_random.launches += 1
    return grid, goal, agent, direction, n_walls


reset_random.launches = 0
