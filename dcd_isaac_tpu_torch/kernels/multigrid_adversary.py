"""Kernel B5: the teacher's construction step with the level's BFS.

Replaces ``dcd_isaac_tpu/envs/multigrid/adversarial.py:step_adversary``
(:102-204) with the ``encode_grid`` of its observation (core.py:158) and,
on the final move, ``compute_metrics``/``shortest_path`` (core.py:369-430).
The CUDA source is ``csrc/multigrid_adversary.cu``: one CTA per level holds
the grid in shared memory, thread 0 places the goal, agent or wall, the
block draws a cell by a prefix count where a move needs one, and on the
final move the block relaxes the BFS distance to its fixed point without a
host round trip.  It is bound by bytes (a level's grid and image) and at
the main path's N = 32 by its launch.  ``shortest_path`` is the BFS alone,
a second entry point of the same source, for ``compute_metrics`` on the
reset paths.

The random draws are inputs: ``u`` (N, 3) float32 uniforms per level (the
noisy goal's coin, the noisy goal's cell, the agent's cell when it lands
on the goal); :func:`sample_cell_from_uniform` turns a uniform into a cell
as the kernel does, so kernel and twin agree bit for bit.  The wrappers
take the plain twins (``step_plain``, ``shortest_path_plain``) when the
grid lies on the CPU, and launch the kernel or raise when it lies on the
card.
"""

from __future__ import annotations

import ctypes

import torch

from ..envs.multigrid.constants import AGENT, EMPTY, GOAL, TYPE_COLOR, WALL
from . import _build

# The kernel runs one thread per cell of a level.
MAX_CELLS = 256

# Fields of a MultiGridState that a move reads besides the grid, with their
# dtype and per-level shape, in the order of the kernel's arguments; and
# the fields it writes.
_STATE_SPEC = {
    'agent_pos': (torch.int32, (2,)), 'agent_dir': (torch.int32, ()),
    'agent_start_pos': (torch.int32, (2,)), 'goal_pos': (torch.int32, (2,)),
    'adv_step_count': (torch.int32, ()), 'adv_max_steps': (torch.int32, ()),
    'n_clutter_placed': (torch.int32, ()), 'passable': (torch.bool, ()),
    'shortest_path_length': (torch.int32, ()),
    'distance_to_goal': (torch.int32, ()),
}
STATE_IN = ('grid', *_STATE_SPEC)
STATE_OUT = ('grid', 'agent_start_pos', 'goal_pos', 'adv_step_count',
             'adv_max_steps', 'n_clutter_placed', 'passable',
             'shortest_path_length', 'distance_to_goal')

# How many relaxation sweeps the plain BFS runs between two checks for the
# fixed point; the check reads a flag on the host, and extra sweeps at the
# fixed point change nothing.
_BFS_SWEEPS_PER_CHECK = 8


def sample_cell_from_uniform(mask: torch.Tensor, u: torch.Tensor
                             ) -> torch.Tensor:
    """The cell of each (N, W, H) ``mask`` chosen by the uniform ``u`` (N,).

    Takes the k-th True cell in flat order, k = min(trunc(u * count),
    count - 1); an empty mask gives cell (0, 0).  Returns (N, 2) int32.
    """
    n, _, h = mask.shape
    flat = mask.reshape(n, -1)
    count = flat.sum(1)
    k = torch.minimum((u * count).long(), (count - 1).clamp(min=0))
    idx = (flat.cumsum(1) > k[:, None]).int().argmax(1)
    idx = torch.where(count > 0, idx, torch.zeros_like(idx))
    return torch.stack([idx // h, idx % h], 1).int()


def encode_plain(grid, agent_pos, agent_dir) -> torch.Tensor:
    """(N, W, H, 3) uint8 encoding with the agent overlay (core.py:158)."""
    colors = torch.tensor(TYPE_COLOR, device=grid.device)[grid.long()]
    enc = torch.stack([grid, colors, torch.zeros_like(grid)], -1)
    n = grid.shape[0]
    has_agent = agent_pos[:, 0] >= 0
    x = agent_pos[:, 0].clamp(min=0).long()
    y = agent_pos[:, 1].clamp(min=0).long()
    rows = torch.arange(n, device=grid.device)
    code = torch.stack([torch.full_like(agent_dir, AGENT),
                        torch.zeros_like(agent_dir), agent_dir],
                       -1).to(torch.uint8)
    enc[rows, x, y] = torch.where(has_agent[:, None], code, enc[rows, x, y])
    return enc


def shortest_path_plain(grid, start, goal, inf: int):
    """(passable, shortest_path_length) of each level (core.py:369-411).

    4-neighbour min-relaxation of the distance from ``start`` over
    non-wall cells, iterated over the whole batch until no level changes.
    """
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


def step_plain(state, loc, u, params) -> dict:
    """One construction move of every level, in plain PyTorch.

    ``state`` has the :data:`STATE_IN` fields (a MultiGridState), ``loc``
    (N,) int32 the moves, ``u`` (N, 3) float32 the draws, ``params`` the
    env's MultiGridParams.  Returns the :data:`STATE_OUT` fields and
    ``image`` (N, W, H, 3) uint8 and ``done`` (N,) bool.
    """
    p = params
    grid = state.grid.clone()
    n, W, H = grid.shape
    dev = grid.device
    flat = grid.view(n, -1)
    rows = torch.arange(n, device=dev)
    interior = W - 2
    x = (loc % interior + 1).clamp(0, W - 1)
    y = (loc // interior + 1).clamp(0, H - 1)
    xy = torch.stack([x, y], 1).int()
    c = (x * H + y).long()

    t = state.adv_step_count
    amax = state.adv_max_steps
    if p.resample_n_clutter:
        amax = torch.where(
            t == 0, (loc * p.n_clutter) // p.adversary_action_dim + 2, amax)
    active = t < amax
    if p.choose_goal_last:
        cg = active & (t == amax - 2)
        ca = active & (t == amax - 1)
    else:
        cg = active & (t == 0)
        ca = active & (t == 1)
    pw = active & ~cg & ~ca

    cell = flat[rows, c]
    ncp = state.n_clutter_placed
    goal = state.goal_pos
    start = state.agent_start_pos
    const = lambda v: torch.full_like(cell, v)

    goal_here = cg
    if p.goal_noise > 0:
        noisy = u[:, 0] < p.goal_noise
        goal_here = cg & ~noisy
        rand = sample_cell_from_uniform(grid == EMPTY, u[:, 1])
        put = cg & noisy
        rc = (rand[:, 0] * H + rand[:, 1]).long()
        flat[rows, rc] = torch.where(put, const(GOAL), flat[rows, rc])
        goal = torch.where(put[:, None], rand, goal)
    ncp = ncp - (goal_here & (cell == WALL)).int()
    flat[rows, c] = torch.where(goal_here, const(GOAL), flat[rows, c])
    goal = torch.where(goal_here[:, None], xy, goal)

    clear = ca & (flat[rows, c] == WALL)
    ncp = ncp - clear.int()
    flat[rows, c] = torch.where(clear, const(EMPTY), flat[rows, c])
    collide = ca & (flat[rows, c] != EMPTY)
    rand = sample_cell_from_uniform(grid == EMPTY, u[:, 2])
    start = torch.where(ca[:, None],
                        torch.where(collide[:, None], rand, xy), start)

    on_agent = (start[:, 0] == x) & (start[:, 1] == y) & (start[:, 0] >= 0)
    wall_ok = pw & (flat[rows, c] == EMPTY) & ~on_agent
    flat[rows, c] = torch.where(wall_ok, const(WALL), flat[rows, c])
    ncp = ncp + wall_ok.int()

    t1 = t + 1
    done = t1 >= p.adversary_max_steps
    passable = state.passable
    spl = state.shortest_path_length
    dist = state.distance_to_goal
    if bool(done.any()):
        inf = p.max_shortest_path
        m_passable, m_spl = shortest_path_plain(grid, start, goal, inf)
        both = (start[:, 0] >= 0) & (goal[:, 0] >= 0)
        m_dist = torch.where(both, (goal - start).abs().sum(1).int(),
                             torch.full_like(dist, -1))
        passable = torch.where(done, m_passable, passable)
        spl = torch.where(done, m_spl.int(), spl)
        dist = torch.where(done, m_dist, dist)
    return {
        'grid': grid, 'agent_start_pos': start.int(), 'goal_pos': goal.int(),
        'adv_step_count': t1, 'adv_max_steps': amax.int(),
        'n_clutter_placed': ncp.int(), 'passable': passable,
        'shortest_path_length': spl, 'distance_to_goal': dist,
        'image': encode_plain(grid, state.agent_pos, state.agent_dir),
        'done': done,
    }


def _check_grid(grid):
    if grid.dim() != 3:
        raise ValueError(f'grid: expected (N, W, H), got {tuple(grid.shape)}')
    _build.check_tensor('grid', grid, torch.uint8, grid.shape, grid.device)
    n, W, H = grid.shape
    if W * H > MAX_CELLS:
        raise ValueError(f'grid: {W}x{H} has more than {MAX_CELLS} cells')
    return n



def step(state, loc, u, params) -> dict:
    """One construction move of a batch; see :func:`step_plain`.

    ``loc`` must lie in [0, (W-2)^2).  CPU tensors take the plain twin;
    CUDA tensors launch the kernel (counted in ``step.launches``) or raise.
    """
    n = _check_grid(state.grid)
    dev = state.grid.device
    for name, (dtype, tail) in _STATE_SPEC.items():
        _build.check_tensor(name, getattr(state, name), dtype, (n, *tail), dev)
    _build.check_tensor('loc', loc, torch.int32, (n,), dev)
    _build.check_tensor('u', u, torch.float32, (n, 3), dev)
    if dev.type == 'cpu':
        return step_plain(state, loc, u, params)
    _, W, H = state.grid.shape
    p = params
    out = {k: torch.empty_like(getattr(state, k)) for k in STATE_OUT}
    out['image'] = torch.empty((n, W, H, 3), dtype=torch.uint8, device=dev)
    out['done'] = torch.empty((n,), dtype=torch.bool, device=dev)
    rc = _build.library().dcd_adversary_step(
        *(getattr(state, k).data_ptr() for k in STATE_IN),
        loc.data_ptr(), u.data_ptr(),
        *(out[k].data_ptr() for k in STATE_OUT),
        out['image'].data_ptr(), out['done'].data_ptr(),
        n, W, H, p.n_clutter, p.adversary_max_steps, p.adversary_action_dim,
        int(p.resample_n_clutter), int(p.choose_goal_last),
        ctypes.c_float(p.goal_noise), p.max_shortest_path,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'multigrid_adversary.step')
    step.launches += 1
    return out


step.launches = 0


def shortest_path(grid, start, goal, inf: int):
    """(passable (N,) bool, shortest_path_length (N,) int32) of each level.

    CPU tensors take :func:`shortest_path_plain`; CUDA tensors launch the
    BFS kernel (counted in ``shortest_path.launches``) or raise.
    """
    n = _check_grid(grid)
    dev = grid.device
    _build.check_tensor('start', start, torch.int32, (n, 2), dev)
    _build.check_tensor('goal', goal, torch.int32, (n, 2), dev)
    if dev.type == 'cpu':
        return shortest_path_plain(grid, start, goal, inf)
    _, W, H = grid.shape
    passable = torch.empty((n,), dtype=torch.bool, device=dev)
    spl = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = _build.library().dcd_multigrid_shortest_path(
        grid.data_ptr(), start.data_ptr(), goal.data_ptr(),
        passable.data_ptr(), spl.data_ptr(), n, W, H, inf,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'multigrid_adversary.shortest_path')
    shortest_path.launches += 1
    return passable, spl


shortest_path.launches = 0
