"""Kernel 1: the MultiGrid agent step with its egocentric view gather.

Replaces ``dcd_isaac_tpu/envs/multigrid/core.py:step_agent`` (:306-346)
with ``gen_obs`` (:265-299), and the ``truncated`` flag of
``AdversarialMultiGrid.step`` (adversarial.py:402-411).  The CUDA source is
``csrc/multigrid_step.cu``; it runs one thread per env, is bound by bytes
(per env at most v*v - 1 = 24 grid cells of the new view read, plus the
forward cell when the agent moves, and 75 image bytes written) and at the
main path's N = 32 by its launch.  ``multigrid_obs`` is the view gather alone, for the
observations of the reset paths (``reset_agent``); it is a second entry
point of the same source.

Both wrappers take the plain PyTorch twin (``step_plain`` / ``obs_plain``)
when the grid lies on the CPU, and launch the kernel or raise when it lies
on the card.  Opaque walls (``see_through_walls=False``, the occlusion
flood ``_process_vis``) are not ported yet: both wrappers raise for them on
every device.  The auto-reset select of the rollout (``algos/rollout.py``) stays
plain PyTorch: it selects a dozen state fields, which a fused kernel would
have to take as a second state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..envs.multigrid.constants import (
    DIR_TO_VEC, EMPTY, FORWARD, GOAL, LAVA, LEFT, RIGHT, TYPE_COLOR, WALKABLE,
    WALL,
)
from . import _build


@functools.lru_cache()
def view_offset_table(v: int) -> np.ndarray:
    """(4, v, v, 2) grid offsets per direction (core.py:_view_offset_table).

    View cell (i, j), agent at (v//2, v-1) facing "up", maps to
    ``agent_pos + forward·(v-1-j) + right·(i - v//2)``.
    """
    vecs = np.array([(1, 0), (0, 1), (-1, 0), (0, -1)], np.int32)
    offs = np.zeros((4, v, v, 2), np.int32)
    for d in range(4):
        f, r = vecs[d], vecs[(d + 1) % 4]
        for i in range(v):
            for j in range(v):
                offs[d, i, j] = f * (v - 1 - j) + r * (i - v // 2)
    return offs


def obs_plain(grid, agent_pos, agent_dir, view_size: int) -> torch.Tensor:
    """gen_obs (core.py:265-299) → (N, v, v, 3) uint8 image."""
    n, W, H = grid.shape
    v = view_size
    dev = grid.device
    table = torch.tensor(view_offset_table(v), device=dev)
    offs = table[agent_dir.long()]                   # (N, v, v, 2)
    coords = agent_pos[:, None, None, :] + offs
    cx, cy = coords[..., 0], coords[..., 1]
    inb = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    flat = cx.clamp(0, W - 1) * H + cy.clamp(0, H - 1)
    window = grid.reshape(n, -1).gather(1, flat.reshape(n, -1).long())
    window = torch.where(inb, window.reshape(n, v, v),
                         torch.full_like(window.reshape(n, v, v), WALL))
    window[:, v // 2, v - 1] = EMPTY
    colors = torch.tensor(TYPE_COLOR, device=dev)[
        window.long().clamp(max=len(TYPE_COLOR) - 1)]
    return torch.stack([window, colors, torch.zeros_like(window)], -1)


def step_plain(grid, agent_pos, agent_dir, step_count, agent_done, action,
               view_size: int, max_steps: int):
    """step_agent + gen_obs + truncation flag, in plain PyTorch.

    Returns ``(agent_pos, agent_dir, step_count, agent_done, image, reward,
    done, truncated)``.
    """
    n, W, H = grid.shape
    dev = grid.device
    step = step_count + 1
    d = agent_dir
    new_dir = torch.where(action == LEFT, (d + 3) % 4,
                          torch.where(action == RIGHT, (d + 1) % 4, d))
    fwd = agent_pos + torch.tensor(DIR_TO_VEC, device=dev)[d.long()]
    flat = fwd[:, 0].clamp(0, W - 1) * H + fwd[:, 1].clamp(0, H - 1)
    fwd_type = grid.reshape(n, -1).gather(1, flat[:, None].long())[:, 0].long()
    is_fwd = action == FORWARD
    hit_goal = is_fwd & (fwd_type == GOAL)
    hit_lava = is_fwd & (fwd_type == LAVA)
    moved = is_fwd & torch.tensor(WALKABLE, device=dev)[fwd_type]
    new_pos = torch.where(moved[:, None], fwd, agent_pos)
    # Tensor / tensor: a CUDA division by a Python scalar multiplies by the
    # reciprocal, which would not round as the kernel's division does.
    frac = step.float() / torch.full_like(step, max_steps, dtype=torch.float32)
    reward = torch.where(hit_goal, 1.0 - 0.9 * frac, torch.zeros_like(frac))
    new_done = agent_done | hit_goal | hit_lava
    done = new_done | (step >= max_steps)
    image = obs_plain(grid, new_pos, new_dir, view_size)
    return (new_pos, new_dir, step, new_done, image, reward, done,
            done & ~new_done)


def _check_state(grid, agent_pos, agent_dir):
    if grid.dim() != 3:
        raise ValueError(f'grid: expected (N, W, H), got {tuple(grid.shape)}')
    n = grid.shape[0]
    _build.check_tensor('grid', grid, torch.uint8, grid.shape, grid.device)
    _build.check_tensor('agent_pos', agent_pos, torch.int32, (n, 2), grid.device)
    _build.check_tensor('agent_dir', agent_dir, torch.int32, (n,), grid.device)
    return n


def _see_through_only(see_through_walls: bool):
    if not see_through_walls:
        raise NotImplementedError(
            'opaque walls (see_through_walls=False) are not ported yet')


def multigrid_step(grid, agent_pos, agent_dir, step_count, agent_done,
                   action, view_size: int, max_steps: int,
                   see_through_walls: bool = True):
    """One env step for a batch; see :func:`step_plain` for the outputs.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (and
    count the launch in ``multigrid_step.launches``) or raise.
    """
    _see_through_only(see_through_walls)
    n = _check_state(grid, agent_pos, agent_dir)
    dev = grid.device
    _build.check_tensor('step_count', step_count, torch.int32, (n,), dev)
    _build.check_tensor('agent_done', agent_done, torch.bool, (n,), dev)
    _build.check_tensor('action', action, torch.int32, (n,), dev)
    if dev.type == 'cpu':
        return step_plain(grid, agent_pos, agent_dir, step_count, agent_done,
                          action, view_size, max_steps)
    _, W, H = grid.shape
    v = view_size
    out = (torch.empty_like(agent_pos), torch.empty_like(agent_dir),
           torch.empty_like(step_count), torch.empty_like(agent_done),
           torch.empty((n, v, v, 3), dtype=torch.uint8, device=dev),
           torch.empty((n,), dtype=torch.float32, device=dev),
           torch.empty((n,), dtype=torch.bool, device=dev),
           torch.empty((n,), dtype=torch.bool, device=dev))
    lib = _build.library()
    rc = lib.dcd_multigrid_step(
        grid.data_ptr(), agent_pos.data_ptr(), agent_dir.data_ptr(),
        step_count.data_ptr(), agent_done.data_ptr(), action.data_ptr(),
        *(t.data_ptr() for t in out), n, W, H, v, max_steps,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'multigrid_step')
    multigrid_step.launches += 1
    return out


multigrid_step.launches = 0


def multigrid_obs(grid, agent_pos, agent_dir, view_size: int,
                  see_through_walls: bool = True) -> torch.Tensor:
    """The (N, v, v, 3) view of each env (gen_obs) without a step.

    CPU tensors take :func:`obs_plain`; CUDA tensors launch the kernel
    (counted in ``multigrid_obs.launches``) or raise.
    """
    _see_through_only(see_through_walls)
    n = _check_state(grid, agent_pos, agent_dir)
    dev = grid.device
    if dev.type == 'cpu':
        return obs_plain(grid, agent_pos, agent_dir, view_size)
    _, W, H = grid.shape
    v = view_size
    image = torch.empty((n, v, v, 3), dtype=torch.uint8, device=dev)
    lib = _build.library()
    rc = lib.dcd_multigrid_obs(
        grid.data_ptr(), agent_pos.data_ptr(), agent_dir.data_ptr(),
        image.data_ptr(), n, W, H, v,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'multigrid_obs')
    multigrid_obs.launches += 1
    return image


multigrid_obs.launches = 0
