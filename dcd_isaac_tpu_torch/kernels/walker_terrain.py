"""Kernel B11: the walker's terrain and placement of N levels on the card.

Replaces ``dcd_isaac_tpu/envs/walker/terrain.py:generate_terrain``
(:36-219) and ``env.py:place_walker`` (:40-59).  The CUDA source is
``csrc/walker_terrain.cu``: one thread a level runs the 200-column state
machine, drawing each column's uniforms from the counter-based hash of
(seed, column, slot) (``envs/seeds.py:hash_uniform``), and writes the
heightfield, the boxes, their count and the bodies' initial poses.  It is
bound by the 200 dependent column steps, not by its 2.9 kB a level.

:func:`generate` takes (N, 8) float32 params and (N,) int32 seeds.  CPU
tensors take the plain twins (``generate_terrain`` of ``terrain_draws``,
``place_walker`` of ``placement_draw``); CUDA tensors launch the kernel
(counted in ``generate.launches``) or raise.  Kernel and twin agree bit
for bit.
"""

from __future__ import annotations

import functools

import torch

from . import _build

# Table layout (csrc/walker_terrain.cu: T_*): name → width.
CONSTS = (('step', 1), ('step4', 1), ('height', 1), ('stair_x', 10),
          ('vel_decay', 1), ('vel_pull', 1), ('scale_recip', 1), ('pos', 10),
          ('angle', 5), ('push', 1), ('push_dv', 1))
NUM_CONSTS = sum(w for _, w in CONSTS)


@functools.lru_cache(maxsize=None)
def consts(device: torch.device) -> torch.Tensor:
    """The (NUM_CONSTS,) float32 table on ``device``; the poses are the
    twin's ``place_walker``'s."""
    from ..envs.walker import physics as ph
    from ..envs.walker.env import PUSH_DV, place_walker
    s = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    pose = place_walker(torch.zeros(1, device=device))
    parts = {
        'step': s(ph.TERRAIN_STEP), 'step4': s(4 * ph.TERRAIN_STEP),
        'height': s(ph.TERRAIN_HEIGHT),
        'stair_x': s(*[(k * 4) * ph.TERRAIN_STEP for k in range(10)]),
        'vel_decay': s(0.8), 'vel_pull': s(0.01),
        'scale_recip': s(ph.recip(ph.SCALE)),
        'pos': pose.pos[0].reshape(-1), 'angle': pose.angle[0],
        'push': s(ph.INITIAL_RANDOM), 'push_dv': s(PUSH_DV)}
    table = torch.cat([parts[name] for name, _ in CONSTS])
    assert table.numel() == NUM_CONSTS
    return table


def generate(params: torch.Tensor, seeds: torch.Tensor):
    """→ (Terrain, Bodies) of N levels."""
    from ..envs.walker import physics as ph
    if params.device.type == 'cpu':
        from ..envs.walker.env import place_walker, placement_draw
        from ..envs.walker.terrain import generate_terrain, terrain_draws
        return (generate_terrain(params, terrain_draws(seeds)),
                place_walker(placement_draw(seeds)))
    n = params.shape[0]
    dev = params.device
    _build.check_tensor('params', params, torch.float32, (n, 8), dev)
    _build.check_tensor('seeds', seeds, torch.int32, (n,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    xs = torch.empty((n, ph.TERRAIN_LENGTH), **f32)
    ys = torch.empty((n, ph.TERRAIN_LENGTH), **f32)
    boxes = torch.empty((n, ph.MAX_BOXES, 4), **f32)
    n_boxes = torch.empty((n,), dtype=torch.int32, device=dev)
    pos = torch.empty((n, 5, 2), **f32)
    angle = torch.empty((n, 5), **f32)
    vel = torch.empty((n, 5, 2), **f32)
    angvel = torch.empty((n, 5), **f32)
    lib = _build.library()
    if lib.dcd_walker_terrain_consts_count() != NUM_CONSTS:
        raise RuntimeError('dcd_walker_terrain: the kernel and the wrapper '
                           'disagree on the constant table')
    rc = lib.dcd_walker_terrain(
        params.data_ptr(), seeds.data_ptr(), consts(dev).data_ptr(),
        xs.data_ptr(), ys.data_ptr(), boxes.data_ptr(), n_boxes.data_ptr(),
        pos.data_ptr(), angle.data_ptr(), vel.data_ptr(), angvel.data_ptr(),
        n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'walker_terrain')
    generate.launches += 1
    return (ph.Terrain(xs=xs, ys=ys, boxes=boxes, n_boxes=n_boxes),
            ph.Bodies(pos=pos, angle=angle, vel=vel, angvel=angvel))


generate.launches = 0
