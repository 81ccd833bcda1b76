"""Kernel B10: one step of N BipedalWalkers on the card.

Replaces ``dcd_isaac_tpu/envs/walker/env.py:step_walker`` (:132-168) with
``physics.py``'s contact generation, 40-sweep impulse solver and lidar.
The CUDA source is ``csrc/walker_step.cu``: one warp a walker, the terrain
in shared memory, the 25 contact candidates on lanes, the joints on lane 0
in the JAX package's order, each body's impulses summed vertex by vertex.
It is bound by that dependent chain, not by its few kB a walker.

:func:`step` takes a ``WalkerState`` and (N, 4) actions.  CPU tensors
take the plain twin ``envs/walker/env.py:step_walker_plain``; CUDA
tensors launch the kernel (counted in ``step.launches``) or raise.  The
kernel's constants are one float32 table (:func:`consts`), built with the
twin's own arithmetic on the state's device, so the kernel reads the same
numbers the twin computes with.
"""

from __future__ import annotations

import functools

import torch

from . import _build

# Table layout (csrc/walker_step.cu: C_*): name → width.
CONSTS = (('inv_m', 5), ('inv_i', 5), ('verts', 50), ('mu', 5),
          ('anchor_a', 8), ('anchor_b', 8), ('lower', 4), ('upper', 4),
          ('ref', 4), ('speed', 4), ('hull_centroid', 2), ('lidar', 20),
          ('gravity', 2), ('box_normals', 8), ('baumgarte', 1), ('slop', 1),
          ('dt', 1), ('torque', 1), ('cost', 1), ('shaping', 1),
          ('scale_recip', 1), ('angle_weight', 1), ('finish_x', 1),
          ('obs_vel', 1), ('obs_vx', 1), ('obs_vy', 1), ('fps_recip', 1),
          ('speed_recip', 4))
NUM_CONSTS = sum(w for _, w in CONSTS)


@functools.lru_cache(maxsize=None)
def consts(device: torch.device) -> torch.Tensor:
    """The (NUM_CONSTS,) float32 table on ``device``."""
    from ..envs.walker import physics as ph
    f = lambda a: ph.f32(a, device).reshape(-1)
    s = lambda v: torch.tensor([v], dtype=torch.float32, device=device)
    parts = {
        'inv_m': f(ph.INV_M), 'inv_i': f(ph.INV_I),
        'verts': f(ph.BODY_VERTS), 'mu': f(ph.CONTACT_FRICTION),
        'anchor_a': f(ph.JOINT_ANCHOR_A), 'anchor_b': f(ph.JOINT_ANCHOR_B),
        'lower': f(ph.JOINT_LOWER), 'upper': f(ph.JOINT_UPPER),
        'ref': f(ph.JOINT_REF), 'speed': f(ph.JOINT_SPEED),
        'hull_centroid': f(ph.HULL_CENTROID),
        'lidar': ph.lidar_dirs(device).reshape(-1),
        'gravity': torch.tensor([0.0, ph.GRAVITY], device=device) * ph.DT,
        'box_normals': f(ph.BOX_NORMALS),
        'baumgarte': s(ph.POS_BAUMGARTE / ph.DT), 'slop': s(ph.PEN_SLOP),
        'dt': s(ph.DT), 'torque': s(ph.MOTORS_TORQUE),
        'cost': s(0.00035 * ph.MOTORS_TORQUE), 'shaping': s(130.0),
        'scale_recip': s(ph.recip(ph.SCALE)), 'angle_weight': s(5.0),
        'finish_x': s((ph.TERRAIN_LENGTH - ph.TERRAIN_GRASS)
                      * ph.TERRAIN_STEP),
        'obs_vel': s(0.3), 'obs_vx': s(ph.VIEWPORT_W / ph.SCALE),
        'obs_vy': s(ph.VIEWPORT_H / ph.SCALE),
        'fps_recip': s(ph.recip(ph.FPS)),
        'speed_recip': f([ph.recip(v) for v in ph.JOINT_SPEED])}
    table = torch.cat([parts[name] for name, _ in CONSTS])
    assert table.numel() == NUM_CONSTS
    return table


def step(state, action: torch.Tensor, first: bool = False):
    """One step → (state, obs (N, 24), reward (N,), done (N,), finish (N,));
    ``first`` is the reset's zero-action step (no count, reward 0)."""
    if action.device.type == 'cpu':
        from ..envs.walker.env import step_walker_plain
        return step_walker_plain(state, action, first)
    b, tr = state.bodies, state.terrain
    n = action.shape[0]
    dev = action.device
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    ins = (('pos', b.pos, f32, (n, 5, 2)), ('angle', b.angle, f32, (n, 5)),
           ('vel', b.vel, f32, (n, 5, 2)), ('angvel', b.angvel, f32, (n, 5)),
           ('xs', tr.xs, f32, (n, 200)), ('ys', tr.ys, f32, (n, 200)),
           ('boxes', tr.boxes, f32, (n, 64, 4)),
           ('n_boxes', tr.n_boxes, i32, (n,)),
           ('prev_shaping', state.prev_shaping, f32, (n,)),
           ('game_over', state.game_over, u8, (n,)),
           ('step_count', state.step_count, i32, (n,)),
           ('action', action, f32, (n, 4)))
    for name, t, dtype, shape in ins:
        _build.check_tensor(name, t, dtype, shape, dev)
    out = {k: torch.empty(s, dtype=d, device=dev) for k, s, d in (
        ('pos', (n, 5, 2), f32), ('angle', (n, 5), f32),
        ('vel', (n, 5, 2), f32), ('angvel', (n, 5), f32),
        ('lower_contact', (n, 2), u8), ('joint_angle', (n, 4), f32),
        ('joint_speed', (n, 4), f32), ('game_over', (n,), u8),
        ('step_count', (n,), i32), ('prev_shaping', (n,), f32),
        ('obs', (n, 24), f32), ('reward', (n,), f32), ('done', (n,), u8),
        ('finish', (n,), u8))}
    lib = _build.library()
    if lib.dcd_walker_consts_count() != NUM_CONSTS:
        raise RuntimeError('dcd_walker_step: the kernel and the wrapper '
                           'disagree on the constant table')
    rc = lib.dcd_walker_step(
        *(t.data_ptr() for _, t, _, _ in ins), consts(dev).data_ptr(),
        *(t.data_ptr() for t in out.values()), n, int(first),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'walker_step')
    step.launches += 1
    bodies = type(b)(pos=out['pos'], angle=out['angle'], vel=out['vel'],
                     angvel=out['angvel'])
    state = state.replace(
        bodies=bodies, lower_contact=out['lower_contact'],
        joint_angle=out['joint_angle'], joint_speed=out['joint_speed'],
        game_over=out['game_over'], step_count=out['step_count'],
        prev_shaping=out['prev_shaping'])
    return state, out['obs'], out['reward'], out['done'], out['finish']


step.launches = 0
