"""Kernel B13b: N CarRacing tracks from their levels' control points.

Replaces ``dcd_isaac_tpu/envs/carracing/adversarial.py:_bezier_track_padded``
(:62-87) with ``bezier.py:get_bezier_track``, ``track.py:build_track``,
``_closest_track_index`` and ``dynamics.py:init_car``.  The CUDA source is
``csrc/carracing_track.cu``: one warp a level, the ccw sort and the
segments on lane 0, the 480 samples, angles, border runs and start search
on the lanes.  It is bound by that serial prologue, not by its 7.7 kB a
level.

:func:`build` takes (N, 12, 2) control points, (N,) counts and start
angles.  CPU tensors take the plain twin
``envs/carracing/adversarial.py:build_level_plain``; CUDA tensors launch
the kernel (counted in ``build.launches``) or raise.  The kernel's
constants are one float32 table (:func:`consts`) built with the twin's
own arithmetic.
"""

from __future__ import annotations

import functools

import torch

from . import _build

# Table layout (csrc/carracing_track.cu: C_*): name → width.
CONSTS = (('bernstein', 160), ('p', 1), ('q', 1), ('pi', 1), ('two_pi', 1),
          ('half_pi', 1), ('rad', 1), ('big', 1))
NUM_CONSTS = sum(w for _, w in CONSTS)


@functools.lru_cache(maxsize=None)
def consts(device: torch.device) -> torch.Tensor:
    """The (NUM_CONSTS,) float32 table on ``device``."""
    import numpy as np
    from ..envs.carracing import bezier as bz
    s = lambda v: torch.tensor([v], dtype=torch.float32)
    parts = {'bernstein': bz.bernstein('cpu').reshape(-1), 'p': s(bz.P_EDGY),
             'q': s(bz.Q_EDGY), 'pi': s(bz.PI), 'two_pi': s(bz.TWO_PI),
             'half_pi': s(np.pi / 2), 'rad': s(bz.RAD), 'big': s(1e9)}
    table = torch.cat([parts[name] for name, _ in CONSTS])
    assert table.numel() == NUM_CONSTS
    return table.to(device)


def build(cps: torch.Tensor, n: torch.Tensor, start_alpha: torch.Tensor):
    """→ (Track, start tile (N,) int32, CarState at rest on it)."""
    if cps.device.type == 'cpu':
        from ..envs.carracing.adversarial import build_level_plain
        return build_level_plain(cps, n, start_alpha)
    from ..envs.carracing.dynamics import init_car
    from ..envs.carracing.track import Track
    N, dev = cps.shape[0], cps.device
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (('cps', cps, f32, (N, 12, 2)),
                                  ('n', n, i32, (N,)),
                                  ('start_alpha', start_alpha, f32, (N,))):
        _build.check_tensor(name, t, dtype, shape, dev)
    P = 480
    out = {k: torch.empty(s, dtype=d, device=dev) for k, s, d in (
        ('points', (N, P, 2), f32), ('beta', (N, P), f32),
        ('border', (N, P), torch.bool), ('valid', (N, P), torch.bool),
        ('n_points', (N,), i32), ('offset', (N, 2), f32),
        ('start', (N,), i32), ('car_pos', (N, 2), f32),
        ('car_angle', (N,), f32))}
    lib = _build.library()
    if lib.dcd_carracing_track_consts_count() != NUM_CONSTS:
        raise RuntimeError('dcd_carracing_track: the kernel and the wrapper '
                           'disagree on the constant table')
    rc = lib.dcd_carracing_track(
        cps.data_ptr(), n.data_ptr(), start_alpha.data_ptr(),
        consts(dev).data_ptr(), *(t.data_ptr() for t in out.values()), N,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'carracing_track')
    build.launches += 1
    track = Track(points=out['points'], beta=out['beta'],
                  border=out['border'], valid=out['valid'],
                  n_points=out['n_points'], offset=out['offset'])
    car = init_car(out['car_angle'], out['car_pos'][:, 0],
                   out['car_pos'][:, 1])
    return track, out['start'], car


build.launches = 0
