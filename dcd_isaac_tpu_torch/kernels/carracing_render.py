"""Kernel B12: the CarRacing observation of N cars into their frame stack.

Replaces ``dcd_isaac_tpu/envs/carracing/track.py:render_frame`` (:148-241)
with ``nearest_tile`` and ``env.py``'s preprocessing and stack shift.
The CUDA source is ``csrc/carracing_render.cu``: a grid of (pixel tiles,
cars), the car's track in shared memory, one thread a pixel with its
480-point nearest search in unfused fp32.  It is bound by those
operations (about 35 M a car).

:func:`render` takes the env config, the cars, their tracks and sim times
and the old stack (None at a reset, which fills the whole stack).  CPU
tensors take the plain twin ``envs/carracing/env.py:stack_frames_plain``;
CUDA tensors launch the kernel (counted in ``render.launches``) or raise.
"""

from __future__ import annotations

import functools

import torch

from . import _build

# Table layout (csrc/carracing_render.cu: C_*): name → width.
CONSTS = (('z0', 1), ('z1', 1), ('r_window_w', 1), ('r_window_h', 1),
          ('track_width', 1), ('track_border', 1), ('road', 1),
          ('grass_base', 3), ('grass_patch', 3), ('r_checker', 1),
          ('shade', 1), ('bar_scale', 7), ('bar_x', 7), ('bar_rgb', 21),
          ('sprite', 9), ('hull_rgb', 3), ('gray', 3), ('r_128', 1))
NUM_CONSTS = sum(w for _, w in CONSTS)
# the indicator bars (JAX track.py:320-326): x0, scale, colour
BARS = ((5.0, 0.02, (1.0, 1.0, 1.0)), (10.0, 0.01, (0.0, 0.0, 1.0)),
        (13.0, 0.01, (0.0, 0.0, 1.0)), (16.0, 0.01, (0.2, 0.0, 1.0)),
        (19.0, 0.01, (0.2, 0.0, 1.0)), (24.0, 2.0, (0.0, 1.0, 0.0)),
        (29.0, 0.3, (1.0, 0.0, 0.0)))
# |lx| < 1, -2.6 < ly < 2.6; ||lx| - 1.1| < 0.3, |ly - 1.6| < 0.55 or
# |ly + 1.64| < 0.55 (JAX track.py:296-300)
SPRITE = (1.0, -2.6, 2.6, 1.1, 0.30, 1.6, 0.55, 1.64, 0.55)


@functools.lru_cache(maxsize=None)
def consts(device: torch.device) -> torch.Tensor:
    """The (NUM_CONSTS,) float32 table on ``device``."""
    from ..envs.carracing import env as ce
    from ..envs.carracing import track as tr
    v = lambda *x: torch.tensor(x, dtype=torch.float64).float()
    parts = {
        'z0': v(0.1 * tr.SCALE), 'z1': v(tr.ZOOM * tr.SCALE),
        'r_window_w': v(tr.recip(tr.WINDOW_W)),
        'r_window_h': v(tr.recip(tr.WINDOW_H)),
        'track_width': v(tr.TRACK_WIDTH),
        'track_border': v(tr.TRACK_WIDTH + tr.BORDER),
        'road': v(float(tr.ROAD_COLOR[0])),
        'grass_base': v(*tr.GRASS_BASE.tolist()),
        'grass_patch': v(*tr.GRASS_PATCH.tolist()),
        'r_checker': v(tr.recip(20)), 'shade': v(0.01),
        'bar_scale': v(*(b[1] for b in BARS)),
        'bar_x': v(*(b[0] for b in BARS)),
        'bar_rgb': v(*(c for b in BARS for c in b[2])),
        'sprite': v(*SPRITE), 'hull_rgb': v(0.8, 0.0, 0.0),
        'gray': v(*ce.GRAY), 'r_128': v(tr.recip(128.0))}
    table = torch.cat([parts[name] for name, _ in CONSTS])
    assert table.numel() == NUM_CONSTS
    return table.to(device)


def render(cfg, car, track, t: torch.Tensor, frames: torch.Tensor = None
           ) -> torch.Tensor:
    """→ (N, h, w, c·stack) float32 frames: the new observation after the
    older ones of ``frames``, or replicated when ``frames`` is None."""
    if t.device.type == 'cpu':
        from ..envs.carracing.env import stack_frames_plain
        return stack_frames_plain(cfg, car, track, t, frames)
    N, dev = t.shape[0], t.device
    f32, b8 = torch.float32, torch.bool
    h, w = cfg.obs_hw
    ct = cfg.obs_channels
    ins = (('points', track.points, f32, (N, 480, 2)),
           ('beta', track.beta, f32, (N, 480)),
           ('border', track.border, b8, (N, 480)),
           ('valid', track.valid, b8, (N, 480)),
           ('pos', car.pos, f32, (N, 2)), ('angle', car.angle, f32, (N,)),
           ('vel', car.vel, f32, (N, 2)), ('angvel', car.angvel, f32, (N,)),
           ('wheel_omega', car.wheel_omega, f32, (N, 4)),
           ('steer_angle', car.steer_angle, f32, (N,)),
           ('t', t, f32, (N,)))
    for name, x, dtype, shape in ins:
        _build.check_tensor(name, x, dtype, shape, dev)
    if frames is not None:
        _build.check_tensor('frames', frames, f32, (N, h, w, ct), dev)
    out = torch.empty((N, h, w, ct), dtype=f32, device=dev)
    lib = _build.library()
    if lib.dcd_carracing_render_consts_count() != NUM_CONSTS:
        raise RuntimeError('dcd_carracing_render: the kernel and the wrapper '
                           'disagree on the constant table')
    rc = lib.dcd_carracing_render(
        *(x.data_ptr() for _, x, _, _ in ins),
        frames.data_ptr() if frames is not None else None,
        consts(dev).data_ptr(), out.data_ptr(), N, int(cfg.crop),
        int(cfg.grayscale), cfg.frame_stack, int(frames is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'carracing_render')
    render.launches += 1
    return out


render.launches = 0
