"""POET-style parameterised terrain, batched over N levels.

Port of ``dcd_isaac_tpu/envs/walker/terrain.py:36-219``: a state machine
over GRASS / STUMP / STAIRS / PIT sections, 200 columns long, driven by the
8-d level parameters, emitting a heightfield and a fixed budget of 64
axis-aligned boxes (stumps, stair treads, pit walls).  Features are on
when their high bound passes the reference's thresholds (stumps 0.2, pits
0.8, stairs 0.2).

:func:`generate_terrain` is the plain twin of kernel B11
(``kernels/walker_terrain.py``).  It takes its random numbers as a draws
tensor (N, 200, 8) of uniforms in [0, 1), one row a column, one slot per
draw of JAX's column step (the JAX package draws the stair slope and the
step count from one key; the port gives them separate slots):

    0 grass velocity    1 pit gap        2 stump height   3 stair height
    4 stair slope coin  5 stair steps    6 next counter   7 next feature

A uniform u becomes U[lo, hi) as ``jax.random.uniform`` maps its own,
``max(lo, u * (hi - lo) + lo)``; an integer in [lo, hi) as
``lo + min(floor(u * (hi - lo)), hi - lo - 1)``; the next feature as the
``floor(u * k)``-th of the k enabled ones.  ``terrain_draws`` makes the
table from the level seeds by ``seeds.hash_uniform``, as the kernel does.
"""

from __future__ import annotations

import torch

from ..seeds import hash_uniform
from .physics import (
    MAX_BOXES, SCALE, TERRAIN_GRASS, TERRAIN_HEIGHT, TERRAIN_LENGTH,
    TERRAIN_STARTPAD, TERRAIN_STEP, Terrain, recip,
)

STUMP_WIDTH = 1.0
STUMP_FLOAT = 0.0
STAIR_WIDTH = 4
MAX_STAIR_STEPS = 9
NUM_SLOTS = 8

GRASS, STUMP, STAIRS, PIT = 0, 1, 2, 3
(SLOT_GRASS, SLOT_PIT, SLOT_STUMP, SLOT_STAIR_H, SLOT_SLOPE, SLOT_STEPS,
 SLOT_COUNTER, SLOT_FEATURE) = range(NUM_SLOTS)


def terrain_draws(seeds: torch.Tensor) -> torch.Tensor:
    """(N, 200, 8) uniforms of the levels' seeds (N,)."""
    dev = seeds.device
    col = torch.arange(TERRAIN_LENGTH, device=dev)[None, :, None]
    slot = torch.arange(NUM_SLOTS, device=dev)[None, None, :]
    return hash_uniform(seeds[:, None, None], col, slot)


def uniform_range(u, lo, hi):
    """jax.random.uniform's map of u in [0, 1) to [lo, hi)."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def randint_range(u, lo, hi):
    """An int32 in [lo, hi) from u (hi > lo)."""
    span = hi - lo
    k = torch.floor(u * span.float()).int()
    return lo + torch.minimum(k, span - 1)


def generate_terrain(params: torch.Tensor, draws: torch.Tensor) -> Terrain:
    """Level params (N, 8) and draws (N, 200, 8) → Terrain.

    params = [roughness, pit_lo, pit_hi, stump_lo, stump_hi, stair_lo,
              stair_hi, stair_steps]
    """
    n = params.shape[0]
    dev = params.device
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)
    i32 = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)
    roughness = params[:, 0]
    pit_lo = torch.minimum(params[:, 1], params[:, 2])
    pit_hi = torch.maximum(params[:, 1], params[:, 2])
    stump_lo = torch.minimum(params[:, 3], params[:, 4])
    stump_hi = torch.maximum(params[:, 3], params[:, 4])
    stair_lo = torch.minimum(params[:, 5], params[:, 6])
    stair_hi = torch.maximum(params[:, 5], params[:, 6])
    stair_steps_max = torch.round(params[:, 7]).int()
    # enabled features, in the order STUMP, STAIRS, PIT
    feat_on = torch.stack([stump_hi >= 0.2, stair_hi >= 0.2,
                           pit_hi >= 0.8], -1)
    n_on = feat_on.int().sum(-1)
    hardcore = n_on > 0
    feat_ids = torch.tensor([STUMP, STAIRS, PIT], dtype=torch.int32,
                            device=dev)
    rank = torch.cumsum(feat_on.int(), -1) - 1

    state, counter = i32(GRASS), i32(TERRAIN_STARTPAD)
    velocity, y = f(0.0), f(TERRAIN_HEIGHT)
    oneshot = torch.zeros(n, dtype=torch.bool, device=dev)
    original_y, pit_diff = f(0.0), f(0.0)
    st_h, st_slope, st_steps = f(0.0), f(1.0), i32(0)
    boxes = torch.zeros((n, MAX_BOXES, 4), device=dev)
    n_boxes = i32(0)
    rows = torch.arange(n, device=dev)
    ys, x_shifts = [], []

    def emit_box(boxes, n_boxes, x0, y0, x1, y1, cond):
        """Write the box where ``cond`` (in place) at each level's next
        slot (the last slot once 64 are used); count it."""
        if bool(cond.any()):
            idx = torch.clamp(n_boxes, max=MAX_BOXES - 1).long()
            box = torch.stack([torch.minimum(x0, x1), torch.minimum(y0, y1),
                               torch.maximum(x0, x1), torch.maximum(y0, y1)],
                              -1)
            boxes[rows[cond], idx[cond]] = box[cond]
        return boxes, n_boxes + cond.int()

    for i in range(TERRAIN_LENGTH):
        u = draws[:, i]
        x = f(float(i)) * TERRAIN_STEP

        # --- GRASS --------------------------------------------------------
        is_grass = (state == GRASS) & ~oneshot
        v_new = 0.8 * velocity + 0.01 * torch.sign(TERRAIN_HEIGHT - y)
        if i > TERRAIN_STARTPAD:
            v_new = v_new + uniform_range(u[:, SLOT_GRASS], f(-1.0),
                                          f(1.0)) * recip(SCALE)
        velocity = torch.where(is_grass, v_new, velocity)
        y = torch.where(is_grass, y + roughness * velocity, y)

        # Each section runs only where some level is in its state (the
        # masks select the same values either way).
        # --- PIT oneshot --------------------------------------------------
        is_pit_one = (state == PIT) & oneshot
        if bool(is_pit_one.any()):
            pit_gap = 1.0 + uniform_range(u[:, SLOT_PIT], pit_lo, pit_hi)
            new_counter = torch.ceil(pit_gap).int()
            pd = new_counter.float() - pit_gap
            boxes, n_boxes = emit_box(
                boxes, n_boxes, x, y - 4 * TERRAIN_STEP, x + TERRAIN_STEP, y,
                is_pit_one)
            boxes, n_boxes = emit_box(
                boxes, n_boxes, x + TERRAIN_STEP * pit_gap,
                y - 4 * TERRAIN_STEP, x + TERRAIN_STEP * (1 + pit_gap), y,
                is_pit_one)
            counter = torch.where(is_pit_one, new_counter + 2, counter)
            pit_diff = torch.where(is_pit_one, pd, pit_diff)
            original_y = torch.where(is_pit_one, y, original_y)

        # --- PIT continue -------------------------------------------------
        is_pit = (state == PIT) & ~oneshot
        shift = f(0.0)
        if bool(is_pit.any()):
            y = torch.where(is_pit, torch.where(
                counter > 1, original_y - 4 * TERRAIN_STEP, original_y), y)
            shift_here = is_pit & (counter == 1)
            shift = torch.where(shift_here, -pit_diff * TERRAIN_STEP, shift)
            pit_diff = torch.where(shift_here, f(0.0), pit_diff)
        x_shifts.append(shift)

        # --- STUMP oneshot ------------------------------------------------
        is_stump = (state == STUMP) & oneshot
        if bool(is_stump.any()):
            stump_h = uniform_range(u[:, SLOT_STUMP], stump_lo, stump_hi)
            boxes, n_boxes = emit_box(
                boxes, n_boxes, x, y + STUMP_FLOAT * TERRAIN_STEP,
                x + STUMP_WIDTH * TERRAIN_STEP,
                y + (stump_h + STUMP_FLOAT) * TERRAIN_STEP, is_stump)

        # --- STAIRS oneshot -----------------------------------------------
        is_stairs_one = (state == STAIRS) & oneshot
        if bool(is_stairs_one.any()):
            sh = uniform_range(u[:, SLOT_STAIR_H], stair_lo, stair_hi)
            slope = torch.where(u[:, SLOT_SLOPE] > 0.5, f(1.0), f(-1.0))
            ss = randint_range(u[:, SLOT_STEPS], i32(0),
                               torch.clamp(stair_steps_max, min=1))
            big = sh > 1e-2
            for s in range(MAX_STAIR_STEPS):
                cond = is_stairs_one & big & (s < ss)
                y_top = y + (s * sh * slope) * TERRAIN_STEP
                boxes, n_boxes = emit_box(
                    boxes, n_boxes, x + (s * STAIR_WIDTH) * TERRAIN_STEP,
                    y_top - sh * TERRAIN_STEP,
                    x + ((1 + s) * STAIR_WIDTH) * TERRAIN_STEP, y_top, cond)
            counter = torch.where(is_stairs_one & big, ss * STAIR_WIDTH + 1,
                                  counter)
            st_h = torch.where(is_stairs_one, sh, st_h)
            st_slope = torch.where(is_stairs_one, slope, st_slope)
            st_steps = torch.where(is_stairs_one, ss, st_steps)
            original_y = torch.where(is_stairs_one, y, original_y)

        # --- STAIRS continue ----------------------------------------------
        is_stairs = (state == STAIRS) & ~oneshot
        if bool(is_stairs.any()):
            n_step = torch.div(st_steps * STAIR_WIDTH - counter, STAIR_WIDTH,
                               rounding_mode='floor')
            y_stairs = (original_y
                        + (n_step.float() * st_h * st_slope) * TERRAIN_STEP
                        - torch.where(st_slope < 0, st_h, f(0.0))
                        * TERRAIN_STEP)
            y = torch.where(is_stairs, y_stairs, y)

        # --- emit height, advance counter and state -----------------------
        ys.append(y)
        counter = counter - 1
        next_counter = randint_range(u[:, SLOT_COUNTER],
                                     i32(TERRAIN_GRASS // 2),
                                     i32(TERRAIN_GRASS))
        rollover = counter == 0
        if bool(rollover.any()):
            k = torch.clamp(
                torch.floor(u[:, SLOT_FEATURE] * n_on.float()).int(),
                max=torch.clamp(n_on - 1, min=0))
            # the k-th enabled feature, in the order STUMP, STAIRS, PIT
            pick = (feat_on & (rank == k[:, None])).int().argmax(-1)
            feature = torch.where(hardcore, feat_ids[pick], i32(GRASS))
            state = torch.where(
                rollover, torch.where((state == GRASS) & hardcore, feature,
                                      i32(GRASS)), state)
            counter = torch.where(rollover, next_counter, counter)
        oneshot = rollover
        n_boxes = torch.clamp(n_boxes, max=MAX_BOXES)

    xs = (torch.arange(TERRAIN_LENGTH, dtype=torch.float32, device=dev)
          * TERRAIN_STEP)[None, :] + torch.stack(x_shifts, 1)
    return Terrain(xs=xs, ys=torch.stack(ys, 1), boxes=boxes,
                   n_boxes=n_boxes)
