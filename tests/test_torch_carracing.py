"""The port's CarRacing engine against the JAX package, on the CPU.

Control points, cars and actions come from numpy and go to both sides.
Track building (the ccw sort, the Bézier samples, ``build_track``, the
start tile), the frame rasterizer, the 8-substep car step with its
rewards, ring buffer and time limit, the Beta distribution with kernel
B7's Beta branch, the student CNN at converted weights and the host-side
track complexity are compared.  The JAX functions run compiled through
``no_fma`` (``test_torch_walker.py``): the port rounds every product on
its own, as its kernels do, where XLA's CPU backend would fuse a multiply
and an add.  JAX still computes its Bézier einsum and its nearest-point
cross term as dot products, whose rounding the port does not copy, so
track points agree to a few float32 ulps of their size (about 170 units)
and the rasterized classes may differ only where a pixel's squared
distance lies near a class boundary or a tie between two tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcd_isaac_tpu.envs.carracing.adversarial as jax_adv
import dcd_isaac_tpu.envs.carracing.bezier as jax_bezier
import dcd_isaac_tpu.envs.carracing.env as jax_env
import dcd_isaac_tpu.envs.carracing.track as jax_track
from dcd_isaac_tpu.envs.carracing import AdversarialCarRacing as JaxCarRacing
from dcd_isaac_tpu.envs.carracing import CarRacingUEDParams as JaxParams
from dcd_isaac_tpu.models import distributions as jdist
from dcd_isaac_tpu.models.car_racing_models import (
    CarRacingNetwork as JaxNetwork,
)
from dcd_isaac_tpu.utils.geo_complexity import (
    batch_track_complexity as jax_complexity,
)
from dcd_isaac_tpu_torch.convert import from_flax_carracing
from dcd_isaac_tpu_torch.envs.carracing import bezier, track as tr
from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
    RANDOM_DRAWS, TRIES, AdversarialCarRacing, build_level_plain,
)
from dcd_isaac_tpu_torch.envs.carracing.dynamics import CarState
from dcd_isaac_tpu_torch.envs.carracing.env import (
    CarRacingConfig, CarRacingState, step as env_step,
)
from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
from dcd_isaac_tpu_torch.models import distributions as dist
from dcd_isaac_tpu_torch.models.car_racing_models import CarRacingNetwork
from dcd_isaac_tpu_torch.utils.geo_complexity import batch_track_complexity
from test_torch_walker import no_fma

PLAYFIELD = float(tr.PLAYFIELD)
TRACES = 'tests/fixtures/carracing_box2d_traces.npz'
CLIP = 0.2


def t(x):
    return torch.tensor(np.asarray(x))


_COMPILED = {}


def compiled(name, make):
    """One jitted, FMA-free JAX function per name for the module."""
    if name not in _COMPILED:
        _COMPILED[name] = jax.jit(no_fma(make()))
    return _COMPILED[name]


def jax_build(cps, n, start_alpha):
    """JAX ``_bezier_track_padded`` and ``_closest_track_index`` of a batch
    of levels."""
    def one(c, k, s):
        trk = jax_adv._bezier_track_padded(c, k, 480)
        return trk, jax_adv._closest_track_index(trk, c, k, s)
    return compiled('build', lambda: jax.vmap(one))(
        jnp.asarray(cps, jnp.float32), jnp.asarray(n, jnp.int32),
        jnp.asarray(start_alpha, jnp.float32))


def random_cps(rng, count):
    return (rng.random((count, 12, 2)) * PLAYFIELD).astype(np.float32)


def track_from_jax(jt) -> tr.Track:
    return tr.Track(points=t(jt.points), beta=t(jt.beta),
                    border=t(jt.border), valid=t(jt.valid),
                    n_points=t(jt.n_points).int(), offset=t(jt.offset))


# -- tracks ------------------------------------------------------------------

def assert_tracks_match(cps, n, start_alpha):
    """points and offsets within 1e-5 of the track's extent (a few float32
    ulps of ~170 units: JAX's einsum rounds in another order); betas, the
    angles of the steps between points, within the angle that twice that
    error subtends over the step (|Δβ| · step length ≤ 2e-5 · extent,
    modulo 2π); valid, counts and start tiles equal; border flags equal except
    on levels where some |Δβ| lies within 1e-5 of the mean |Δβ| (the
    threshold), which are counted and must be few."""
    jt, js = jax_build(cps, n, start_alpha)
    got, start, car = build_level_plain(t(cps), t(n).int(), t(start_alpha))
    scale = float(np.abs(np.asarray(jt.points)).max())
    np.testing.assert_allclose(got.points.numpy(), np.asarray(jt.points),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got.offset.numpy(), np.asarray(jt.offset),
                               atol=1e-5 * scale, rtol=0)
    pts = np.asarray(jt.points, np.float64)
    step = np.linalg.norm(np.roll(pts, -1, 1) - pts, axis=-1)
    dbeta = np.abs(np.angle(np.exp(1j * (got.beta.numpy().astype(np.float64)
                                         - np.asarray(jt.beta)))))
    assert (dbeta * step <= 2e-5 * scale).all()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_array_equal(got.n_points.numpy(),
                                  np.asarray(jt.n_points))
    np.testing.assert_array_equal(start.numpy(), np.asarray(js))
    # a border flag may differ only on a level where the two sides' step
    # angles put some turn on other sides of the mean-|Δβ| threshold, or
    # turn it the other way
    def turns(beta, valid):
        beta = np.asarray(beta, np.float64)
        db = np.abs(np.roll(beta, -1, 1) - beta)
        mean = np.where(valid, db, 0).sum(1) / np.maximum(valid.sum(1), 1)
        d = beta - np.roll(beta, 1, 1)
        return np.abs(d) > mean[:, None], np.sign(d)
    valid = np.asarray(jt.valid)
    (big_g, sign_g), (big_j, sign_j) = (turns(got.beta.numpy(), valid),
                                        turns(jt.beta, valid))
    near = ((big_g != big_j) | (sign_g != sign_j)).any(1)
    differ = (got.border.numpy() != np.asarray(jt.border)).any(1)
    assert not (differ & ~near).any()
    assert differ.sum() <= max(1, len(n) // 20)
    rows = np.arange(len(n))
    np.testing.assert_allclose(
        car.pos.numpy(), np.asarray(jt.points)[rows, np.asarray(js)],
        atol=1e-5 * scale, rtol=0)
    return got


@pytest.mark.parametrize('k', [3, 7, 12])
def test_bezier_tracks_match_jax(k):
    """256 random control-point sets of k points, start angles set on half
    (JAX adversarial.py:46-87)."""
    rng = np.random.default_rng(k)
    cps = random_cps(rng, 256)
    alpha = np.where(np.arange(256) % 2 == 0,
                     rng.random(256) * 2 * np.pi, -1.0).astype(np.float32)
    got = assert_tracks_match(cps, np.full(256, k, np.int32), alpha)
    assert int(got.n_points[0]) == 39 * k   # a tile per step, joins masked
    assert int(got.border.sum()) > 0


def test_build_track_matches_jax():
    """``build_track`` of the same curves (JAX's Bézier samples): points
    and offsets bit-equal, betas = π/2 + atan2 within an ulp of each term
    (the port's atan2 is rounded from double, XLA's is float32's), the border flags equal
    except where some |Δβ| lies within 1e-6 of the mean (JAX sums the 480
    |Δβ| in another order), counted."""
    rng = np.random.default_rng(9)
    jt, _ = jax_build(random_cps(rng, 64), np.full(64, 12, np.int32),
                      np.full(64, -1.0, np.float32))
    curve = np.asarray(jt.points) + np.asarray(jt.offset)[:, None]
    curve = curve.astype(np.float32)
    valid = np.arange(480)[None] < 480
    want = compiled('build_track', lambda: jax.vmap(jax_track.build_track))(
        curve, np.broadcast_to(valid, (64, 480)))
    got = tr.build_track(t(curve), t(np.broadcast_to(valid, (64, 480))))
    for f in ('points', 'offset', 'valid', 'n_points'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    wb = np.asarray(want.beta)
    alpha = wb - np.float32(np.pi / 2)
    assert (np.abs(got.beta.numpy() - wb)
            <= np.spacing(np.abs(alpha)) + np.spacing(np.abs(wb))).all()
    beta = np.asarray(want.beta, np.float64)
    v = np.asarray(want.valid)
    db = np.abs(np.roll(beta, -1, 1) - beta)
    mean = np.where(v, db, 0).sum(1) / np.maximum(v.sum(1), 1)
    near = (np.abs(np.abs(beta - np.roll(beta, 1, 1)) - mean[:, None])
            < 1e-6).any(1)
    differ = (got.border.numpy() != np.asarray(want.border)).any(1)
    assert not (differ & ~near).any() and near.sum() <= 2
    assert int(got.border.sum()) > 0


def test_box2d_trace_tracks_match_jax():
    """The control points of the Box2D reference traces."""
    d = np.load(TRACES)
    cps = np.stack([d[k] for k in sorted(d.files)
                    if k.endswith('/control_points')]).astype(np.float32)
    n = cps.shape[0]
    assert_tracks_match(cps, np.full(n, 12, np.int32),
                        np.full(n, -1.0, np.float32))


def test_levels_carry_over_from_jax():
    """Levels (cps, n, start_alpha, goal_bin, seed) that the JAX package
    drew and encoded build the same tracks and cars in the port: the seed
    takes no part in a CarRacing track (unlike the walker's terrain)."""
    jenv = JaxCarRacing()
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    jstates, _ = jax.jit(jax.vmap(jenv.reset_random))(keys)
    levels = np.asarray(jax.vmap(jenv.get_level)(jstates)).copy()
    levels[::2, 25] = np.linspace(0.5, 5.5, 4)         # start angles set
    levels[1::2, 23] = [3, 5, 9, 11]                   # fewer points
    jst, _ = compiled('reset_to_level',
                      lambda: jax.vmap(jenv.reset_to_level))(levels)
    env = AdversarialCarRacing()
    st, _ = env.reset_to_level(t(levels))
    scale = float(np.abs(np.asarray(jst.track.points)).max())
    np.testing.assert_allclose(st.track.points.numpy(),
                               np.asarray(jst.track.points),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(st.track.valid.numpy(),
                                  np.asarray(jst.track.valid))
    np.testing.assert_allclose(st.car.pos.numpy(), np.asarray(jst.car.pos),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(st.car.angle.numpy(),
                               np.asarray(jst.car.angle), atol=2e-4)
    np.testing.assert_array_equal(env.get_level(st).numpy(), levels)
    assert (st.level_seed.numpy() == levels[:, 27].astype(np.int64)).all()


class FakeRandom:
    """``jax.random`` for ``random_control_points``: a key is (level,
    trial); ``split`` numbers the trials and ``uniform`` reads the trial's
    (12, 2) uniforms from a table."""

    def __init__(self, table):
        self.table = jnp.asarray(table)

    def split(self, rng, num):
        return jnp.stack([jnp.broadcast_to(rng[0], (num,)),
                          jnp.arange(num, dtype=jnp.int32)], 1)

    def uniform(self, key, shape):
        return self.table[key[0], key[1]].reshape(shape)


def test_random_control_points_from_injected_uniforms(monkeypatch):
    """The rejection rule (first trial at least 0.7/12 apart, else the
    best) picks the same trial from the same (100, 12, 2) uniforms, and
    the chosen (unsorted) points come back scaled by the playfield."""
    rng = np.random.default_rng(5)
    n = 64
    u = rng.random((n, TRIES, 12, 2)).astype(np.float32)
    u[:8, :] = u[:8, :1]                  # trials that cluster…
    u[:8, :, 1] = u[:8, :, 0] + 1e-3      # …so none passes: the best wins
    fake = FakeRandom(u)
    monkeypatch.setattr(jax.random, 'split', fake.split)
    monkeypatch.setattr(jax.random, 'uniform', fake.uniform)
    want = jax.jit(jax.vmap(lambda i: jax_bezier.random_control_points(
        i[None], 12, scale=jax_adv.PLAYFIELD)))(
        jnp.arange(n, dtype=jnp.int32))
    monkeypatch.undo()
    got = bezier.random_control_points(t(u), scale=tr.PLAYFIELD)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    draws = np.concatenate([u.reshape(n, -1), rng.random((n, 2))], 1)
    env = AdversarialCarRacing()
    st, obs = env.reset_random(n, draws=t(draws).float())
    lv = env.get_level(st).numpy()
    np.testing.assert_array_equal(lv[:, :24], np.asarray(want).reshape(n, -1))
    assert (lv[:, 24] == 12).all() and (lv[:, 25] == -1).all()
    assert draws.shape[1] == RANDOM_DRAWS


# -- the rasterizer ------------------------------------------------------------

def cars_on_tracks(rng, jt, per_track):
    """per_track cars on each track (numpy dict of batched car fields):
    on a random valid tile, moved across the road by 0 (road), the track
    width + 0.6 (a border's band), 15 (grass) or 400 units (off the
    field) in turn, with random heading, speed, spin, wheel speeds and
    steering (the indicator bars)."""
    pts, beta = np.asarray(jt.points), np.asarray(jt.beta)
    n_pts = np.asarray(jt.n_points)
    k = len(pts) * per_track
    lv = np.repeat(np.arange(len(pts)), per_track)
    tile = (rng.random(k) * n_pts[lv]).astype(np.int64)
    nrm = beta[lv, tile]
    off = np.array([0.0, tr.TRACK_WIDTH + 0.6, 15.0, 400.0])[np.arange(k) % 4]
    off = off * np.where(np.arange(k) % 8 < 4, 1.0, -1.0)
    pos = pts[lv, tile] + off[:, None] * np.stack([np.cos(nrm),
                                                   np.sin(nrm)], -1)
    u = lambda *s: rng.uniform(-1, 1, s)
    f = lambda x: np.asarray(x, np.float32)
    return lv, dict(pos=f(pos), angle=f(nrm + u(k) * 0.5),
                    vel=f(u(k, 2) * 60), angvel=f(u(k) * 4),
                    wheel_omega=f(u(k, 4) * 150), steer_angle=f(u(k) * 0.42))


def ambiguous_pixels(track, car, t_, rows, cols):
    """Whether each (row, col) pixel's squared distance lies within 0.05
    of a class boundary (TRACK_WIDTH², (TRACK_WIDTH + BORDER)²) or of a
    tie between two tiles: float64 distances of the pixel's world
    point."""
    z = 0.1 * tr.SCALE * max(1 - t_, 0) + tr.ZOOM * tr.SCALE * min(t_, 1)
    ex = (cols - 48.0) / (z * 96 / 1000)
    ey = ((95.0 - rows) - 24.0) / (z * 96 / 800)
    a = float(car['angle'])
    wx = car['pos'][0] + ex * np.cos(a) - ey * np.sin(a)
    wy = car['pos'][1] + ex * np.sin(a) + ey * np.cos(a)
    p = np.asarray(track.points, np.float64)[np.asarray(track.valid)]
    d2 = np.sort((wx[:, None] - p[:, 0]) ** 2 + (wy[:, None] - p[:, 1]) ** 2,
                 axis=1)
    b1, b2 = tr.TRACK_WIDTH ** 2, (tr.TRACK_WIDTH + tr.BORDER) ** 2
    return ((np.abs(d2[:, 0] - b1) < 0.05) | (np.abs(d2[:, 0] - b2) < 0.05)
            | (d2[:, 1] - d2[:, 0] < 0.05))


@pytest.mark.parametrize('t_', [0.0, 0.5, 2.0])
def test_render_frame_matches_jax(t_):
    """64 cars on 16 tracks at time t (the zoom ramp): the uint8 frames
    equal but at pixels whose squared distance lies within 0.05 of a class
    boundary or of a two-tile tie (fewer than 0.1 % of all pixels), and
    the preprocessed frames bit-equal where the uint8 frames are."""
    rng = np.random.default_rng(int(t_ * 10) + 1)
    jt, _ = jax_build(random_cps(rng, 16), np.full(16, 12, np.int32),
                      np.full(16, -1.0, np.float32))
    lv, car = cars_on_tracks(rng, jt, 4)
    jtrack = jax.tree.map(lambda x: np.asarray(x)[lv], jt)
    k = len(lv)
    want = compiled('render', lambda: jax.vmap(jax_track.render_frame))(
        jtrack, car['pos'], car['angle'], car['vel'], car['angvel'],
        car['wheel_omega'], car['steer_angle'], np.full(k, t_, np.float32))
    want = np.asarray(want)
    z = torch.zeros(k)
    pcar = CarState(**{k_: t(v) for k_, v in car.items()}, gas=z,
                    fuel_spent=z)
    got = tr.render_frame(track_from_jax(jtrack), pcar,
                          torch.full((k,), t_)).numpy()
    bad = np.argwhere((got != want).any(-1))
    for i in np.unique(bad[:, 0]):
        px = bad[bad[:, 0] == i]
        one = jax.tree.map(lambda x: x[i], jtrack)
        assert ambiguous_pixels(one, {k_: v[i] for k_, v in car.items()},
                                t_, px[:, 1].astype(float),
                                px[:, 2].astype(float)).all()
    assert len(bad) < 1e-3 * k * 96 * 96
    cfg = CarRacingConfig()
    same = (got == want).all(-1)
    np.testing.assert_array_equal(
        jax_env._preprocess(jax_env.CarRacingConfig(), want)[same],
        pl_preprocess(cfg, got)[same])
    # every layer shows: road, grass, border red, the hull, the bars
    assert (got[..., 1] == 102).any() and (got[..., 1] == 204).any()
    assert ((got[..., 0] == 255) & (got[..., 1] == 0)).any()
    assert ((got[..., 0] == 204) & (got[..., 1] == 0)).any()
    assert (got[:, 84:, 5, :] == 255).any()


def pl_preprocess(cfg, frame_u8):
    from dcd_isaac_tpu_torch.envs.carracing.env import preprocess
    return preprocess(cfg, t(frame_u8)).numpy()


@pytest.mark.parametrize('crop,gray', [(True, False), (False, True),
                                       (True, True)])
def test_preprocess_variants_match_jax(crop, gray):
    """Crop (84 × 84) and grayscale of the same uint8 frames, bit-equal."""
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    jcfg = jax_env.CarRacingConfig(crop=crop, grayscale=gray)
    cfg = CarRacingConfig(crop=crop, grayscale=gray)
    want = np.asarray(jax.jit(no_fma(jax.vmap(
        lambda f: jax_env._preprocess(jcfg, f))))(u8))
    np.testing.assert_array_equal(pl_preprocess(cfg, u8), want)


# -- the car step ------------------------------------------------------------

def state_from_jax(js) -> CarRacingState:
    """A batched JAX CarRacingState → the port's (the teacher's design
    scratch left out)."""
    c = js.car
    car = CarState(pos=t(c.pos), angle=t(c.angle), vel=t(c.vel),
                   angvel=t(c.angvel), wheel_omega=t(c.wheel_omega),
                   steer_angle=t(c.steer_angle), gas=t(c.gas),
                   fuel_spent=t(c.fuel_spent))
    f = {k: t(getattr(js, k)) for k in (
        'visited', 'tile_visited_count', 'reward_total', 'prev_reward', 't',
        'inner_steps', 'reward_history', 'hist_ptr', 'frames', 'done_latch',
        'goal_bin', 'goal_reached', 'sparse_accum', 'control_points')}
    for k in ('tile_visited_count', 'inner_steps', 'hist_ptr', 'goal_bin'):
        f[k] = f[k].int()
    return CarRacingState(car=car, track=track_from_jax(js.track),
                          level_seed=t(js.level_seed).int(), **f)


def step_cases(rng, cfg_kw, n_tracks=16, per_track=16):
    """JAX states of per_track cars on each of n_tracks random tracks
    (``cars_on_tracks``), a few set up to finish (every tile visited but
    those under the wheels, at rest), to leave the playfield, to end
    early (a ring of -0.2 rewards) and to meet the TimeLimit; the actions
    random with gas most of the time."""
    jenv = JaxCarRacing(JaxParams(cfg=jax_env.CarRacingConfig(**cfg_kw)))
    cps = random_cps(rng, n_tracks)
    levels = np.concatenate([
        cps.reshape(n_tracks, -1), np.full((n_tracks, 1), 12.0),
        -np.ones((n_tracks, 1)), -np.ones((n_tracks, 1)),
        np.arange(n_tracks)[:, None]], 1).astype(np.float32)
    if cfg_kw.get('sparse_rewards'):
        levels[:, 26] = np.arange(n_tracks) % 24
    js, _ = compiled(f'reset_{sorted(cfg_kw.items())}', lambda: jax.vmap(
        jenv.reset_to_level))(levels)
    lv, car = cars_on_tracks(rng, js.track, per_track)
    js = jax.tree.map(lambda x: np.asarray(x)[lv].copy(), js)
    k = len(lv)
    for f, v in car.items():
        getattr(js.car, f)[...] = v
    js.car.gas[...] = rng.random(k)
    js.t[...] = rng.random(k) * 3
    js.inner_steps[...] = rng.integers(0, 900, k)
    js.reward_total[...] = rng.normal(size=k) * 10
    js.prev_reward[...] = js.reward_total - rng.random(k)
    js.hist_ptr[...] = rng.integers(0, 300, k)
    js.reward_history[...] = rng.normal(size=(k, 100)) * 0.1
    js.visited[...] = rng.random((k, 480)) < 0.3
    js.tile_visited_count[...] = js.visited.sum(1)
    # the special cases
    fin = np.arange(k) % 16 == 1
    js.car.pos[fin] = js.track.points[fin, 5]
    js.car.angle[fin] = js.track.beta[fin, 5]
    js.car.vel[fin] = 0.0
    js.visited[fin] = True
    wx, wy = [x.numpy() for x in jax_wheels(js)]
    p = js.track.points
    for i in np.flatnonzero(fin):
        d2 = ((wx[i][:, None] - p[i, :, 0]) ** 2
              + (wy[i][:, None] - p[i, :, 1]) ** 2)
        d2[:, ~js.track.valid[i]] = np.inf
        js.visited[i, d2.argmin(1)] = False
    js.tile_visited_count[fin] = js.visited[fin].sum(1)
    off = np.arange(k) % 16 == 2
    js.car.pos[off] = [tr.PLAYFIELD - 0.5, 0.0]
    js.car.vel[off] = [80.0, 0.0]
    early = np.arange(k) % 16 == 3
    js.reward_history[early] = -0.2
    limit = np.arange(k) % 16 == 4
    js.inner_steps[limit] = 995
    done = np.arange(k) % 16 == 5
    js.done_latch[done] = True
    actions = rng.random((k, 3)).astype(np.float32)
    actions[:, 0] = actions[:, 0] * 2 - 1
    actions[:, 2] = np.where(actions[:, 2] < 0.8, 0.0, actions[:, 2])
    return jenv, js, actions, dict(finish=fin, off=off, early=early,
                                   limit=limit, done=done)


def jax_wheels(js):
    from dcd_isaac_tpu_torch.envs.carracing.dynamics import wheel_positions
    return wheel_positions(state_from_jax(js).car)


@pytest.mark.parametrize('cfg_kw', [
    {}, {'sparse_rewards': True, 'reward_shaping': False,
         'num_goal_bins': 24, 'clip_reward': 2.0}],
    ids=['dense', 'sparse_clip'])
def test_step_matches_jax(cfg_kw):
    """One control step (8 substeps) of 256 cars: the car state within
    1e-4 relative (and 1e-4 absolute near zero), visited tiles, counts,
    done, truncation, the ring pointer and the goal flags equal, the
    rewards, the ring and the sparse sums within 1e-4; the frames as the
    rasterizer test holds them.  Cases: wheels on the grass, tiles
    newly visited, the finish, off the playfield, early termination, the
    TimeLimit, an episode already done; the dense rewards of the configs,
    and the sparse goal bins with a reward clip of 2."""
    rng = np.random.default_rng(len(cfg_kw) + 7)
    jenv, js, actions, cases = step_cases(rng, cfg_kw)
    want = compiled(f'step_{sorted(cfg_kw.items())}', lambda: jax.vmap(
        jenv.step))(js, actions)
    jst, jframes, jr, jd, info = want
    cfg = CarRacingConfig(**cfg_kw)
    st, frames, r, d, tr_ = env_step(cfg, state_from_jax(js), t(actions))
    close = lambda a, b, name: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-4,
        atol=1e-4, err_msg=name)
    for f in ('pos', 'angle', 'vel', 'angvel', 'wheel_omega', 'steer_angle',
              'gas', 'fuel_spent'):
        close(getattr(st.car, f), getattr(jst.car, f), f)
    for f in ('reward_total', 'prev_reward', 't', 'reward_history',
              'sparse_accum'):
        close(getattr(st, f), getattr(jst, f), f)
    for f in ('visited', 'tile_visited_count', 'inner_steps', 'hist_ptr',
              'done_latch', 'goal_reached'):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)
    close(r, jr, 'reward')
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(info['truncated']))
    assert (frames.numpy() != np.asarray(jframes)).any(-1).mean() < 1e-3
    new = (st.tile_visited_count.numpy() > js.tile_visited_count)
    dn = d.numpy()
    assert new.any() and dn[cases['off']].all() and dn[cases['done']].all()
    if not cfg_kw.get('sparse_rewards'):
        assert dn[cases['finish']].all()
    if not cfg_kw:
        assert dn[cases['early']].all()
        assert (r.numpy()[cases['finish']] > 50).all()
    assert tr_.numpy()[cases['limit']].any()
    wx, wy = jax_wheels(js)
    assert (~tr.on_road(track_from_jax(js.track), wx, wy)[0]).any()
    if cfg_kw.get('sparse_rewards'):
        assert st.goal_reached.any()


# -- the Beta policy and kernel B7's Beta branch -----------------------------

def beta_rows(seed, R=64):
    """Alphas and betas in [1, 9), unscaled actions in [0, 1] with some at
    the clip edges, ties of the ratio and of the values."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = (1 + 8 * rng.random((R, 3))).astype(np.float32)
    b = (1 + 8 * rng.random((R, 3))).astype(np.float32)
    u = rng.random((R, 3)).astype(np.float32)
    u[:8, 0], u[8:16, 1] = 0.0, 1.0
    lp = np.asarray(jdist.beta_log_prob(a, b, u))
    old_lp = (lp + f(R) * 0.3).astype(np.float32)
    old_lp[16:24] = lp[16:24]                   # ratio exactly 1 (JAX side)
    values = f(R)
    old_v = values + f(R) * 0.3
    old_v[24:32] = values[24:32]                # value ties
    return dict(alpha=a, beta=b, values=values, u=u, old_lp=old_lp,
                old_v=old_v, returns=values + f(R), advs=f(R))


def test_beta_log_prob_entropy_mode_and_sample():
    x = beta_rows(0)
    a, b, u = x['alpha'], x['beta'], x['u']
    np.testing.assert_allclose(
        dist.beta_log_prob(t(a), t(b), t(u)).numpy(),
        np.asarray(jdist.beta_log_prob(a, b, u)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dist.beta_entropy(t(a), t(b)).numpy(),
                               np.asarray(jdist.beta_entropy(a, b)),
                               rtol=1e-5, atol=1e-5)
    a[:4, 0], b[:4, 0] = [0.5, 2.0, 0.7, 1.0], [0.5, 0.6, 3.0, 1.0]
    np.testing.assert_allclose(dist.beta_mode(t(a), t(b)).numpy(),
                               np.asarray(jdist.beta_mode(a, b)), atol=1e-6)
    g = torch.Generator().manual_seed(3)
    s = dist.beta_sample(t(a[:1]).expand(100_000, 3),
                         t(b[:1]).expand(100_000, 3), g)
    np.testing.assert_allclose(s.mean(0).numpy(),
                               a[0] / (a[0] + b[0]), atol=5e-3)


@pytest.mark.parametrize('R', [500, 2000])
def test_beta_means_need_double_rows(R):
    """Why kernel B7's Beta rows run in double: with a quarter of the
    actions at the clip edges, where (a - 1) log x reaches ~100, rows
    computed in float32 and summed in double put the surrogate's or the
    entropy's mean more than 1e-6 relative off the float64 rows' (the
    tolerance that holds the kernel against the float64 twin); the twins
    of both types clamp the ratio at the same float32 bounds."""
    assert pl.ratio_bounds(CLIP) == (float(np.float32(1 - CLIP)),
                                     float(np.float32(1 + CLIP)))
    worst = 0.0
    for seed in range(5):
        x = beta_rows(100 + seed, R)
        edge = np.random.default_rng(seed).random((R, 3))
        x['u'] = np.where(edge < 0.125, 0.0,
                          np.where(edge > 0.875, 1.0, x['u'])
                          ).astype(np.float32)
        f32, f64 = (beta_row_means(x, dtype)
                    for dtype in (torch.float32, torch.float64))
        worst = max(worst, float(((f32 - f64).abs() / f64.abs()).max()))
    assert worst > 1e-6


def beta_row_means(x, dtype):
    """The surrogate's and the entropy's means of rows computed in
    ``dtype``, summed in double as the kernel sums them."""
    a, b, u, old_lp, adv = (t(x[k]).to(dtype) for k in (
        'alpha', 'beta', 'u', 'old_lp', 'advs'))
    ratio = torch.exp(dist.beta_log_prob(a, b, u) - old_lp)
    surr = torch.minimum(ratio * adv,
                         ratio.clamp(*pl.ratio_bounds(CLIP)) * adv)
    return torch.stack([surr.double().mean(),
                        dist.beta_entropy(a, b).double().mean()])


def jax_beta_loss(alpha, beta, values, u, old_lp, old_v, returns, advs,
                  clip_value_loss, entropy_coef):
    """dcd_isaac_tpu/algos/ppo.py:loss_fn after the model (:99-114) with
    CarRacingNetwork.log_prob_entropy."""
    from dcd_isaac_tpu.algos import ppo as jax_ppo
    new_lp = jdist.beta_log_prob(alpha, beta, u)
    entropy = jdist.beta_entropy(alpha, beta).mean()
    ratio = jnp.exp(new_lp - old_lp)
    surr1 = ratio * advs
    surr2 = jnp.clip(ratio, 1.0 - CLIP, 1.0 + CLIP) * advs
    action_loss = -jnp.minimum(surr1, surr2).mean()
    if clip_value_loss:
        clipped = old_v + jnp.clip(values - old_v, -CLIP, CLIP)
        vloss = 0.5 * jnp.maximum((values - returns) ** 2,
                                  (clipped - returns) ** 2).mean()
    else:
        vloss = jax_ppo.smooth_l1(values, returns).mean()
    loss = vloss * 0.5 + action_loss - entropy * entropy_coef
    return loss, (vloss, action_loss, entropy)


@pytest.mark.parametrize('clip_value_loss', [True, False])
@pytest.mark.parametrize('entropy_coef', [0.0, 0.01])
def test_ppo_loss_beta_matches_jax_grad(clip_value_loss, entropy_coef):
    """The loss and its terms within 1e-5 relative, and the gradients to
    the alphas, the betas and the values within 1e-5 of jax.grad's largest
    entry plus 1e-5 relative (B7's tolerance)."""
    x = beta_rows(1)
    (loss, aux), grads = jax.value_and_grad(
        jax_beta_loss, argnums=(0, 1, 2), has_aux=True)(
        *x.values(), clip_value_loss, entropy_coef)
    leaves = [t(x[k]).requires_grad_() for k in ('alpha', 'beta', 'values')]
    out = pl.ppo_loss_beta(*leaves, *(t(x[k]) for k in (
        'u', 'old_lp', 'old_v', 'returns', 'advs')), CLIP, clip_value_loss,
        0.5, entropy_coef)
    for got, want in zip(out, (loss, *aux)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-6)
    for g, w in zip(torch.autograd.grad(out[0], leaves), grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert np.abs(np.asarray(grads[0])).max() > 0


def test_ppo_loss_beta_hand_backward_matches_autograd():
    """The kernel's backward in tensor ops (digamma, trigamma) against
    autograd through the plain forward, every output differentiated."""
    x = beta_rows(2)
    leaves = [t(x[k]).double().requires_grad_()
              for k in ('alpha', 'beta', 'values')]
    rest = [t(x[k]).double() for k in ('u', 'old_lp', 'old_v', 'returns',
                                        'advs')]
    out = pl.ppo_loss_beta_plain(*leaves, *rest, CLIP, True, 0.5, 0.01)
    g_out = torch.tensor([1.0, 0.3, -0.7, 0.2], dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, g_out.unbind())
    got = pl.ppo_loss_beta_plain_backward(
        g_out, *(v.detach() for v in leaves), *rest, CLIP, True, 0.5, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-12)


# -- the student network -----------------------------------------------------

@pytest.mark.parametrize('crop', [False, True])
def test_network_matches_flax_at_converted_weights(crop):
    """Forward (alpha, beta, value) within 1e-5 and the gradients of a
    scalar of all three to every parameter within 1e-5 relative to each
    one's largest entry, for the RGB and the crop variants."""
    hw = 84 if crop else 96
    jnet = JaxNetwork(crop=crop)
    obs = np.random.default_rng(4).uniform(
        -1, 1, (6, hw, hw, 12)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(1), obs, (), None)
    net = CarRacingNetwork(obs_shape=(hw, hw, 12), crop=crop)
    net.load_state_dict(from_flax_carracing(jax.tree.map(np.asarray,
                                                         params)))
    w = np.random.default_rng(5).normal(size=(3, 6, 3)).astype(np.float32)

    def scalar(out, value):
        return ((out['alpha'] * w[0]).sum() + (out['beta'] * w[1]).sum()
                + (value * w[2][:, 0]).sum())

    def jloss(p):
        out, value, _ = jnet.apply(p, obs, (), None)
        return scalar(out, value), (out, value)
    (_, (jout, jvalue)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        params)
    out, value, _ = net({'obs': t(obs)})
    for k in ('alpha', 'beta'):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue),
                               atol=1e-5, rtol=1e-5)
    loss = (out['alpha'] * t(w[0])).sum() + (out['beta'] * t(w[1])).sum() \
        + (value * t(w[2][:, 0])).sum()
    loss.backward()
    want = from_flax_carracing(jax.tree.map(np.asarray, jgrad))
    for name, p in net.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)


def test_network_action_scaling_and_sample():
    net = CarRacingNetwork()
    u = torch.rand(5, 3)
    a = net.scale(u)
    assert (a[:, 0] >= -1).all() and (a[:, 1:] >= 0).all()
    torch.testing.assert_close(net.unscale(a), u, atol=1e-6, rtol=0)
    out = {'alpha': torch.full((5, 3), 2.0), 'beta': torch.full((5, 3), 3.0)}
    act, lp = net.sample_action(out, torch.Generator().manual_seed(0))
    torch.testing.assert_close(lp, net.log_prob(out, act), atol=1e-5,
                               rtol=1e-5)


# -- the host-side track complexity ------------------------------------------

def test_track_complexity_matches_jax():
    """The port's copy of utils/geo_complexity.py against the JAX package's
    on the same tracks, exactly."""
    rng = np.random.default_rng(8)
    jt, _ = jax_build(random_cps(rng, 8), rng.integers(3, 13, 8),
                      np.full(8, -1.0, np.float32))
    pts, valid = np.asarray(jt.points), np.asarray(jt.valid)
    assert batch_track_complexity(pts, valid) == jax_complexity(pts, valid)
