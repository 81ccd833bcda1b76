"""The port's BipedalWalker engine against the JAX package, on the CPU.

Terrain: the JAX ``generate_terrain`` draws from ``jax.random``; this file
replaces ``jax`` inside the JAX terrain and env modules (the JAX files are
not edited) by a namespace whose ``random`` is ``FakeRandom``: its keys
are (seed, column, tag) triples and its ``uniform`` / ``randint`` /
``categorical`` map one uniform per (seed, column, slot) exactly as the
port's ``terrain.py`` does.  The
uniforms come from a numpy table, or from the port's seed hash written
again in ``jnp`` uint32 arithmetic (``jnp_hash_uniform``), so that JAX's
``reset_walker`` builds the port's terrains and placements.  The physics
step, lidar and whole env step are compared one step at a time from states
that the JAX walker reached by random actions on flat, rough, stump, stair
and pit terrains; ``mutate_level`` and ``reset_random`` with their draws
injected the same way; and the port replays the eight Box2D traces of
``tests/fixtures/walker_box2d_traces.npz`` inside the envelopes
``tests/test_walker_box2d_parity.py`` sets for the JAX walker.

The JAX functions run compiled through ``no_fma``: XLA's CPU backend
contracts a float multiply and add into one fused multiply-add, which the
JAX package does not ask for and the port (and its kernels, which round
every operation on their own) does not do; ``no_fma`` re-traces a function
with every float product passed through an integer identity that the
compiler cannot see through, so each product is rounded before its sum.
Everything else is the JAX package's own arithmetic, including XLA's
division by a constant as a product with its float32 reciprocal, which
the port copies.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from jax.extend import core as jcore
import pytest
import torch

import dcd_isaac_tpu.envs.seeds as jax_seeds
import dcd_isaac_tpu.envs.walker.adversarial as jax_adv
import dcd_isaac_tpu.envs.walker.env as jax_env
import dcd_isaac_tpu.envs.walker.physics as jph
import dcd_isaac_tpu.envs.walker.terrain as jax_terrain
from dcd_isaac_tpu.envs.walker import AdversarialWalker as JaxWalker
from dcd_isaac_tpu.envs.walker import WalkerParams as JaxWalkerParams
from dcd_isaac_tpu_torch.envs import seeds
from dcd_isaac_tpu_torch.envs.walker import physics as ph
from dcd_isaac_tpu_torch.envs.walker import terrain as tr
from dcd_isaac_tpu_torch.envs.walker.adversarial import (
    AdversarialWalker, WalkerParams, mutate_draws,
)
from dcd_isaac_tpu_torch.envs.walker.env import (
    WalkerState, hull_origin, place_walker, placement_draw,
    step_walker_plain,
)
from dcd_isaac_tpu_torch.kernels import walker_terrain

# One level of each kind: flat, rough, stumps, stairs, pits, and all three
# features at the full ranges' top.
LEVELS = {
    'flat': [0, 0, 0, 0, 0, 0, 0, 1],
    'rough': [6.0, 0, 0, 0, 0, 0, 0, 1],
    'stump': [1.0, 0, 0, 0.5, 2.0, 0, 0, 1],
    'stairs': [0.5, 0, 0, 0, 0, 0.5, 1.5, 6.4],
    'pit': [0.5, 1.0, 4.0, 0, 0, 0, 0, 1],
    'hardcore': [10.0, 0, 10.0, 0, 5.0, 0, 5.0, 9.0],
}


# -- the JAX package without contracted multiply-adds ---------------------

def _sub_jaxprs(p):
    if isinstance(p, jcore.ClosedJaxpr):
        return _no_fma_closed(p)
    if isinstance(p, tuple) and p and all(
            isinstance(q, jcore.ClosedJaxpr) for q in p):
        return tuple(_no_fma_closed(q) for q in p)
    return p


def _round_alone(x):
    """x, through an integer xor with a data-dependent zero (the compiler
    cannot fuse a product into a sum across it)."""
    i = jax.lax.bitcast_convert_type(x, jnp.int32)
    flip = (i == jnp.int32(0x7FC0BEEF)).astype(jnp.int32)   # never set
    return jax.lax.bitcast_convert_type(i ^ flip, x.dtype)


def _eval_no_fma(jaxpr, consts, *args):
    env = {}
    read = lambda v: v.val if isinstance(v, jcore.Literal) else env[v]
    for v, c in zip(jaxpr.constvars, consts):
        env[v] = c
    for v, a in zip(jaxpr.invars, args):
        env[v] = a
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == 'custom_jvp_call':
            # a custom JVP (softplus's logaddexp): its primal jaxpr inline
            cj = eqn.params['call_jaxpr']
            outs = _eval_no_fma(cj.jaxpr, cj.consts,
                                *[read(v) for v in eqn.invars])
            for v, o in zip(eqn.outvars, outs):
                env[v] = o
            continue
        params = {k: _sub_jaxprs(p) for k, p in eqn.params.items()}
        out = eqn.primitive.bind(*[read(v) for v in eqn.invars], **params)
        if (eqn.primitive.name == 'mul'
                and out.dtype == jnp.float32):
            out = _round_alone(out)
        outs = out if eqn.primitive.multiple_results else [out]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
    return [read(v) for v in jaxpr.outvars]


def _no_fma_closed(cj):
    avals = [jax.ShapeDtypeStruct(v.aval.shape, v.aval.dtype)
             for v in cj.jaxpr.invars]
    return jax.make_jaxpr(
        lambda *a: _eval_no_fma(cj.jaxpr, cj.consts, *a))(*avals)


def no_fma(f):
    """``f`` with every float32 product rounded before it is summed."""
    def g(*args):
        flat, tree = jax.tree.flatten(args)
        cj, shape = jax.make_jaxpr(
            lambda *fl: f(*jax.tree.unflatten(tree, fl)),
            return_shape=True)(*flat)
        outs = _eval_no_fma(cj.jaxpr, cj.consts, *flat)
        return jax.tree.unflatten(jax.tree.structure(shape), outs)
    return g


# -- jax.random inside the JAX walker modules ----------------------------

def jnp_hash_uniform(seed, col, slot):
    """envs/seeds.py:hash_uniform in jnp uint32 arithmetic."""
    u32 = lambda v: jnp.asarray(v).astype(jnp.uint32)
    h = (u32(seed) * jnp.uint32(0x9E3779B1) + u32(col) * jnp.uint32(0x7F4A7C15)
         + u32(slot) * jnp.uint32(0x2545F491) + jnp.uint32(0x6A09E667))
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).astype(jnp.float32) * jnp.float32(2.0 ** -24)


class FakeRandom:
    """``jax.random`` for the JAX terrain and env modules.  A key is
    (seed, column, tag): tag 0 a column's carry, 50 its second carry,
    10 + slot a draw; ``PRNGKey(seed)`` splits into the terrain's carry
    (seed, 0, 0) and the placement's draw (seed, 200, 10).  ``uniform_of
    (seed, column, slot)`` gives the uniform of a draw."""

    def __init__(self, uniform_of):
        self.uof = uniform_of

    @staticmethod
    def PRNGKey(seed):
        return jnp.stack([jnp.asarray(seed).astype(jnp.uint32),
                          jnp.uint32(0), jnp.uint32(1)])

    @staticmethod
    def split(key, num=2):
        s, c, tag = key[0], key[1], key[2]
        k = lambda *v: jnp.stack([jnp.asarray(x, jnp.uint32) for x in v])
        if num == 2:        # PRNGKey(seed) → terrain carry, placement draw
            return jnp.stack([k(s, 0, 0), k(s, 200, 10)])
        if num == 6:        # a column: its second carry and slots 0-4
            return jnp.stack([k(s, c, 50)] + [k(s, c, 10 + i)
                                               for i in range(5)])
        assert num == 3     # the next column's carry, slots 6 and 7
        return jnp.stack([k(s, c + 1, 0), k(s, c, 16), k(s, c, 17)])

    def _u(self, key, slot=None):
        slot = key[2].astype(jnp.int32) - 10 if slot is None else slot
        return self.uof(key[0], key[1].astype(jnp.int32), slot)

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        lo = jnp.asarray(minval, jnp.float32)
        hi = jnp.asarray(maxval, jnp.float32)
        return jnp.maximum(lo, self._u(key) * (hi - lo) + lo)

    def randint(self, key, shape, minval, maxval):
        slot = key[2].astype(jnp.int32) - 10
        slot = jnp.where(slot == 4, 5, slot)   # the step count's own slot
        span = jnp.asarray(maxval, jnp.int32) - jnp.asarray(minval,
                                                              jnp.int32)
        k = jnp.floor(self._u(key, slot) * span.astype(jnp.float32)
                      ).astype(jnp.int32)
        return minval + jnp.minimum(k, span - 1)

    def categorical(self, key, logits):
        on = jnp.isfinite(logits)
        n_on = on.sum()
        k = jnp.minimum(jnp.floor(self._u(key) * n_on.astype(jnp.float32)
                                  ).astype(jnp.int32),
                        jnp.maximum(n_on - 1, 0))
        return jnp.argmax(on & (jnp.cumsum(on) - 1 == k))


def fake_jax(uniform_of):
    return SimpleNamespace(random=FakeRandom(uniform_of), lax=jax.lax)


@pytest.fixture
def hashed_terrain(monkeypatch):
    """JAX's walker builds the port's terrains and placements."""
    fake = fake_jax(jnp_hash_uniform)
    monkeypatch.setattr(jax_terrain, 'jax', fake)
    monkeypatch.setattr(jax_env, 'jax', fake)


def table_terrain(monkeypatch, draws):
    """JAX's terrain draws the (200, 8) table ``draws``."""
    table = jnp.asarray(draws)
    monkeypatch.setattr(jax_terrain, 'jax', fake_jax(
        lambda seed, col, slot: table[col, slot]))


# -- conversions -----------------------------------------------------------

def t(x):
    return torch.tensor(np.asarray(x))


def port_terrain(terr) -> ph.Terrain:
    """A batch of JAX Terrains (leading axis) → the port's."""
    return ph.Terrain(xs=t(terr.xs), ys=t(terr.ys), boxes=t(terr.boxes),
                      n_boxes=t(terr.n_boxes).int())


def port_state(js) -> WalkerState:
    """A batch of JAX WalkerStates → the port's."""
    b = js.bodies
    return WalkerState(
        bodies=ph.Bodies(pos=t(b.pos), angle=t(b.angle), vel=t(b.vel),
                         angvel=t(b.angvel)),
        terrain=port_terrain(js.terrain), prev_shaping=t(js.prev_shaping),
        game_over=t(js.game_over), step_count=t(js.step_count).int(),
        lower_contact=t(js.lower_contact), joint_angle=t(js.joint_angle),
        joint_speed=t(js.joint_speed), level_params=t(js.level_params),
        level_seed=t(js.level_seed).int(),
        adv_step_count=t(js.adv_step_count).int())


def close(a, b, atol, name=''):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0,
                               err_msg=name)


# -- seeds -----------------------------------------------------------------

def test_seeds_round_trip_and_range():
    g = torch.Generator().manual_seed(0)
    s = seeds.draw_seed(4096, g)
    assert s.dtype == torch.int32
    assert int(s.min()) >= 0 and int(s.max()) < seeds.SEED_MAX
    assert torch.equal(seeds.f32_to_seed(seeds.seed_to_f32(s)), s)
    # the JAX package's cast of the same values
    js = jnp.asarray(s.numpy()).astype(jnp.uint32)
    assert np.array_equal(np.asarray(jax_seeds.seed_to_f32(js)),
                          seeds.seed_to_f32(s).numpy())
    assert np.array_equal(
        np.asarray(jax_seeds.f32_to_seed(jax_seeds.seed_to_f32(js))),
        s.numpy().astype(np.uint32))
    u = torch.tensor([0.0, 0.5, 1.0 - 2 ** -24])
    assert seeds.draw_seed(3, u=u).tolist() == [0, 1 << 23, (1 << 24) - 1]


def test_hash_uniform_matches_its_jnp_copy():
    """The port's draws and the jnp copy the JAX side is given agree bit
    for bit (and are uniforms in [0, 1))."""
    s = torch.tensor([0, 1, 12345, seeds.SEED_MAX - 1])
    col = torch.arange(201)
    u = seeds.hash_uniform(s[:, None, None], col[None, :, None],
                           torch.arange(8)[None, None, :])
    want = jnp_hash_uniform(jnp.asarray(s.numpy())[:, None, None],
                            jnp.arange(201)[None, :, None],
                            jnp.arange(8)[None, None, :])
    assert np.array_equal(u.numpy(), np.asarray(want))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


# -- terrain ---------------------------------------------------------------

@pytest.mark.parametrize('kind', list(LEVELS))
def test_terrain_matches_jax_on_one_draws_table(monkeypatch, kind):
    """xs, ys, boxes and n_boxes exactly equal from one (200, 8) table."""
    draws = np.random.default_rng(len(kind)).random(
        (ph.TERRAIN_LENGTH, tr.NUM_SLOTS)).astype(np.float32)
    table_terrain(monkeypatch, draws)
    params = np.asarray(LEVELS[kind], np.float32)
    want = jax.jit(no_fma(jax_terrain.generate_terrain))(
        jnp.asarray(params), jnp.zeros(3, jnp.uint32))
    got = tr.generate_terrain(t(params)[None], t(draws)[None])
    for f in ('xs', 'ys', 'boxes', 'n_boxes'):
        assert np.array_equal(getattr(got, f)[0].numpy(),
                              np.asarray(getattr(want, f))), f
    if kind in ('stump', 'stairs', 'pit', 'hardcore'):
        assert int(got.n_boxes[0]) > 0


def test_kernel_entry_point_takes_the_twins_on_cpu(hashed_terrain):
    """B11's wrapper on CPU tensors: the terrain of ``terrain_draws`` and the
    placement of ``placement_draw``, equal to JAX's reset of the same
    (params, seed) under the hashed draws."""
    params = torch.tensor([LEVELS[k] for k in LEVELS], dtype=torch.float32)
    s = torch.tensor([3, 77, 1 << 20, 5, 999, 123456], dtype=torch.int32)
    terr, bodies = walker_terrain.generate(params, s)
    want = jax.jit(no_fma(jax.vmap(
        lambda p, sd: jax_env.reset_walker(p, sd, 2000))))(
        jnp.asarray(params.numpy()), jnp.asarray(s.numpy(), jnp.uint32))
    for f in ('xs', 'ys', 'boxes', 'n_boxes'):
        assert np.array_equal(getattr(terr, f).numpy(),
                              np.asarray(getattr(want.terrain, f))), f
    pw = jax.jit(no_fma(jax.vmap(jax_env.place_walker)))(jax.vmap(
        lambda sd: FakeRandom.split(FakeRandom.PRNGKey(sd))[1])(
            jnp.asarray(s.numpy(), jnp.uint32)))
    for f in ('pos', 'angle', 'vel', 'angvel'):
        assert np.array_equal(getattr(bodies, f).numpy(),
                              np.asarray(getattr(pw, f))), f
    assert torch.equal(bodies.vel[:, 0, 0],
                       place_walker(placement_draw(s)).vel[:, 0, 0])


# -- physics ---------------------------------------------------------------

@pytest.fixture(scope='module')
def states():
    """JAX walker states reached by random actions on each LEVELS terrain:
    for each level and each step count in ``n_steps``, the state after that
    many steps from the level's reset (hashed draws), then the first two of
    those states of each level with boxes moved onto its first box
    (``on_first_box``) → (stacked states, the next actions)."""
    with pytest.MonkeyPatch.context() as mp:
        fake = fake_jax(jnp_hash_uniform)
        mp.setattr(jax_terrain, 'jax', fake)
        mp.setattr(jax_env, 'jax', fake)
        yield jax_states()


def jax_states(n_steps=(0, 5, 20, 60), seed=0):
    rng = np.random.default_rng(seed)
    params = jnp.asarray([LEVELS[k] for k in LEVELS], jnp.float32)
    n = params.shape[0]
    st = jax.jit(no_fma(jax.vmap(
        lambda p, sd: jax_env.reset_walker(p, sd, 2000))))(
        params, jnp.arange(n, dtype=jnp.uint32) + 11)
    step = jax.jit(no_fma(jax.vmap(jax_env.step_walker)))
    states, actions = [], []
    for k in range(max(n_steps) + 1):
        a = jnp.asarray(rng.uniform(-1, 1, (n, 4)), jnp.float32)
        if k in n_steps:
            states.append(st)
            actions.append(a)
        st = step(st, a)[0]
    boxed = np.flatnonzero(np.asarray(st.terrain.n_boxes) > 0)
    for k in range(2):
        states.append(jax.tree.map(lambda x: x[boxed],
                                   on_first_box(states[k])))
        actions.append(actions[k][boxed])
    cat = lambda *xs: jnp.concatenate(xs)
    return jax.tree.map(cat, *states), cat(*actions)


def on_first_box(js):
    """The JAX states ``js`` with every walker moved, all bodies together,
    so that its left lower leg stands centred on its level's first box (a
    stump, a stair's tread or a pit's wall), its lowest corner 1 cm deep:
    states whose contacts are with boxes, which a walk from the start
    reaches only after many steps."""
    b = port_state(js).bodies
    foot = ph.world_vertices(b)[:, 2, :4]                  # (N, 4, 2)
    box = t(js.terrain.boxes)[:, 0]
    shift = torch.stack([(box[:, 0] + box[:, 2]) / 2 - foot[..., 0].mean(1),
                         box[:, 3] - 0.01 - foot[..., 1].amin(1)], -1)
    return js.replace(bodies=js.bodies.replace(
        pos=js.bodies.pos + jnp.asarray(shift.numpy())[:, None, :]))


def box_contacts(st: WalkerState) -> int:
    """Candidates in contact with a box in the port's states ``st``."""
    _, _, pen, on_box = ph.contact_candidates(st.bodies, st.terrain)
    return int((on_box & (pen > 0)).sum())


def test_physics_step_matches_jax(states):
    """physics_step from 32 states (6 terrains × 4 points of a random
    walk, 8 on boxes) within 1e-4 of JAX on positions, angles and velocities (a
    float32 solver run 40 sweeps; cos/sin and sums may differ by an ulp),
    contacts exactly."""
    js, a = states
    speed = jnp.sign(a) * jnp.asarray(jph.JOINT_SPEED, jnp.float32)
    torque = jph.MOTORS_TORQUE * jnp.clip(jnp.abs(a), 0.0, 1.0)
    want = jax.jit(no_fma(jax.vmap(jph.physics_step)))(
        js.bodies, js.terrain, speed, torque)
    st = port_state(js)
    got = ph.physics_step(st.bodies, st.terrain, t(speed), t(torque))
    for f in ('pos', 'angle', 'vel', 'angvel'):
        close(getattr(got[0], f), getattr(want[0], f), 1e-4, f)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[2], want[2], 1e-4, 'joint_angle')
    close(got[3], want[3], 1e-4, 'joint_speed')
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))
    assert bool(got[1].any())          # feet on the ground in some states


def test_contacts_and_lidar_match_jax(states):
    js, _ = states
    st = port_state(js)
    pts, normal, pen, _ = ph.contact_candidates(st.bodies, st.terrain)
    wp, wn, wpen, _ = jax.jit(no_fma(jax.vmap(jph._contact_candidates)))(
        js.bodies, js.terrain)
    close(pts, wp, 1e-5, 'points')
    close(normal, wn, 1e-5, 'normals')
    close(pen, wpen, 1e-5, 'penetration')
    lid = ph.lidar(st.bodies, st.terrain)
    close(lid, jax.jit(no_fma(jax.vmap(jph.lidar)))(js.bodies, js.terrain),
          1e-5, 'lidar')
    assert float(lid.min()) < 1.0      # some rays hit
    assert box_contacts(st) > 0


def test_step_walker_matches_jax(states):
    """The whole env step (kernel B10's plain twin): state, obs, reward,
    done and finish from the same states, 1e-4 on floats; some of the
    states touch boxes."""
    js, a = states
    want = jax.jit(no_fma(jax.vmap(jax_env.step_walker)))(js, a)
    assert box_contacts(port_state(js)) > 0
    got = step_walker_plain(port_state(js), t(a))
    close(got[0].bodies.pos, want[0].bodies.pos, 1e-4, 'pos')
    close(got[0].prev_shaping, want[0].prev_shaping, 1e-4, 'shaping')
    assert torch.equal(got[0].step_count, t(want[0].step_count).int())
    close(got[1], want[1], 1e-4, 'obs')
    close(got[2], want[2], 1e-4, 'reward')
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))
    close(hull_origin(got[0].bodies),
          jax.vmap(jax_env.hull_origin)(want[0].bodies), 1e-4, 'origin')


# -- the UED env -----------------------------------------------------------

def test_reset_to_level_and_get_level_round_trip(hashed_terrain):
    """reset_to_level → get_level gives the level back (POET masks params
    5-7, as JAX does); the state and obs equal JAX's reset of the level."""
    levels = np.array([LEVELS[k] + [s] for k, s in zip(
        LEVELS, (0, 1, 2 ** 23, 7, 4242, seeds.SEED_MAX - 1))], np.float32)
    for poet in (False, True):
        env = AdversarialWalker(WalkerParams(poet=poet))
        jenv = JaxWalker(JaxWalkerParams(poet=poet))
        st, obs = env.reset_to_level(t(levels))
        want = levels.copy()
        if poet:
            want[:, 5:8] = 0.0
        assert np.array_equal(env.get_level(st).numpy(), want)
        jst, jobs = jax.jit(no_fma(jax.vmap(jenv.reset_to_level)))(
            jnp.asarray(levels))
        close(obs['obs'], jobs, 1e-5, 'reset obs')
        close(st.bodies.pos, jst.bodies.pos, 1e-5, 'reset pos')
        assert np.array_equal(env.get_level(st).numpy(),
                              np.asarray(jax.vmap(jenv.get_level)(jst)))
        st2, obs2 = env.reset_agent(st)
        assert torch.equal(obs2['obs'], obs['obs'])


def table_random(monkeypatch, table, layout):
    """``jax.random`` inside the JAX adversarial and seeds modules: key
    (i, e, tag) of level i; ``layout(key)`` → the column of ``table`` (N, K)
    its draw reads."""
    table = jnp.asarray(table)

    def u(key):
        return table[key[0].astype(jnp.int32), layout(key)]

    def split(key, num=2):
        i, e = key[0], key[1]
        return jnp.stack([jnp.stack([i, e + 1, jnp.uint32(0)])] + [
            jnp.stack([i, e, jnp.uint32(j)]) for j in range(1, num)])

    def uniform(key, shape=(), minval=0.0, maxval=1.0):
        lo = jnp.asarray(minval, jnp.float32)
        hi = jnp.asarray(maxval, jnp.float32)
        if shape:
            x = table[key[0].astype(jnp.int32), :shape[0]]
        else:
            x = u(key)
        return jnp.maximum(lo, x * (hi - lo) + lo)

    def randint(key, shape, minval, maxval):
        span = jnp.asarray(maxval) - jnp.asarray(minval)
        k = jnp.floor(u(key) * span.astype(jnp.float32)).astype(jnp.int32)
        return minval + jnp.minimum(k, span - 1)

    fake = SimpleNamespace(random=SimpleNamespace(
        split=split, uniform=uniform, randint=randint), lax=jax.lax)
    monkeypatch.setattr(jax_adv, 'jax', fake)
    monkeypatch.setattr(jax_seeds, 'jax', fake)


@pytest.mark.parametrize('poet', [False, True])
def test_mutate_level_matches_jax(monkeypatch, hashed_terrain, poet):
    """3 edits and a new seed from one uniform table, both sides; then the
    levels, states and obs equal."""
    n, edits = 6, 3
    rng = np.random.default_rng(7)
    draws = rng.random((n, mutate_draws(edits))).astype(np.float32)
    # key (i, e, j): edit e's draw j (1 param, 2 direction, 3 magnitude);
    # after the edits (i, edits, 0) is the seed's
    table_random(monkeypatch, draws,
                 lambda k: jnp.where(k[2] == 0, 3 * edits,
                                     3 * k[1].astype(jnp.int32)
                                     + k[2].astype(jnp.int32) - 1))
    levels = np.array([LEVELS[k] + [5] for k in LEVELS], np.float32)
    env = AdversarialWalker(WalkerParams(poet=poet))
    jenv = JaxWalker(JaxWalkerParams(poet=poet))
    st, _ = env.reset_to_level(t(levels))
    st, obs = env.mutate_level(st, edits, draws=t(draws))
    jst, _ = jax.jit(no_fma(jax.vmap(jenv.reset_to_level)))(
        jnp.asarray(levels))
    keys = jnp.stack([jnp.arange(n, dtype=jnp.uint32),
                      jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32)], 1)
    jst, jobs = jax.jit(no_fma(jax.vmap(
        lambda s, k: jenv.mutate_level(s, k, edits))))(jst, keys)
    assert np.array_equal(env.get_level(st).numpy(),
                          np.asarray(jax.vmap(jenv.get_level)(jst)))
    close(obs['obs'], jobs, 1e-5, 'obs')
    assert not np.array_equal(env.get_level(st).numpy()[:, :8],
                              levels[:, :8])


@pytest.mark.parametrize('mode', ['full', 'easy'])
def test_reset_random_matches_jax(monkeypatch, hashed_terrain, mode):
    n = 5
    draws = np.random.default_rng(8).random((n, 9)).astype(np.float32)
    # key (i, 1, 0) the params' uniforms (columns 0-7), (i, 0, 1) the seed's
    table_random(monkeypatch, draws, lambda k: jnp.int32(8))
    env = AdversarialWalker(WalkerParams(mode=mode))
    jenv = JaxWalker(JaxWalkerParams(mode=mode))
    st, obs = env.reset_random(n, draws=t(draws))
    keys = jnp.stack([jnp.arange(n, dtype=jnp.uint32),
                      jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32)], 1)
    jst, jobs = jax.jit(no_fma(jax.vmap(jenv.reset_random)))(keys)
    assert np.array_equal(env.get_level(st).numpy(),
                          np.asarray(jax.vmap(jenv.get_level)(jst)))
    close(obs['obs'], jobs, 1e-5, 'obs')


def test_step_truncates_at_the_limit():
    env = AdversarialWalker(WalkerParams(mode='easy', max_steps=3))
    st, _ = env.reset_random(2, torch.Generator().manual_seed(1), 'cpu')
    for k in range(3):
        st, _, _, done, info = env.step(st, torch.zeros(2, 4))
    assert done.all() and (info['truncated'] | (st.game_over)).all()


# -- Box2D traces ----------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'walker_box2d_traces.npz')
TRACES = ['flat_stand', 'flat_gait', 'flat_random', 'rough_stand',
          'rough_gait', 'box_step_gait', 'box_step_random', 'box_wall_stand']


@pytest.fixture(scope='module')
def box2d():
    return np.load(FIXTURE)


@pytest.fixture(scope='module')
def box2d_replays(box2d):
    return replay_box2d(box2d)


def replay_box2d(data, extra_steps=120):
    """The port's walker from each recorded Box2D initial state, the eight
    traces as one batch (as test_walker_box2d_parity.py replays the JAX
    walker one by one) → {name: (hull origins, joint angles, fall step)}."""
    g = lambda name, k: data[f'{name}/{k}']
    n = len(TRACES)
    f = lambda x: torch.tensor(np.asarray(x, np.float32))
    init = np.stack([g(name, 'init_bodies') for name in TRACES])
    boxes = np.zeros((n, ph.MAX_BOXES, 4), np.float32)
    n_boxes = np.zeros(n, np.int32)
    for i, name in enumerate(TRACES):
        if f'{name}/boxes' in data.files:
            rb = g(name, 'boxes')
            boxes[i, :len(rb)] = rb
            n_boxes[i] = len(rb)
    st = WalkerState(
        bodies=ph.Bodies(pos=f(init[..., 2:4]), angle=f(init[..., 4]),
                         vel=f(init[..., 5:7]), angvel=f(init[..., 7])),
        terrain=ph.Terrain(
            xs=f(np.stack([g(name, 'terrain_x') for name in TRACES])),
            ys=f(np.stack([g(name, 'terrain_y') for name in TRACES])),
            boxes=torch.tensor(boxes), n_boxes=torch.tensor(n_boxes)),
        prev_shaping=f([g(name, 'prev_shaping') for name in TRACES]),
        game_over=torch.zeros(n, dtype=torch.bool),
        step_count=torch.zeros(n, dtype=torch.int32),
        lower_contact=torch.zeros((n, 2), dtype=torch.bool),
        joint_angle=torch.zeros((n, 4)), joint_speed=torch.zeros((n, 4)),
        level_params=torch.zeros((n, 8)),
        level_seed=torch.zeros(n, dtype=torch.int32),
        adv_step_count=torch.zeros(n, dtype=torch.int32))
    acts = [g(name, 'actions') for name in TRACES]
    T = max(len(a) for a in acts) + extra_steps
    A = np.stack([np.concatenate([a, np.tile(a[-1:], (T - len(a), 1))])
                  for a in acts], 1)                      # (T, n, 4)
    hull, joints, fall = [], [], [None] * n
    for k in range(T):
        st, _, _, done, _ = step_walker_plain(st, f(A[k]))
        hull.append(hull_origin(st.bodies).numpy())
        joints.append(st.joint_angle.numpy())
        for i in np.flatnonzero(done.numpy()):
            fall[i] = fall[i] or k + 1
        if all(fall):
            break
    hull, joints = np.array(hull), np.array(joints)
    return {name: (hull[:fall[i], i], joints[:fall[i], i], fall[i])
            for i, name in enumerate(TRACES) if fall[i]}


@pytest.mark.parametrize('name', TRACES)
def test_box2d_trace_envelopes(box2d, box2d_replays, name):
    """The envelopes of test_walker_box2d_parity.py: hull x within 0.07
    over 10 steps and 0.25 over 30, y within 0.45 over 30; the fall within
    35 % of Box2D's step (60 % for box_step_random); driven joints'
    correlation above 0.70 (mean 0.85) and RMSE below 0.40."""
    assert name in box2d_replays, f'{name}: the port\'s walker never fell'
    hull, joints, fall = box2d_replays[name]
    ref = box2d[f'{name}/hull']
    k10, k30 = min(10, len(hull), len(ref)), min(30, len(hull), len(ref))
    assert np.abs(hull[:k10, 0] - ref[:k10, 0]).max() < 0.07
    assert np.abs(hull[:k30, 0] - ref[:k30, 0]).max() < 0.25
    assert np.abs(hull[:k30, 1] - ref[:k30, 1]).max() < 0.45
    ref_T = len(box2d[f'{name}/actions'])
    frac = 0.60 if name == 'box_step_random' else 0.35
    assert abs(fall - ref_T) <= max(frac * ref_T, 8), (fall, ref_T)
    if name in ('flat_gait', 'flat_random', 'rough_gait', 'box_step_gait',
                'box_wall_stand'):
        rj = box2d[f'{name}/joints'][:, :4]
        k = min(len(joints), len(rj))
        corr = [np.corrcoef(joints[:k, j], rj[:k, j])[0, 1]
                for j in range(4)]
        rmse = [np.sqrt(((joints[:k, j] - rj[:k, j]) ** 2).mean())
                for j in range(4)]
        assert min(corr) > 0.70 and np.mean(corr) > 0.85, corr
        assert max(rmse) < 0.40, rmse
