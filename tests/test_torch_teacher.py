"""The teacher's side of the port against the JAX package and the reference
fixtures: the construction step (kernel B5's plain twin), the teacher
network with its fused input projection (kernel B4's plain twin and its
autograd backward) and the construction rollout.

Randomness is injected, never shared: numpy draws the move scripts, the
JAX package draws the start directions and ``random_z``, and the port gets
the same ones.  The JAX rollout takes its scripted moves by recognising
the per-step keys its scan splits off (see ``adversary_keys``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.algos import rollout as jax_rollout
from dcd_isaac_tpu.envs.multigrid import (
    AdversarialMultiGrid as JaxEnv, MultiGridParams as JaxParams,
)
from dcd_isaac_tpu.models.multigrid_models import (
    MultigridNetwork as JaxNetwork,
)
from dcd_isaac_tpu_torch.algos.rollout import make_adversary_rollout
from dcd_isaac_tpu_torch.convert import from_flax
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.constants import EMPTY, GOAL, WALL
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.envs.registry import make_env
from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
from dcd_isaac_tpu_torch.models.multigrid_models import MultigridNetwork
from test_torch_algos import SHORT_EPISODES, ScriptedJaxStudent
from test_torch_multigrid import STATE_FIELDS, assert_state_equal

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'multigrid_ref_traces.npz')
ADV_FIELDS = STATE_FIELDS + ('adv_max_steps',)
GOAL_LAST = dict(size=15, n_clutter=25, choose_goal_last=True)
GOAL_FIRST = dict(size=15, n_clutter=50)
VARIABLE = dict(size=15, n_clutter=60, choose_goal_last=True,
                resample_n_clutter=True)


# -- helpers (also used by test_torch_paired.py) -----------------------------

def teacher_pair(params: dict, hidden, n, seed=0):
    """A flax teacher at full width (conv-128 over the whole grid, scalar
    embed 10 of adversary_max_steps + 1, random_z 50), its params, and the
    port's teacher at those params."""
    p = JaxParams(**params)
    kw = dict(num_actions=p.adversary_action_dim, conv_filters=128,
              scalar_fc=10, scalar_dim=p.adversary_max_steps + 1,
              random_z_dim=p.random_z_dim, recurrent_hidden_size=hidden)
    jnet = JaxNetwork(**kw)
    obs = {'image': jnp.zeros((n, p.size, p.size, 3), jnp.uint8),
           'time_step': jnp.zeros((n,), jnp.int32),
           'random_z': jnp.zeros((n, p.random_z_dim))}
    jparams = jnet.init(jax.random.PRNGKey(seed), obs,
                        jnet.initial_carry((n,)), jnp.ones((n,)))
    net = MultigridNetwork(view_size=p.size, **kw)
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, jparams)))
    return jnet, jparams, net


def adversary_keys(rng, steps, n, z_dim=50):
    """The move keys JAX make_adversary_rollout splits off at each step,
    and the (steps, n, z_dim) ``random_z`` its step_adversary draws."""
    acts, zs = [], []
    draw_z = jax.vmap(lambda k: jax.random.uniform(
        jax.random.split(k, 4)[3], (z_dim,)))
    for _ in range(steps):
        rng, r_act, r_env = jax.random.split(rng, 3)
        acts.append(r_act)
        zs.append(np.asarray(draw_z(jax.random.split(r_env, n))))
    return jnp.stack(acts), np.stack(zs)


def move_script(rng, n, params: dict):
    """(T, n) int32 random moves whose agent move never lands on the goal,
    so no level takes the random fallback."""
    p = JaxParams(**params)
    dim, T = p.adversary_action_dim, p.adversary_max_steps
    locs = rng.integers(0, dim, (T, n))
    for i in range(n):
        amax = (locs[0, i] * p.n_clutter // dim + 2
                if p.resample_n_clutter else T)
        g_t, a_t = (amax - 2, amax - 1) if p.choose_goal_last else (0, 1)
        while locs[a_t, i] == locs[g_t, i]:
            locs[a_t, i] = rng.integers(0, dim)
    return locs.astype(np.int32)


def jax_reset(jenv, key, n):
    """JAX reset of n levels, and the draws that give the port the same."""
    jst, jobs = jax.vmap(jenv.reset)(jax.random.split(key, n))
    draws = {'start_dir': torch.tensor(np.asarray(jst.agent_start_dir)),
             'random_z': torch.tensor(np.asarray(jobs['random_z']))}
    return jst, jobs, draws


# -- (a) the reference fixtures -------------------------------------------

SCENARIOS = {
    'goal_last_25': GOAL_LAST,
    'goal_first_50': GOAL_FIRST,
    'dup_cells': dict(size=15, n_clutter=25),
    'opaque_25': dict(GOAL_LAST, see_through_walls=False),
}


# ids other than the bare scenario names, which tests/conftest.py marks slow
@pytest.mark.parametrize('name', list(SCENARIOS),
                         ids=[f'adv_{n}' for n in SCENARIOS])
def test_construction_replays_reference_fixtures(name):
    """The recorded teacher moves rebuild the recorded level byte for byte,
    with its placements and metrics (start direction pinned, as the JAX
    engine's golden-trace test pins it)."""
    data = np.load(FIXTURE)
    g = lambda k: data[f'{name}/{k}']
    env = AdversarialMultiGrid(MultiGridParams(**SCENARIOS[name]))
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(1, gen, 'cpu')
    for t, a in enumerate(g('adv_actions')):
        assert int(obs['time_step'][0]) == t
        state, obs, done = env.step_adversary(state, torch.tensor([int(a)]),
                                              gen)
    assert bool(done[0])
    d = torch.tensor([int(g('agent_start_dir'))], dtype=torch.int32)
    state = state.replace(agent_start_dir=d)
    np.testing.assert_array_equal(env.get_level(state)[0].numpy(),
                                  g('encoding'))
    np.testing.assert_array_equal(state.agent_start_pos[0].numpy(),
                                  g('agent_start_pos'))
    np.testing.assert_array_equal(state.goal_pos[0].numpy(), g('goal_pos'))
    assert bool(state.passable[0]) == bool(g('passable'))
    assert int(state.shortest_path_length[0]) == int(
        g('shortest_path_length'))
    assert int(state.n_clutter_placed[0]) == int(g('n_clutter_placed'))


# -- (b) batched moves against jax.vmap(step_adversary) -------------------

@pytest.mark.parametrize('params', [GOAL_LAST, GOAL_FIRST, VARIABLE],
                         ids=['goal_last', 'goal_first', 'variable_blocks'])
def test_step_adversary_matches_jax(params):
    """Whole constructions of 48 levels from random moves: every state
    field, the adversary image, time step and done equal JAX's at every
    move."""
    n = 48
    jenv = JaxEnv(JaxParams(**params))
    env = AdversarialMultiGrid(MultiGridParams(**params))
    key = jax.random.PRNGKey(3)
    jst, jobs, draws = jax_reset(jenv, key, n)
    st, obs = env.reset(n, torch.Generator().manual_seed(0), 'cpu', draws)
    assert_state_equal(st, jst, ADV_FIELDS)
    np.testing.assert_array_equal(obs['image'].numpy(), jobs['image'])
    np.testing.assert_array_equal(obs['random_z'].numpy(), jobs['random_z'])

    locs = move_script(np.random.default_rng(1), n, params)
    jstep = jax.jit(jax.vmap(jenv.step_adversary))
    gen = torch.Generator().manual_seed(1)
    rows = torch.arange(n)
    on_wall = 0        # goal or agent moves onto a wall
    for t in range(len(locs)):
        keys = jax.random.split(jax.random.fold_in(key, t), n)
        jst, jobs, jdone = jstep(jst, jnp.asarray(locs[t]), keys)
        loc = torch.tensor(locs[t])
        cell = st.grid[rows, loc % 13 + 1, loc // 13 + 1]
        st, obs, done = env.step_adversary(st, loc, gen)
        assert_state_equal(st, jst, ADV_FIELDS)
        for k in ('image', 'time_step'):
            np.testing.assert_array_equal(obs[k].numpy(), jobs[k], k)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        amax = st.adv_max_steps
        on_wall += int(((cell == WALL) & ((t == amax - 2) | (t == amax - 1))
                        ).sum())
    assert bool(done.all())
    assert on_wall > 0 or not params.get('choose_goal_last')


def test_agent_on_goal_draws_uniformly_over_empty_cells():
    """A move that puts the agent on the goal places it by ``u[2]`` on an
    empty cell, uniformly (6x6, goal first: 15 empty cells)."""
    env = make_env('MultiGrid-MiniAdversarial-v0')
    n = 3000
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset(n, gen, 'cpu')
    goal_loc = torch.full((n,), 5, dtype=torch.int32)
    st, _, _ = env.step_adversary(st, goal_loc, gen)
    st, _, _ = env.step_adversary(st, goal_loc, gen)
    ax, ay = st.agent_start_pos.long().T
    rows = torch.arange(n)
    assert (st.grid[rows, ax, ay] == EMPTY).all()
    assert (st.grid[rows, st.goal_pos[:, 0].long(),
                    st.goal_pos[:, 1].long()] == GOAL).all()
    cells, counts = torch.unique(ax * 6 + ay, return_counts=True)
    assert len(cells) == int((st.grid[0] == EMPTY).sum()) == 15
    assert (abs(counts - n / 15) < 60).all(), counts


def test_noisy_goal_coin_and_cell():
    """With goal_noise 0.5 the goal move lands on a uniformly drawn empty
    cell in about half of the levels, and on its own cell otherwise."""
    env = AdversarialMultiGrid(MultiGridParams(size=6, n_clutter=7,
                                               goal_noise=0.5))
    n = 4000
    gen = torch.Generator().manual_seed(2)
    st, _ = env.reset(n, gen, 'cpu')
    u = torch.rand((n, 3), generator=gen)
    st, _, _ = env.step_adversary(st, torch.full((n,), 5, dtype=torch.int32),
                                  gen, {'u': u})
    noisy = u[:, 0] < 0.5
    assert abs(int(noisy.sum()) - n / 2) < 200
    own = torch.tensor([2, 2], dtype=torch.int32)    # loc 5 on 6x6
    assert (st.goal_pos[~noisy] == own).all()
    g = st.goal_pos[noisy].long()
    assert ((st.grid[noisy] == GOAL).flatten(1).sum(1) == 1).all()
    cells, counts = torch.unique(g[:, 0] * 6 + g[:, 1], return_counts=True)
    assert len(cells) == 16
    assert (abs(counts - int(noisy.sum()) / 16) < 45).all(), counts


# -- (c) the teacher network ----------------------------------------------

HT, BT, TT = 32, 4, 6


@pytest.fixture(scope='module')
def teachers():
    jnet, jparams, net = teacher_pair(GOAL_LAST, HT, BT)
    rng = np.random.default_rng(0)
    obs = {'image': rng.integers(0, 11, (TT, BT, 15, 15, 3)).astype(np.uint8),
           'time_step': rng.integers(0, 28, (TT, BT)).astype(np.int32),
           'random_z': rng.random((TT, BT, 50)).astype(np.float32)}
    masks = (rng.random((TT, BT)) > 0.2).astype(np.float32)
    carry = tuple(rng.normal(size=(BT, HT)).astype(np.float32)
                  for _ in range(2))
    return jnet, jparams, net, obs, masks, carry


def tt(tree):
    return jax.tree.map(torch.tensor, tree)


def test_teacher_forward_and_sequence_match(teachers):
    jnet, jparams, net, obs, masks, carry = teachers
    assert net.fused_projection
    assert net.core.w_i.weight.shape == (4 * HT, 13 * 13 * 128 + 10 + 50)
    o0 = jax.tree.map(lambda x: x[0], obs)
    outs = [(jnet.apply(jparams, o0, carry, masks[0]),
             net(tt(o0), tt(carry), torch.tensor(masks[0]))),
            (jnet.apply(jparams, obs, carry, masks, method='sequence'),
             net.sequence(tt(obs), tt(carry), torch.tensor(masks)))]
    for (jl, jv, jc), (tl, tv, tc) in outs:
        assert tl.shape[-1] == 169
        for a, b in ((jl, tl), (jv, tv), (jc[0], tc[0]), (jc[1], tc[1])):
            np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                                       atol=1e-5, rtol=0)


def test_teacher_gradients_match(teachers):
    jnet, jparams, net, obs, masks, carry = teachers
    rng = np.random.default_rng(1)
    wl = rng.normal(size=(TT, BT, 169)).astype(np.float32)
    wv = rng.normal(size=(TT, BT)).astype(np.float32)

    def jloss(p):
        logits, values, (c, h) = jnet.apply(p, obs, carry, masks,
                                            method='sequence')
        return (jnp.sum(jax.nn.log_softmax(logits) * wl)
                + jnp.sum(values * wv) + jnp.sum(h))

    jgrads = from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)))
    logits, values, (c, h) = net.sequence(tt(obs), tt(carry),
                                          torch.tensor(masks))
    loss = ((torch.log_softmax(logits, -1) * torch.tensor(wl)).sum()
            + (values * torch.tensor(wv)).sum() + h.sum())
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)


def _check_teacher_proj_backward(B):
    rng = np.random.default_rng(2)
    C, E, Nout = 64, 60, 96
    img = torch.tensor(rng.integers(0, 11, (B, 15, 15, 3)).astype(np.uint8))
    leaves = [torch.tensor(rng.normal(scale=s, size=shape).astype(np.float32),
                           requires_grad=True)
              for s, shape in ((0.2, (C, 3, 3, 3)), (0.1, (C,)), (1, (B, E)),
                               (0.01, (Nout, 13 * 13 * C + E)))]
    g_out = torch.tensor(rng.normal(size=(B, Nout)).astype(np.float32))
    out = tp.TeacherProj.apply(img, *leaves)
    got = torch.autograd.grad(out, leaves, g_out)
    want = torch.autograd.grad(tp.teacher_proj_plain(img, *leaves), leaves,
                               g_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_teacher_proj_backward_matches_autograd():
    """The autograd Function that wraps the kernels on the card, run here
    with the plain twins: its backward (teacher_proj_backward_plain) gives
    autograd's gradients of conv weight, conv bias, e and W_i."""
    _check_teacher_proj_backward(6)


def test_teacher_proj_backward_in_row_chunks(monkeypatch):
    """The same with the embed rebuilt a few rows at a time (as at the
    teacher update's full batch): 11 rows in chunks of 4, 4 and 3."""
    monkeypatch.setattr(tp, 'CHUNK_BYTES', 4 * 4 * (13 * 13 * 64 + 60))
    _check_teacher_proj_backward(11)


@pytest.mark.parametrize('n_out', [64, 1024])
def test_teacher_proj_backward_plain_at_the_teachers_widths(n_out):
    """B4's backward twin at the non-recurrent teacher's stacked trunk
    (N = 64) and the recurrent teacher's LSTM input (N = 1024), conv-128
    over 15x15 and E = 60: against autograd of ``embed_plain(...) @ W^T``
    within 1e-5 of each gradient's largest entry (sums of up to 21 692
    products in another order)."""
    rng = np.random.default_rng(n_out)
    B, C, E = 5, 128, 60
    img = torch.tensor(rng.integers(0, 11, (B, 15, 15, 3)).astype(np.uint8))
    leaves = [torch.tensor(rng.normal(scale=s, size=shape).astype(np.float32),
                           requires_grad=True)
              for s, shape in ((0.15, (C, 3, 3, 3)), (0.05, (C,)),
                               (1, (B, E)), (0.007, (n_out, 13 * 13 * C + E)))]
    g_out = torch.tensor(rng.normal(size=(B, n_out)).astype(np.float32))
    got = tp.teacher_proj_backward_plain(img, *(x.detach() for x in leaves),
                                         g_out)
    want = torch.autograd.grad(
        tp.embed_plain(img, *leaves[:3]) @ leaves[3].T, leaves, g_out)
    for name, a, b in zip(('conv_w', 'conv_b', 'e', 'w_i'), got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()),
                                   rtol=0, msg=lambda m: f'{name}: {m}')


# -- (c') the non-recurrent teacher (--recurrent_adversary_env false) ------

@pytest.fixture(scope='module')
def flat_teachers():
    """A flax teacher without a core at full width, its params and the
    port's at those params, and seeded (T, B) inputs."""
    p = JaxParams(**GOAL_LAST)
    kw = dict(num_actions=p.adversary_action_dim, conv_filters=128,
              scalar_fc=10, scalar_dim=p.adversary_max_steps + 1,
              random_z_dim=p.random_z_dim, recurrent_arch=None)
    jnet = JaxNetwork(**kw)
    rng = np.random.default_rng(3)
    obs = {'image': rng.integers(0, 11, (TT, BT, 15, 15, 3)).astype(np.uint8),
           'time_step': rng.integers(0, 28, (TT, BT)).astype(np.int32),
           'random_z': rng.random((TT, BT, 50)).astype(np.float32)}
    jparams = jnet.init(jax.random.PRNGKey(9),
                        jax.tree.map(lambda x: x[0], obs), (),
                        jnp.ones((BT,)))
    net = MultigridNetwork(view_size=p.size,
                           **{**kw, 'recurrent_arch': 'none'})
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, jparams)))
    masks = (rng.random((TT, BT)) > 0.2).astype(np.float32)
    return jnet, jparams, net, obs, masks


def test_from_flax_without_core(flat_teachers):
    _, jparams, net, _, _ = flat_teachers
    sd = from_flax(jax.tree.map(np.asarray, jparams))
    assert 'core' not in jparams['params']
    assert set(sd) == set(net.state_dict())
    assert not any(k.startswith('core.') for k in sd)
    assert sd['actor_trunk.0.weight'].shape == (32, 13 * 13 * 128 + 10 + 50)
    assert sum(v.numel() for v in sd.values()) == sum(
        x.size for x in jax.tree.leaves(jparams))


def test_flat_teacher_forward_and_sequence_match(flat_teachers):
    """One step (carry ``()``) and the (T, B) sequence within 1e-5 of JAX;
    the first trunk layers go through B4's product with the stacked
    (64, 21 692) weight."""
    jnet, jparams, net, obs, masks = flat_teachers
    assert not net.is_recurrent and net.fused_projection
    assert net.initial_carry((BT,)) == ()
    o0 = jax.tree.map(lambda x: x[0], obs)
    outs = [(jnet.apply(jparams, o0, (), masks[0]),
             net(tt(o0), (), torch.tensor(masks[0]))),
            (jnet.apply(jparams, obs, (), masks, method='sequence'),
             net.sequence(tt(obs), (), torch.tensor(masks)))]
    for (jl, jv, jc), (tl, tv, tc) in outs:
        assert jc == () and tc == () and tl.shape[-1] == 169
        for a, b in ((jl, tl), (jv, tv)):
            np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                                       atol=1e-5, rtol=0)


def test_flat_teacher_gradients_match(flat_teachers):
    """Gradients of a loss of the sequence's logits and values against
    ``jax.grad`` within 1e-4 (B4's plain backward through the stacked
    weight)."""
    jnet, jparams, net, obs, masks = flat_teachers
    rng = np.random.default_rng(4)
    wl = rng.normal(size=(TT, BT, 169)).astype(np.float32)
    wv = rng.normal(size=(TT, BT)).astype(np.float32)

    def jloss(p):
        logits, values, _ = jnet.apply(p, obs, (), masks, method='sequence')
        return jnp.sum(jax.nn.log_softmax(logits) * wl) + jnp.sum(values * wv)

    jgrads = from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)))
    logits, values, _ = net.sequence(tt(obs), (), torch.tensor(masks))
    loss = ((torch.log_softmax(logits, -1) * torch.tensor(wl)).sum()
            + (values * torch.tensor(wv)).sum())
    names = [k for k, _ in net.named_parameters()]
    for name, g in zip(names, torch.autograd.grad(loss,
                                                  list(net.parameters()))):
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)


# -- (d) the construction rollout -----------------------------------------

def test_adversary_rollout_matches_jax():
    """27 scripted moves of 8 levels, with JAX's random_z injected: obs,
    actions, masks and dones equal; values, log-probs and the bootstrap
    value within 1e-5; the built levels equal."""
    n = 8
    jnet, jparams, net = teacher_pair(SHORT_EPISODES, HT, n)
    jenv = JaxEnv(JaxParams(**SHORT_EPISODES))
    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    T = env.adversary_rollout_steps
    moves = move_script(np.random.default_rng(4), n, SHORT_EPISODES)
    k_reset, k_ro = jax.random.split(jax.random.PRNGKey(7))
    act_keys, zs = adversary_keys(k_ro, T, n)
    jst, jobs, draws = jax_reset(jenv, k_reset, n)
    jfinal, jsteps, jnext = jax_rollout.make_adversary_rollout(
        jenv, ScriptedJaxStudent(jnet, act_keys, moves), T)(
        jparams, jst, jobs, k_ro)

    st, obs = env.reset(n, None, 'cpu', draws)
    final, steps, next_value = make_adversary_rollout(
        env, net, T,
        sample_action_fn=lambda logits, t: torch.tensor(moves[t]).long(),
        draws_fn=lambda t: {'random_z': torch.tensor(zs[t])},
    )(st, obs, torch.Generator().manual_seed(0))

    eq = np.testing.assert_array_equal
    for k in ('image', 'time_step', 'random_z'):
        eq(steps.obs[k].numpy(), np.asarray(jsteps.obs[k]), k)
    for k in ('actions', 'rewards', 'masks_pre', 'dones', 'bad_masks',
              'trunc_values'):
        eq(getattr(steps, k).numpy(), np.asarray(getattr(jsteps, k)), k)
    for k in ('values', 'log_probs'):
        np.testing.assert_allclose(getattr(steps, k).numpy(),
                                   np.asarray(getattr(jsteps, k)), atol=1e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(next_value.numpy(), np.asarray(jnext),
                               atol=1e-5, rtol=0)
    assert_state_equal(final, jfinal, ADV_FIELDS)
    assert steps.dones[-1].all() and not steps.dones[:-1].any()
