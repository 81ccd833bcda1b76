"""The port's MultiGrid engine against the JAX engine and the reference
fixtures, byte for byte (CPU; the wrappers take their plain twins here).

Levels reach both engines through ``reset_to_level``, so no random stream
is shared: the JAX package draws the levels, numpy draws the actions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.envs.multigrid import (
    AdversarialMultiGrid as JaxEnv, MultiGridParams as JaxParams,
)
from dcd_isaac_tpu.envs.multigrid.core import (
    shortest_path as jax_shortest_path,
)
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import AdversarialMultiGrid
from dcd_isaac_tpu_torch.envs.multigrid.core import (
    MultiGridParams, shortest_path,
)
from dcd_isaac_tpu_torch.kernels.multigrid_adversary import (
    sample_cell_from_uniform,
)
from dcd_isaac_tpu_torch.envs.multigrid.constants import EMPTY, GOAL, WALL
from dcd_isaac_tpu_torch.envs.registry import make_env
from test_torch_algos import action_script

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'multigrid_ref_traces.npz')
DR_PARAMS = dict(size=15, n_clutter=25, choose_goal_last=True,
                 agent_view_size=5, max_steps=250)
STATE_FIELDS = ('grid', 'agent_pos', 'agent_dir', 'agent_done', 'step_count',
                'agent_start_pos', 'agent_start_dir', 'goal_pos',
                'adv_step_count', 'n_clutter_placed', 'passable',
                'shortest_path_length', 'distance_to_goal')


def jax_levels(params, n, seed):
    env = JaxEnv(JaxParams(**params))
    st, _ = jax.vmap(env.reset_random)(
        jax.random.split(jax.random.PRNGKey(seed), n))
    return np.asarray(jax.vmap(env.get_level)(st))


def assert_state_equal(port_state, jax_state, fields=STATE_FIELDS):
    for f in fields:
        np.testing.assert_array_equal(
            getattr(port_state, f).numpy(), np.asarray(getattr(jax_state, f)),
            err_msg=f)


@pytest.mark.parametrize('max_steps', [250, 9])
def test_random_action_scripts_match_jax(max_steps):
    """300 steps with same-level resets on done: state, image, reward,
    done and truncated equal to the JAX engine's (max_steps 9 makes
    time-limit truncations frequent)."""
    params = dict(DR_PARAMS, max_steps=max_steps)
    n = 8
    levels = jax_levels(params, n, seed=3)
    jenv = JaxEnv(JaxParams(**params))
    env = AdversarialMultiGrid(MultiGridParams(**params))

    jstart, jobs = jax.vmap(jenv.reset_to_level)(jnp.asarray(levels))
    start, obs = env.reset_to_level(torch.tensor(levels))
    assert_state_equal(start, jstart)
    np.testing.assert_array_equal(obs['image'].numpy(), jobs['image'])

    jstep = jax.jit(jax.vmap(jenv.step))

    @jax.jit
    def jreset(done, start, state):
        return jax.tree.map(
            lambda a, b: jnp.where(
                done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b),
            start, state)

    acts = action_script(np.random.default_rng(0), 300, n)
    jstate, state = jstart, start
    goals = dones = 0
    for t in range(300):
        state, o, r, d, info = env.step(state, torch.tensor(acts[t]))
        jstate, jo, jr, jd, jinfo = jstep(jstate, jnp.asarray(acts[t]))
        assert_state_equal(state, jstate)
        np.testing.assert_array_equal(o['image'].numpy(), jo['image'])
        np.testing.assert_array_equal(o['direction'].numpy(),
                                      jo['direction'])
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(info['truncated'].numpy(),
                                      np.asarray(jinfo['truncated']))
        goals += int((r > 0).sum())
        dones += int(d.sum())
        state = start.where(d, state)
        jstate = jreset(jd, jstart, jstate)
    assert goals > 0 and dones > goals


SCENARIOS = {
    'goal_last_25': dict(size=15, n_clutter=25, choose_goal_last=True,
                         see_through_walls=True),
    'goal_first_50': dict(size=15, n_clutter=50, choose_goal_last=False,
                          see_through_walls=True),
    'dup_cells': dict(size=15, n_clutter=25, choose_goal_last=False,
                      see_through_walls=True),
}


# ids other than the bare scenario names, which tests/conftest.py marks slow
# for the JAX engine's construction-based golden-trace tests
@pytest.mark.parametrize('name', list(SCENARIOS),
                         ids=[f'trace_{n}' for n in SCENARIOS])
def test_reference_trace_replay(name):
    """The recorded reference episodes, from their recorded grids, replay
    as the reference recorded them and as the JAX engine steps them."""
    data = np.load(FIXTURE)
    g = lambda k: data[f'{name}/{k}']
    params = dict(SCENARIOS[name], agent_view_size=5, max_steps=250)
    env = AdversarialMultiGrid(MultiGridParams(**params))
    jenv = JaxEnv(JaxParams(**params))
    state, obs = env.reset_to_level(torch.tensor(g('encoding'))[None])
    jstate, jobs = jenv.reset_to_level(jnp.asarray(g('encoding')))
    np.testing.assert_array_equal(obs['image'][0].numpy(), g('obs0_image'))
    np.testing.assert_array_equal(state.agent_start_pos[0].numpy(),
                                  g('agent_start_pos'))
    assert bool(state.passable[0]) == bool(g('passable'))
    assert int(state.shortest_path_length[0]) == int(
        g('shortest_path_length'))

    jstep = jax.jit(jenv.step)
    images, dirs, rewards, dones = [], [], [], []
    for a in g('student_actions'):
        state, obs, r, d, _ = env.step(state, torch.tensor([int(a)]))
        jstate, jobs, jr, jd, _ = jstep(jstate, jnp.int32(int(a)))
        np.testing.assert_array_equal(obs['image'][0].numpy(), jobs['image'])
        assert float(r[0]) == float(jr) and bool(d[0]) == bool(jd)
        images.append(obs['image'][0].numpy())
        dirs.append(int(obs['direction'][0]))
        rewards.append(float(r[0]))
        dones.append(bool(d[0]))
        if dones[-1]:
            break
    # The reference respawns the agent before rendering a goal step's obs
    # (see test_multigrid_golden_trace.py), so that obs is not compared.
    K = len(images) - 1 if dones[-1] and rewards[-1] > 0 else len(images)
    np.testing.assert_array_equal(np.stack(images)[:K], g('images')[:K])
    np.testing.assert_array_equal(np.asarray(dirs)[:K], g('directions')[:K])
    np.testing.assert_allclose(rewards, g('rewards'), atol=1e-6)
    np.testing.assert_array_equal(dones, g('dones'))


@pytest.mark.parametrize('env_name', [
    'MultiGrid-GoalLastOpaqueWallsAdversarial-v0',
    'MultiGrid-GoalLastFewerBlocksOpaqueWallsAdversarial-v0'])
def test_opaque_wall_envs_are_refused(env_name):
    """Opaque walls (the occlusion flood) are not ported: their registered
    envs raise at the first observation, on the CPU as on the card."""
    env = make_env(env_name)
    assert not env.params.see_through_walls
    with pytest.raises(NotImplementedError, match='opaque walls'):
        env.reset_random(2, torch.Generator().manual_seed(0), 'cpu')


def test_shortest_path_matches_jax():
    rng = np.random.default_rng(7)
    n, size = 64, 15
    p = MultiGridParams(size=size)
    grid = np.where(rng.random((n, size, size)) < 0.35, WALL, EMPTY)
    grid[:, 0, :] = grid[:, -1, :] = grid[:, :, 0] = grid[:, :, -1] = WALL
    grid = grid.astype(np.uint8)
    start = rng.integers(1, size - 1, (n, 2)).astype(np.int32)
    goal = rng.integers(1, size - 1, (n, 2)).astype(np.int32)
    start[::9] = -1                     # unplaced agent: not passable
    passable, spl = shortest_path(torch.tensor(grid), torch.tensor(start),
                                  torch.tensor(goal), p)
    jp, jspl = jax.vmap(lambda gr, s, t: jax_shortest_path(
        gr, s, t, JaxParams(size=size)))(grid, start, goal)
    np.testing.assert_array_equal(passable.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(spl.numpy(), np.asarray(jspl))
    assert 0 < int(passable.sum()) < n


@pytest.mark.parametrize('name,n_walls', [
    ('MultiGrid-GoalLastFewerBlocksAdversarial-v0', 12),
    ('MultiGrid-MiniAdversarial-v0', 3),
])
def test_reset_random_invariants(name, n_walls):
    from dcd_isaac_tpu_torch.envs.registry import make_env
    env = make_env(name)
    p = env.params
    n = 64
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset_random(n, gen, 'cpu')
    grid = state.grid.numpy()
    rows = np.arange(n)
    gx, gy = state.goal_pos.numpy().T
    ax, ay = state.agent_start_pos.numpy().T
    assert (grid[:, 1:-1, 1:-1] == WALL).sum((1, 2)).tolist() == [n_walls] * n
    assert (state.n_clutter_placed.numpy() == n_walls).all()
    assert ((grid == GOAL).sum((1, 2)) == 1).all()
    assert (grid[rows, gx, gy] == GOAL).all()
    assert (grid[rows, ax, ay] == EMPTY).all()
    assert ((gx != ax) | (gy != ay)).all()
    assert (state.adv_step_count.numpy() == p.adversary_max_steps).all()
    np.testing.assert_array_equal(state.agent_pos.numpy(),
                                  state.agent_start_pos.numpy())
    # passable / shortest_path_length equal the JAX BFS on the same levels
    jenv = JaxEnv(JaxParams(**{k: getattr(p, k) for k in (
        'size', 'n_clutter', 'max_steps', 'agent_view_size',
        'choose_goal_last')}))
    jst, jobs = jax.vmap(jenv.reset_to_level)(
        jnp.asarray(env.get_level(state).numpy()))
    np.testing.assert_array_equal(state.passable.numpy(), jst.passable)
    np.testing.assert_array_equal(state.shortest_path_length.numpy(),
                                  jst.shortest_path_length)
    np.testing.assert_array_equal(obs['image'].numpy(), jobs['image'])


def test_sample_cell_from_mask_is_uniform_over_mask():
    """The port draws a cell of a mask as the k-th True cell of a uniform
    (the draws of kernels B5 and B9 and their twins): uniform over the
    mask, cell (0, 0) for an empty mask."""
    mask = torch.zeros((1, 5, 5), dtype=torch.bool)
    cells = [(1, 1), (2, 3), (4, 0)]
    for x, y in cells:
        mask[0, x, y] = True
    mask = mask.expand(3000, 5, 5).contiguous()
    gen = torch.Generator().manual_seed(1)
    got = sample_cell_from_uniform(mask, torch.rand(3000, generator=gen))
    seen = {tuple(c) for c in got.tolist()}
    assert seen == set(cells)
    counts = np.array([(got == torch.tensor(c)).all(1).sum().item()
                       for c in cells])
    assert (abs(counts - 1000) < 150).all(), counts
    empty = sample_cell_from_uniform(torch.zeros((2, 5, 5), dtype=torch.bool),
                                     torch.rand(2, generator=gen))
    assert empty.tolist() == [[0, 0], [0, 0]]
