"""GAE, PPO and the student rollout of the port against the JAX package.

Randomness is injected, never shared: numpy draws the data and the action
scripts, the JAX package draws the levels and the PPO permutations, and
both sides get the same ones.  The JAX rollout takes its scripted actions
and reset levels by recognising the per-step keys its scan splits off
(see ``rollout_keys``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.algos import ppo as jax_ppo
from dcd_isaac_tpu.algos import rollout as jax_rollout
from dcd_isaac_tpu.algos.storage import Rollout as JaxRollout
from dcd_isaac_tpu.algos.storage import compute_gae as jax_compute_gae
from dcd_isaac_tpu.envs.multigrid import (
    AdversarialMultiGrid as JaxEnv, MultiGridParams as JaxParams,
)
from dcd_isaac_tpu.models.distributions import categorical_log_prob
from dcd_isaac_tpu.models.multigrid_models import (
    MultigridNetwork as JaxNetwork,
)
from dcd_isaac_tpu_torch.algos.ppo import (
    PPOConfig, init_agent_state, make_ppo_update,
)
from dcd_isaac_tpu_torch.algos.rollout import (
    RolloutConfig, initial_step_carry, make_student_rollout,
)
from dcd_isaac_tpu_torch.algos.storage import Rollout, compute_gae
from dcd_isaac_tpu_torch.convert import from_flax
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.constants import (
    AGENT, EMPTY, GOAL, TYPE_COLOR, WALL,
)
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.models.multigrid_models import MultigridNetwork

T, N, H = 16, 8, 32
# 15x15, 25 blocks, goal last; max_steps 6 makes time-limit truncations
# (and their bootstrap values) happen inside a 16-step rollout.
SHORT_EPISODES = dict(size=15, n_clutter=25, choose_goal_last=True,
                      agent_view_size=5, max_steps=6)


# -- injection helpers (also used by test_torch_cycle.py) -------------------

def rollout_keys(rng, steps, n):
    """The keys JAX make_student_rollout splits off at each step: the
    action key of step t, and the (t, slot) keys of its reset draws."""
    act, reset = [], []
    for _ in range(steps):
        rng, r_act, _, r_reset = jax.random.split(rng, 4)
        act.append(r_act)
        reset.append(jax.random.split(r_reset, n))
    return jnp.stack(act), jnp.concatenate(reset)


class ScriptedJaxStudent:
    """The flax student whose action draw returns ``actions[t]``, t found
    from the step's action key."""
    dist_type = 'categorical'
    is_recurrent = True

    def __init__(self, net, act_keys, actions):
        self.net, self.keys = net, act_keys
        self.actions = jnp.asarray(actions, jnp.int32)

    def apply(self, *args, **kw):
        return self.net.apply(*args, **kw)

    def initial_carry(self, batch_dims):
        return self.net.initial_carry(batch_dims)

    def log_prob_entropy(self, logits, actions):
        return self.net.log_prob_entropy(logits, actions)

    def sample_action(self, rng, logits):
        t = jnp.argmax(jnp.all(self.keys == rng[None], axis=-1))
        a = self.actions[t]
        return a, categorical_log_prob(logits, a)


def scripted_jax_reset(env, reset_keys, levels):
    """JAX reset_fn giving slot i at step t the level ``levels[t, i]``."""
    flat = jnp.asarray(levels.reshape(-1, *levels.shape[2:]))

    def reset_fn(rng, state, seed):
        i = jnp.argmax(jnp.all(reset_keys == rng[None], axis=-1))
        state, obs = env.reset_to_level(flat[i])
        return state, obs, seed
    return reset_fn


def scripted_port(env, actions, levels):
    """The port's sample_action_fn and reset_fn for the same scripts."""
    def sample(logits, t):
        return torch.tensor(actions[t], dtype=torch.int64)

    def reset(t, state, seeds):
        state, obs = env.reset_to_level(torch.tensor(levels[t]))
        return state, obs, seeds
    return sample, reset


def near_goal_levels(n, seed, size=15, n_walls=12):
    """n level encodings (numpy) whose goal is one or two cells from the
    agent, so scripted episodes reach it: border walls, ``n_walls``
    random interior walls, agent with a random direction."""
    rng = np.random.default_rng(seed)
    levels = np.zeros((n, size, size, 3), np.uint8)
    for k in range(n):
        grid = np.full((size, size), EMPTY, np.uint8)
        grid[[0, -1], :] = grid[:, [0, -1]] = WALL
        ax, ay = rng.integers(2, size - 2, 2)
        dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1), (2, 0), (1, 1)][
            rng.integers(6)]
        grid[ax + dx, ay + dy] = GOAL
        free = np.argwhere(grid == EMPTY)
        free = free[(free[:, 0] != ax) | (free[:, 1] != ay)]
        for x, y in free[rng.choice(len(free), n_walls, replace=False)]:
            grid[x, y] = WALL
        levels[k, ..., 0] = grid
        levels[k, ..., 1] = TYPE_COLOR[grid]
        levels[k, ax, ay] = (AGENT, 0, rng.integers(4))
    return levels


def action_script(rng, steps, n):
    """Actions 0..6 with FORWARD (2) four times in ten."""
    a = rng.integers(0, 10, (steps, n))
    return np.where(a >= 7, 2, a).astype(np.int32)


def student_pair(hidden, seed=0):
    """A flax student, its params, and the port's student at those params."""
    jnet = JaxNetwork(num_actions=7, recurrent_hidden_size=hidden)
    obs = {'image': jnp.zeros((N, 5, 5, 3), jnp.uint8),
           'direction': jnp.zeros((N,), jnp.int32)}
    params = jnet.init(jax.random.PRNGKey(seed), obs,
                       jnet.initial_carry((N,)), jnp.ones((N,)))
    net = MultigridNetwork(7, recurrent_hidden_size=hidden)
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    return jnet, params, net


def assert_params_close(jax_params, net, atol):
    want = from_flax(jax.tree.map(np.asarray, jax_params))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def to_jax_rollout(r: Rollout) -> JaxRollout:
    """The JAX Rollout of the port's; its PLR-only fields are zeros."""
    j = lambda x: jnp.asarray(x.numpy())
    shape = tuple(r.values.shape)
    return JaxRollout(
        obs={k: j(v) for k, v in r.obs.items()}, actions=j(r.actions.int()),
        log_probs=j(r.log_probs), log_dists=jnp.zeros(shape + (7,)),
        values=j(r.values), rewards=j(r.rewards), masks_pre=j(r.masks_pre),
        dones=j(r.dones), bad_masks=j(r.bad_masks),
        cliffhangers=jnp.zeros(shape, bool), trunc_values=j(r.trunc_values),
        level_seeds=jnp.zeros(shape, jnp.int32))


# -- GAE ------------------------------------------------------------------

@pytest.mark.parametrize('proper', [True, False])
def test_gae_matches_jax(proper):
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    dones[-1] = True
    r = Rollout(
        obs={}, actions=torch.zeros((T, N), dtype=torch.int64),
        log_probs=torch.tensor(f(T, N)), values=torch.tensor(f(T, N)),
        rewards=torch.tensor(f(T, N) * (rng.random((T, N)) < 0.3)),
        masks_pre=torch.ones((T, N)), dones=torch.tensor(dones),
        bad_masks=torch.tensor(
            (rng.random((T, N)) < 0.5).astype(np.float32)),
        trunc_values=torch.tensor(f(T, N)))
    next_value = torch.tensor(f(N))
    got = compute_gae(r, next_value, 0.995, 0.95, proper)
    want = jax_compute_gae(to_jax_rollout(r), jnp.asarray(next_value.numpy()),
                           0.995, 0.95, use_proper_time_limits=proper)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# -- PPO ------------------------------------------------------------------

@pytest.mark.parametrize('clip_value_loss', [True, False])
def test_ppo_update_matches_jax(clip_value_loss):
    """One update (5 epochs x 2 minibatches) from the same params with the
    JAX update's own permutations injected into the port's."""
    jnet, params, net = student_pair(H)
    rng = np.random.default_rng(1)
    obs = {'image': rng.integers(0, 11, (T, N, 5, 5, 3)).astype(np.uint8),
           'direction': rng.integers(0, 4, (T, N)).astype(np.int32)}
    dones = rng.random((T, N)) < 0.15
    masks_pre = np.concatenate([np.zeros((1, N)), 1.0 - dones[:-1]]
                               ).astype(np.float32)
    actions = rng.integers(0, 7, (T, N)).astype(np.int32)
    carry0 = jnet.initial_carry((N,))
    logits, values, _ = jnet.apply(params, obs, carry0, masks_pre,
                                   method='sequence')
    log_probs = categorical_log_prob(logits, actions)
    # perturbed old log-probs make the ratios leave the clip range
    old_lp = np.asarray(log_probs) + rng.normal(
        scale=0.3, size=(T, N)).astype(np.float32)
    returns = (np.asarray(values) + rng.normal(size=(T, N))
               ).astype(np.float32)

    cfg_kw = dict(ppo_epoch=5, num_mini_batch=2, entropy_coef=0.01,
                  lr=1e-4, clip_value_loss=clip_value_loss)
    jcfg = jax_ppo.PPOConfig(**cfg_kw)
    tx = jax_ppo.make_optimizer(jcfg)
    jstate = jax_ppo.AgentTrainState(params=params, opt_state=tx.init(params))
    zeros = lambda *s: np.zeros(s, np.float32)
    jro = JaxRollout(
        obs=jax.tree.map(jnp.asarray, obs), actions=jnp.asarray(actions),
        log_probs=jnp.asarray(old_lp),
        log_dists=zeros(T, N, 7), values=values, rewards=zeros(T, N),
        masks_pre=jnp.asarray(masks_pre), dones=jnp.asarray(dones),
        bad_masks=zeros(T, N) + 1, cliffhangers=jnp.zeros((T, N), bool),
        trunc_values=zeros(T, N), level_seeds=jnp.zeros((T, N), jnp.int32))
    key = jax.random.PRNGKey(5)
    jnew, jstats = jax_ppo.make_ppo_update(jnet, jcfg, N)(
        jstate, jro, jnp.asarray(returns), carry0, key, False)
    perms = jax.vmap(lambda r: jax.random.permutation(r, N))(
        jax.random.split(key, jcfg.ppo_epoch))

    t = lambda x: torch.tensor(np.asarray(x))
    ro = Rollout(
        obs={k: t(v) for k, v in obs.items()}, actions=t(actions).long(),
        log_probs=t(old_lp), values=t(values), rewards=t(zeros(T, N)),
        masks_pre=t(masks_pre), dones=t(dones), bad_masks=t(zeros(T, N) + 1),
        trunc_values=t(zeros(T, N)))
    cfg = PPOConfig(**cfg_kw)
    state = init_agent_state(net, cfg)
    stats = make_ppo_update(net, cfg, N)(
        state, ro, t(returns), net.initial_carry((N,)), None, False,
        perms=t(perms))
    assert_params_close(jnew.params, net, atol=1e-5)
    for k in ('value_loss', 'action_loss', 'dist_entropy', 'grad_norm'):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert float(jstats['grad_norm']) > 0


def test_ppo_discard_grad_keeps_params():
    _, _, net = student_pair(H)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(2)
    t = torch.tensor
    ro = Rollout(
        obs={'image': t(rng.integers(0, 11, (T, N, 5, 5, 3)).astype(np.uint8)),
             'direction': t(rng.integers(0, 4, (T, N)))},
        actions=t(rng.integers(0, 7, (T, N))),
        log_probs=torch.full((T, N), -1.9), values=torch.zeros((T, N)),
        rewards=torch.zeros((T, N)), masks_pre=torch.ones((T, N)),
        dones=torch.zeros((T, N), dtype=torch.bool),
        bad_masks=torch.ones((T, N)), trunc_values=torch.zeros((T, N)))
    cfg = PPOConfig(ppo_epoch=2)
    state = init_agent_state(net, cfg)
    stats = make_ppo_update(net, cfg, N)(
        state, ro, torch.ones((T, N)), net.initial_carry((N,)),
        torch.Generator().manual_seed(0), True)
    assert float(stats['grad_norm']) > 0
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert state.opt.count == 0


# -- rollout --------------------------------------------------------------

@pytest.mark.parametrize('reset_mode', ['scripted', 'same_level'])
def test_student_rollout_matches_jax(reset_mode):
    """handle_timelimits on; resets either injected (the DR path's
    stochastic reset) or the default same-level replay: env fields equal,
    values / log-probs / truncation values within 1e-5."""
    scripted = reset_mode == 'scripted'
    jnet, params, net = student_pair(H)
    levels0 = near_goal_levels(N, seed=11)
    reset_levels = near_goal_levels(T * N, seed=12).reshape(
        T, N, 15, 15, 3)
    actions = action_script(np.random.default_rng(3), T, N)

    jenv = JaxEnv(JaxParams(**SHORT_EPISODES))
    key = jax.random.PRNGKey(9)
    act_keys, reset_keys = rollout_keys(key, T, N)
    jst, _ = jax.vmap(jenv.reset_to_level)(jnp.asarray(levels0))
    jst, jobs = jax.vmap(jenv.reset_agent)(jst)
    jcarry = jax_rollout.initial_step_carry(jenv, jnet, jst, jobs, key)
    jfinal, jsteps, jnext, jstats = jax_rollout.make_student_rollout(
        jenv, ScriptedJaxStudent(jnet, act_keys, actions),
        jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True),
        reset_fn=(scripted_jax_reset(jenv, reset_keys, reset_levels)
                  if scripted else None),
    )(params, jcarry)

    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    sample, reset = scripted_port(env, actions, reset_levels)
    st, _ = env.reset_to_level(torch.tensor(levels0))
    st, obs = env.reset_agent(st)
    final, steps, next_value, stats = make_student_rollout(
        env, net, RolloutConfig(num_steps=T, handle_timelimits=True),
        reset_fn=reset if scripted else None, sample_action_fn=sample,
    )(initial_step_carry(net, st, obs))

    eq = np.testing.assert_array_equal
    for k in ('image', 'direction'):
        eq(steps.obs[k].numpy(), jsteps.obs[k])
    for k in ('actions', 'rewards', 'masks_pre', 'dones', 'bad_masks'):
        eq(getattr(steps, k).numpy(), np.asarray(getattr(jsteps, k)), k)
    for k in ('values', 'log_probs', 'trunc_values'):
        np.testing.assert_allclose(
            getattr(steps, k).numpy(), getattr(jsteps, k), atol=1e-5,
            rtol=0, err_msg=k)
    np.testing.assert_allclose(next_value.numpy(), jnext, atol=1e-5, rtol=0)
    for k in ('grid', 'agent_pos', 'agent_dir', 'step_count', 'agent_done',
              'agent_start_pos', 'goal_pos', 'passable',
              'shortest_path_length'):
        eq(getattr(final.env_state, k).numpy(),
           np.asarray(getattr(jfinal.env_state, k)), k)
    eq(stats['episode_count'].numpy(), jstats['episode_count'])
    np.testing.assert_allclose(stats['mean_return'].numpy(),
                               jstats['mean_return'], atol=1e-6)
    np.testing.assert_allclose(stats['max_return'].numpy(),
                               jstats['max_return'], atol=1e-6)
    # the scripts exercised what the test is about
    assert int(stats['episode_count'].sum()) > N
    assert (steps.bad_masks.numpy() == 0).any()
    assert (steps.rewards.numpy() > 0).any()
