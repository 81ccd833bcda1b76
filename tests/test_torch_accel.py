"""The port's level edits, DR levels and PLR⊥/ACCEL cycles against the JAX
package, on the CPU.

``mutate_level`` and ``reset_random`` (kernel B9's plain twins) and the
uniform-random teacher ``_random_design`` are compared byte for byte with
JAX's on the same draws: the JAX functions draw their cells with
``sample_cell_from_mask``, which this file replaces, inside the JAX
module, by the same uniform rule the port uses (the k-th candidate cell,
k from a uniform that ``jax.random.uniform`` draws from the function's own
key), so both sides get the same uniforms.  Then a whole PLR⊥ sequence
(generate, replay) and a whole ACCEL sequence (generate, replay, edit) of
the port's runner run against a reference built from the JAX package's
public functions, with the levels, actions, coins, seeds, edits and
permutations injected into both.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcd_isaac_tpu.envs.multigrid.adversarial as jax_adversarial
from dcd_isaac_tpu.algos import ppo as jax_ppo
from dcd_isaac_tpu.algos import rollout as jax_rollout
from dcd_isaac_tpu.algos.storage import (
    batched_value_loss as jax_bvl, compute_gae as jax_compute_gae,
)
from dcd_isaac_tpu.envs.multigrid import (
    AdversarialMultiGrid as JaxEnv, MultiGridParams as JaxParams,
)
from dcd_isaac_tpu.level_replay import plr as jplr
from dcd_isaac_tpu.runner.adversarial_runner import (
    AdversarialRunner as JaxRunner,
)
from dcd_isaac_tpu_torch import train
from dcd_isaac_tpu_torch.algos.storage import batched_value_loss
from dcd_isaac_tpu_torch.arguments import parser
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.kernels import _build
from dcd_isaac_tpu_torch.kernels import multigrid_edit as me
from dcd_isaac_tpu_torch.runner.adversarial_runner import AdversarialRunner
from test_torch_algos import (
    H, N, SHORT_EPISODES, T, ScriptedJaxStudent, action_script,
    assert_params_close, near_goal_levels, rollout_keys, student_pair,
)
from test_torch_multigrid import STATE_FIELDS, assert_state_equal
from test_torch_plr import assert_buffers

S = 64
EDIT_ENVS = {
    'walls_none': dict(size=15, n_clutter=25, choose_goal_last=True,
                       editor_actions='walls_none'),
    'walls_none_goal': dict(size=15, n_clutter=0, choose_goal_last=True,
                            editor_actions='walls_none_goal'),
    'walls_none_agent_goal': dict(size=15, n_clutter=25,
                                  choose_goal_last=True,
                                  editor_actions='walls_none_agent_goal'),
}
# mg_25b_robust_plr.json and mg_60b_uni_accel_empty.json without the
# logging settings, cut to N = 8, T = 16, LSTM-32, S = 64.
ROBUST_PLR_FLAGS = [
    '--env_name', 'MultiGrid-GoalLastFewerBlocksAdversarial-v0',
    '--ued_algo', 'domain_randomization', '--num_processes', str(N),
    '--num_steps', str(T), '--ppo_epoch', '5', '--num_mini_batch', '1',
    '--handle_timelimits', 'true', '--lr', '1e-4', '--gamma', '0.995',
    '--entropy_coef', '0.01', '--recurrent_arch', 'lstm',
    '--recurrent_agent', 'true', '--recurrent_hidden_size', str(H),
    '--use_plr', 'true', '--level_replay_prob', '0.5',
    '--level_replay_rho', '0.5', '--level_replay_seed_buffer_size', str(S),
    '--level_replay_temperature', '0.1',
    '--level_replay_strategy', 'grounded_signed_value_loss',
    '--level_replay_score_transform', 'rank', '--staleness_coef', '0.3',
    '--no_exploratory_grad_updates', 'true', '--log_plr_buffer_stats', 'true',
    '--log_replay_complexity', 'true', '--reject_unsolvable_seeds', 'false',
    '--no_cuda', 'true']
ACCEL_FLAGS = [
    '--env_name', 'MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0',
    '--ued_algo', 'domain_randomization', '--num_processes', str(N),
    '--num_steps', str(T), '--ppo_epoch', '5', '--num_mini_batch', '1',
    '--handle_timelimits', 'true', '--lr', '1e-4', '--gamma', '0.995',
    '--entropy_coef', '0.0', '--adv_entropy_coef', '0.0',
    '--recurrent_arch', 'lstm', '--recurrent_agent', 'true',
    '--recurrent_adversary_env', 'false', '--recurrent_hidden_size', str(H),
    '--use_plr', 'true', '--level_replay_prob', '0.8',
    '--level_replay_rho', '0.5', '--level_replay_seed_buffer_size', str(S),
    '--level_replay_temperature', '0.3',
    '--level_replay_strategy', 'positive_value_loss',
    '--level_replay_score_transform', 'rank',
    '--no_exploratory_grad_updates', 'true', '--use_editor', 'true',
    '--level_editor_prob', '1.0', '--level_editor_method', 'random',
    '--num_edits', '5', '--base_levels', 'easy',
    '--log_plr_buffer_stats', 'true', '--log_replay_complexity', 'true',
    '--reject_unsolvable_seeds', 'false', '--no_cuda', 'true']


def uniform_sampler(rng, mask):
    """sample_cell_from_mask by the port's rule: the k-th True cell in flat
    order, k = min(trunc(u * count), count - 1), u = uniform(rng)."""
    u = jax.random.uniform(rng)
    flat = mask.ravel()
    count = flat.sum()
    k = jnp.minimum((u * count).astype(jnp.int32), jnp.maximum(count - 1, 0))
    idx = jnp.where(count > 0, jnp.argmax(jnp.cumsum(flat) > k), 0)
    return jnp.stack([idx // mask.shape[1],
                      idx % mask.shape[1]]).astype(jnp.int32)


@pytest.fixture
def uniform_cells(monkeypatch):
    monkeypatch.setattr(jax_adversarial, 'sample_cell_from_mask',
                        uniform_sampler)


def ints_as_uniforms(ints, n):
    """Uniforms that the port turns back into these ints in [0, n)."""
    return ((np.asarray(ints, np.float64) + 0.5) / n).astype(np.float32)


def mutate_draws(keys, num_edits, tiles, n_actions):
    """The port's (N, 2 E + 2) uniforms for JAX mutate_level's keys."""
    out = []
    for k in keys:
        r_loc, r_act, _, r_goal, r_agent = jax.random.split(k, 5)
        locs = jax.random.randint(r_loc, (num_edits,), 0, tiles)
        acts = jax.random.randint(r_act, (num_edits,), 0, n_actions)
        out.append(np.concatenate([
            ints_as_uniforms(locs, tiles), ints_as_uniforms(acts, n_actions),
            [float(jax.random.uniform(r_goal)),
             float(jax.random.uniform(r_agent))]]))
    return torch.tensor(np.stack(out), dtype=torch.float32)


def reset_random_draws(keys, p: JaxParams):
    """The port's (N, 4 + max_walls) uniforms for JAX reset_random's keys."""
    budget = max(p.n_clutter, 1)
    n_max = me.max_walls(p)
    out = []
    for k in keys:
        r_goal, r_agent, r_dir, r_n, r_walls = jax.random.split(k, 5)
        n_walls = (int(jax.random.randint(r_n, (), 0, budget))
                   if p.resample_n_clutter else 0)
        row = [float(jax.random.uniform(r_goal)),
               float(jax.random.uniform(r_agent)),
               ints_as_uniforms(int(jax.random.randint(r_dir, (), 0, 4)), 4),
               ints_as_uniforms(n_walls, budget)]
        for _ in range(n_max):
            r_walls, sub = jax.random.split(r_walls)
            row.append(float(jax.random.uniform(sub)))
        out.append(np.asarray(row, np.float32))
    return torch.tensor(np.stack(out))


def design_draws(rng, jenv, n):
    """The port's draws (reset, moves, step draws) for JAX
    ``_random_design``'s key."""
    rng, r0 = jax.random.split(rng)
    jst, _ = jax.vmap(jenv.reset)(jax.random.split(r0, n))
    reset = {'start_dir': torch.tensor(np.asarray(jst.agent_start_dir))}
    moves, us = [], []
    for _ in range(jenv.adversary_rollout_steps):
        rng, r1, r2 = jax.random.split(rng, 3)
        moves.append(np.asarray(jax.random.randint(
            r1, (n,), 0, jenv.adversary_num_actions)))
        keys = jax.vmap(lambda k: jax.random.split(k, 4))(
            jax.random.split(r2, n))
        us.append(np.asarray(jax.vmap(jax.vmap(jax.random.uniform))(
            keys[:, :3])))
    return dict(actions_fn=lambda t: torch.tensor(moves[t]),
                draws_fn=lambda t: {'u': torch.tensor(us[t])},
                reset_draws=reset)


# -- mutate_level, reset_random, _random_design ----------------------------

@pytest.mark.parametrize('actions', list(EDIT_ENVS))
def test_mutate_level_matches_jax(uniform_cells, actions):
    """64 levels mutated with 5 and with 40 edits (goal and agent removed
    and re-placed, cells edited twice): every state field and the
    observation equal JAX's."""
    params = EDIT_ENVS[actions]
    jenv = JaxEnv(JaxParams(**params))
    env = AdversarialMultiGrid(MultiGridParams(**params))
    n = 64
    levels = near_goal_levels(n, seed=3)
    tiles = 13 * 13
    n_actions = len(me.EDITOR_ACTION_SPACES[params['editor_actions']])
    for num_edits in (5, 40):
        keys = jax.random.split(jax.random.PRNGKey(num_edits), n)
        jst, _ = jax.vmap(jenv.reset_to_level)(jnp.asarray(levels))
        jst, jobs = jax.vmap(lambda s, r: jenv.mutate_level(
            s, r, num_edits))(jst, keys)
        st, _ = env.reset_to_level(torch.tensor(levels))
        st, obs = env.mutate_level(st, num_edits, draws=mutate_draws(
            keys, num_edits, tiles, n_actions))
        assert_state_equal(st, jst)
        np.testing.assert_array_equal(obs['image'].numpy(), jobs['image'])
        np.testing.assert_array_equal(env.get_level(st).numpy(),
                                      np.asarray(jax.vmap(jenv.get_level)(
                                          jst)))
    changed = (np.asarray(jst.grid) != levels[..., 0]).any((1, 2))
    moved = (np.asarray(jst.goal_pos) != np.argwhere(
        levels[..., 0] == 8)[:, 1:]).any(1)
    assert changed.all() and moved.any() and np.asarray(jst.passable).any()


@pytest.mark.parametrize('params', [
    dict(size=15, n_clutter=25, choose_goal_last=True),
    dict(size=15, n_clutter=60, choose_goal_last=True,
         resample_n_clutter=True),
    dict(size=15, n_clutter=0, choose_goal_last=True),
    dict(size=6, n_clutter=7)], ids=['25_blocks', 'variable_60', 'empty',
                                     'mini'])
def test_reset_random_matches_jax(uniform_cells, params):
    jp = JaxParams(**params)
    jenv = JaxEnv(jp)
    env = AdversarialMultiGrid(MultiGridParams(**params))
    n = 64
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    jst, jobs = jax.vmap(jenv.reset_random)(keys)
    st, obs = env.reset_random(n, draws=reset_random_draws(keys, jp))
    assert_state_equal(st, jst)
    np.testing.assert_array_equal(obs['image'].numpy(), jobs['image'])


@pytest.mark.parametrize('env_name', [
    'MultiGrid-GoalLastFewerBlocksAdversarial-v0',
    'MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0'])
def test_random_design_matches_jax(uniform_cells, env_name):
    """DR with PLR builds its levels with a uniform-random teacher: 27
    moves of 25 blocks, or 2 moves (goal, agent) of the ACCEL env."""
    argv = (ROBUST_PLR_FLAGS if 'Fewer' in env_name else ACCEL_FLAGS)
    args = parser.parse_args(argv)
    runner = AdversarialRunner(args, train.make_env(env_name), {
        'agent': student_pair(H)[2]}, 'cpu')
    jenv = JaxEnv(JaxParams(**{
        k: getattr(runner.env.params, k) for k in (
            'size', 'n_clutter', 'choose_goal_last', 'max_steps',
            'editor_actions')}))
    key = jax.random.PRNGKey(2)
    jst = JaxRunner._random_design(
        SimpleNamespace(env=jenv, args=SimpleNamespace(num_processes=N)), key)
    st = runner._random_design(**design_draws(key, jenv, N))
    assert_state_equal(st, jst, STATE_FIELDS + ('adv_max_steps',))
    assert bool(st.passable.any())


# -- whole PLR⊥ and ACCEL sequences ---------------------------------------

def plr_config(args):
    """The JAX PLRConfig the JAX runner builds from these args (:121-139)."""
    return jplr.PLRConfig(
        capacity=args.level_replay_seed_buffer_size, num_actors=N,
        strategy=args.level_replay_strategy,
        score_transform=args.level_replay_score_transform,
        temperature=args.level_replay_temperature, rho=args.level_replay_rho,
        replay_prob=args.level_replay_prob, alpha=args.level_replay_alpha,
        staleness_coef=args.staleness_coef, gamma=args.gamma,
        reject_unsolvable=args.reject_unsolvable_seeds)


def scripted_replay_reset(jenv, reset_keys, seeds, levels):
    """JAX replay reset_fn giving slot i at step t the level of the buffer
    slot ``seeds[t, i]``."""
    flat = jnp.asarray(seeds.reshape(-1), jnp.int32)

    def reset_fn(rng, state, seed):
        s = flat[jnp.argmax(jnp.all(reset_keys == rng[None], axis=-1))]
        state, obs = jenv.reset_to_level(levels[s])
        return state, obs, s
    return reset_fn


class JaxSequence:
    """The runner's cycles rebuilt from the JAX package's public functions:
    a student (params and Adam state) and a PLR buffer carried across
    cycles."""

    def __init__(self, args, jenv, jnet, params):
        self.args, self.jenv, self.jnet = args, jenv, jnet
        self.cfg = jax_ppo.PPOConfig(
            clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
            num_mini_batch=args.num_mini_batch,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
            max_grad_norm=args.max_grad_norm,
            clip_value_loss=args.clip_value_loss)
        self.state = jax_ppo.AgentTrainState(
            params=params,
            opt_state=jax_ppo.make_optimizer(self.cfg).init(params))
        self.plr_cfg = plr_config(args)
        self.buf = jplr.init_plr(self.plr_cfg, (15, 15, 3))

    def phase(self, env_states, seeds, actions, key, discard,
              reset_seeds=None):
        """Rollout, GAE, PLR fold, PPO update → (staged scores, counts,
        easy metric, the update's permutations)."""
        args, jenv = self.args, self.jenv
        r_ro, r_upd = jax.random.split(key)
        act_keys, reset_keys = rollout_keys(r_ro, T, N)
        reset_fn = None
        if reset_seeds is not None:
            reset_fn = scripted_replay_reset(jenv, reset_keys, reset_seeds,
                                             self.buf.levels)
        st, obs = jax.vmap(jenv.reset_agent)(env_states)
        carry = jax_rollout.initial_step_carry(jenv, self.jnet, st, obs,
                                               r_ro, level_seeds=seeds)
        _, steps, next_value, ro = jax_rollout.make_student_rollout(
            jenv, ScriptedJaxStudent(self.jnet, act_keys, actions),
            jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True),
            reset_fn=reset_fn)(self.state.params, carry)
        returns = jax_compute_gae(steps, next_value, args.gamma,
                                  args.gae_lambda,
                                  use_proper_time_limits=True)
        self.buf, st_s, st_c = jplr.update_with_rollout(
            self.buf, self.plr_cfg, steps, returns, steps.values)
        easy = ro['mean_return'] - jax_bvl(returns, steps.values)
        self.state, _ = jax_ppo.make_ppo_update(self.jnet, self.cfg, N)(
            self.state, steps, returns, self.jnet.initial_carry((N,)), r_upd,
            discard)
        perms = jax.vmap(lambda r: jax.random.permutation(r, N))(
            jax.random.split(r_upd, self.cfg.ppo_epoch))
        return st_s, st_c, easy, torch.tensor(np.asarray(perms))

    def promote(self, env_states, st_s, st_c, num_edits=None):
        self.buf = jplr.promote_staged(
            self.buf, self.plr_cfg, jax.vmap(self.jenv.get_level)(env_states),
            st_s, st_c, staged_solvable=env_states.passable,
            staged_num_edits=num_edits)


def script(actions):
    return lambda logits, t: torch.tensor(actions[t]).long()


@pytest.mark.parametrize('method', ['robust_plr', 'accel'])
def test_plr_sequence_matches_jax_reference(uniform_cells, method):
    """PLR⊥: a generate cycle (gradients discarded, levels staged and
    promoted) then a replay cycle (levels drawn from the buffer, mid-rollout
    replay resets, scores folded, a gradient step).  ACCEL adds an edit
    cycle: the 4 'easy' replayed levels mutated, evaluated without a
    gradient step and promoted with one edit more.  The buffer within 1e-5
    with byte-exact levels, the params within 1e-4."""
    flags = ROBUST_PLR_FLAGS if method == 'robust_plr' else ACCEL_FLAGS
    args = parser.parse_args(flags)
    params = dict(SHORT_EPISODES, n_clutter=(25 if method == 'robust_plr'
                                             else 0),
                  editor_actions='walls_none_goal')
    jenv = JaxEnv(JaxParams(**params))
    env = AdversarialMultiGrid(MultiGridParams(**params))
    jnet, jparams, net = student_pair(H, seed=4)
    ref = JaxSequence(args, jenv, jnet, jparams)
    rng = np.random.default_rng(30)
    acts = [action_script(rng, T, N) for _ in range(3)]
    k_gen, k_rep, k_draw, k_mut, k_edit = jax.random.split(
        jax.random.PRNGKey(1), 5)

    # generate: injected levels, staged as seeds S..S+N-1
    levels0 = near_goal_levels(N, seed=31)
    gen_states, _ = jax.vmap(jenv.reset_to_level)(jnp.asarray(levels0))
    st_s, st_c, _, perms_gen = ref.phase(
        gen_states, jnp.arange(N, dtype=jnp.int32) + S, acts[0], k_gen,
        discard=True)
    ref.promote(gen_states, st_s, st_c)
    assert int(np.asarray(ref.buf.filled).sum()) == N

    # replay: JAX's draws of the levels; scripted mid-rollout resets
    seeds, rep_levels, ref.buf = jplr.sample_replay_levels(
        ref.buf, ref.plr_cfg, k_draw, N)
    filled = np.flatnonzero(np.asarray(ref.buf.filled))
    reset_seeds = rng.choice(filled, (T, N)).astype(np.int32)
    rep_states, _ = jax.vmap(jenv.reset_to_level)(rep_levels)
    _, _, easy, perms_rep = ref.phase(rep_states, seeds, acts[1], k_rep,
                                      discard=False, reset_seeds=reset_seeds)

    inject = dict(sample_action_fn=script(acts[1]), replay=True,
                  replay_seeds=torch.tensor(np.asarray(seeds)),
                  replay_reset_seeds=lambda t: torch.tensor(reset_seeds[t]),
                  perms={'agent': perms_rep})
    if method == 'accel':
        parents = np.tile(np.asarray(seeds)[np.argsort(np.asarray(easy))[:4]],
                          N // 4)
        par_states, _ = jax.vmap(jenv.reset_to_level)(
            ref.buf.levels[parents])
        keys = jax.random.split(k_mut, N)
        par_states, _ = jax.vmap(lambda s, r: jenv.mutate_level(
            s, r, args.num_edits))(par_states, keys)
        st_s, st_c, _, perms_edit = ref.phase(
            par_states, jnp.arange(N, dtype=jnp.int32) + S, acts[2], k_edit,
            discard=True)
        ref.promote(par_states, st_s, st_c,
                    ref.buf.num_edits[parents] + 1)
        inject.update(edit_coin=0.5, edit_sample_fn=script(acts[2]),
                      mutation_draws=mutate_draws(keys, args.num_edits,
                                                  13 * 13, 3))
        inject['perms']['agent_edit'] = perms_edit

    runner = AdversarialRunner(args, env, {'agent': net}, 'cpu')
    before = {k: v.clone() for k, v in net.state_dict().items()}
    s_gen = runner.run(levels=torch.tensor(levels0), replay=False,
                       sample_action_fn=script(acts[0]),
                       perms={'agent': perms_gen})
    assert all(torch.equal(v, before[k]) for k, v in
               net.state_dict().items())      # PLR⊥ discards this step
    s_rep = runner.run(**inject)

    assert_buffers(runner.plr_buffer, ref.buf, atol=1e-5)
    assert_params_close(ref.state.params, net, atol=1e-4)
    assert max(float((v - before[k]).abs().max())
               for k, v in net.state_dict().items()) > 1e-4
    assert (s_gen['level_replay'], s_rep['level_replay']) == (0, 1)
    assert s_gen['total_student_grad_updates'] == 0
    assert s_rep['total_student_grad_updates'] == 1
    edits = 1 if method == 'accel' else 0
    assert s_rep['total_num_edits'] == edits
    assert s_rep['steps'] == (2 + edits) * N * T
    assert s_rep['total_seeds'] == N
    want = jplr.plr_stats(ref.buf, ref.plr_cfg)
    if method == 'robust_plr':      # the replay cycle's stats come last
        for k in want:
            np.testing.assert_allclose(s_rep[k], float(want[k]), atol=1e-5,
                                       err_msg=k)
    # fresh env stats: plain on the generate cycle, 'plr_' on the replay
    assert 'passable_ratio' in s_gen and 'plr_passable_ratio' in s_rep
    assert 'passable_ratio' not in s_rep
    if method == 'accel':
        assert int(np.asarray(ref.buf.num_edits).max()) >= 1
        assert int(np.asarray(ref.buf.filled).sum()) > N


def test_batched_value_loss_matches_jax():
    rng = np.random.default_rng(0)
    r, v = (rng.normal(size=(T, N)).astype(np.float32) * 2 for _ in range(2))
    for kw in (dict(), dict(signed=True), dict(positive_only=True),
               dict(power=2), dict(clipped=False)):
        np.testing.assert_allclose(
            batched_value_loss(torch.tensor(r), torch.tensor(v), **kw).numpy(),
            np.asarray(jax_bvl(jnp.asarray(r), jnp.asarray(v), **kw)),
            atol=1e-6, err_msg=str(kw))


# -- the kernel wrappers: twins on the CPU, no fallback off it ------------

def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError('kernel build requested')
    monkeypatch.setattr(_build, 'build', refuse)
    monkeypatch.setattr(_build, 'library', refuse)


def test_edit_wrappers_take_plain_twins_on_cpu(monkeypatch):
    _no_build(monkeypatch)
    env = AdversarialMultiGrid(MultiGridParams(**EDIT_ENVS['walls_none']))
    counts = (me.mutate.launches, me.reset_random.launches)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((6, me.reset_random_draws(env.params)), generator=gen)
    assert all(torch.equal(a, b) for a, b in zip(
        me.reset_random(u, env.params), me.reset_random_plain(u, env.params)))
    st, _ = env.reset_random(6, gen)
    u = torch.rand((6, me.mutate_draws(5)), generator=gen)
    args = (st.grid, st.goal_pos, st.agent_start_pos, u, 5, 'walls_none')
    assert all(torch.equal(a, b) for a, b in zip(me.mutate(*args),
                                                 me.mutate_plain(*args)))
    assert counts == (me.mutate.launches, me.reset_random.launches)


def test_edit_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    _no_build(monkeypatch)
    p = MultiGridParams(**EDIT_ENVS['walls_none_goal'])
    u = torch.zeros((4, me.reset_random_draws(p)), device='meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        me.reset_random(u, p)
    grid = torch.zeros((4, 15, 15), dtype=torch.uint8, device='meta')
    pos = torch.zeros((4, 2), dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError, match='kernel build requested'):
        me.mutate(grid, pos, pos, torch.zeros((4, 12), device='meta'), 5,
                  'walls_none_goal')
    with pytest.raises(ValueError, match='more than 256 cells'):
        me.reset_random(torch.zeros((4, 4 + 50), device='meta'),
                        MultiGridParams(size=17, n_clutter=100))


def test_plr_flags_are_let_through_and_teachers_with_plr_refused():
    args = parser.parse_args(ACCEL_FLAGS)
    assert train.check_args(args) is args
    # REPAIRED (PAIRED with PLR⊥) is built, with the antagonist's buffer
    repaired = train.setup(train.check_args(parser.parse_args(
        ROBUST_PLR_FLAGS + ['--ued_algo', 'paired',
                            '--recurrent_adversary_env', 'true'])))
    assert repaired.is_paired and repaired.plr_antagonist is not None
    with pytest.raises(NotImplementedError, match='fixed PLR seed set'):
        train.main(ROBUST_PLR_FLAGS + ['--train_full_distribution', 'false'])
