"""REPAIRED and minimax on MultiGrid: the port's runner against reference
cycles built from the JAX package's public functions, on the CPU.

REPAIRED (``mg_25b_repaired.json``: PAIRED with PLR⊥ on both students and
a teacher without a core) runs a generate, a replay and a generate cycle:
the teacher's construction, both students' rollouts scored into their
buffers (the antagonist's own, or with ``--antagonist_plr true`` the
protagonist's), PLR⊥'s discarded student gradients on generate cycles,
replays drawn from each student's buffer, and the teacher updated on the
last generate cycle's rollout with the regret of the cycle.  Minimax
(``mg_25b_minimax.json``) runs one cycle with the teacher without a core.
As in test_torch_paired.py every draw is injected into both sides: numpy
draws the moves, actions and replay resets, the JAX package the start
directions, ``random_z``, the replay draws and the PPO permutations.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.algos import ppo as jax_ppo
from dcd_isaac_tpu.algos import rollout as jax_rollout
from dcd_isaac_tpu.algos.storage import compute_gae as jax_compute_gae
from dcd_isaac_tpu.envs.multigrid import (
    AdversarialMultiGrid as JaxEnv, MultiGridParams as JaxParams,
)
from dcd_isaac_tpu.level_replay import plr as jplr
from dcd_isaac_tpu.models.multigrid_models import (
    MultigridNetwork as JaxNetwork,
)
from dcd_isaac_tpu.runner.adversarial_runner import (
    AdversarialRunner as JaxRunner,
)
from dcd_isaac_tpu_torch import train
from dcd_isaac_tpu_torch.arguments import parser
from dcd_isaac_tpu_torch.convert import from_flax
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.models.multigrid_models import MultigridNetwork
from dcd_isaac_tpu_torch.runner.adversarial_runner import AdversarialRunner
from test_torch_accel import plr_config, scripted_replay_reset
from test_torch_algos import (
    H, N, SHORT_EPISODES, T, ScriptedJaxStudent, action_script,
    assert_params_close, rollout_keys, student_pair,
)
from test_torch_paired import near_goal_moves
from test_torch_plr import assert_buffers
from test_torch_teacher import adversary_keys, jax_reset

S = 64
# Weights after each cycle, against the reference (Adam's steps of 1e-4).
PARAM_TOL = 1e-5
# mg_25b_repaired.json and mg_25b_minimax.json without
# --log_action_complexity, --checkpoint and --archive_interval, cut to
# N = 8, T = 16, LSTM-32 students, S = 64.
COMMON = [
    '--env_name', 'MultiGrid-GoalLastFewerBlocksAdversarial-v0',
    '--num_processes', str(N), '--num_steps', str(T), '--ppo_epoch', '5',
    '--num_mini_batch', '1', '--handle_timelimits', 'true', '--lr', '1e-4',
    '--gamma', '0.995', '--adv_entropy_coef', '0.0', '--recurrent_arch',
    'lstm', '--recurrent_agent', 'true', '--recurrent_adversary_env',
    'false', '--recurrent_hidden_size', str(H), '--no_cuda', 'true']
REPAIRED_FLAGS = COMMON + [
    '--ued_algo', 'paired', '--entropy_coef', '0.0', '--use_plr', 'true',
    '--level_replay_prob', '0.95', '--level_replay_rho', '0.5',
    '--level_replay_seed_buffer_size', str(S),
    '--level_replay_temperature', '0.1',
    '--level_replay_strategy', 'grounded_signed_value_loss',
    '--level_replay_score_transform', 'rank', '--staleness_coef', '0.3',
    '--no_exploratory_grad_updates', 'true', '--log_plr_buffer_stats', 'true',
    '--log_replay_complexity', 'true', '--reject_unsolvable_seeds', 'false']
MINIMAX_FLAGS = COMMON + [
    '--ued_algo', 'minimax', '--entropy_coef', '0.01',
    '--log_plr_buffer_stats', 'true', '--log_replay_complexity', 'true',
    '--reject_unsolvable_seeds', 'false']


def flat_teacher_pair(params: dict, seed):
    """A flax teacher without a core at full width (conv-128, scalar embed
    10, random_z 50, 32-32 trunks), its params, and the port's."""
    p = JaxParams(**params)
    kw = dict(num_actions=p.adversary_action_dim, conv_filters=128,
              scalar_fc=10, scalar_dim=p.adversary_max_steps + 1,
              random_z_dim=p.random_z_dim)
    jnet = JaxNetwork(recurrent_arch=None, **kw)
    obs = {'image': jnp.zeros((N, p.size, p.size, 3), jnp.uint8),
           'time_step': jnp.zeros((N,), jnp.int32),
           'random_z': jnp.zeros((N, p.random_z_dim))}
    jparams = jnet.init(jax.random.PRNGKey(seed), obs, (), jnp.ones((N,)))
    net = MultigridNetwork(view_size=p.size, recurrent_arch='none', **kw)
    net.load_state_dict(from_flax(jax.tree.map(np.asarray, jparams)))
    return jnet, jparams, net


def jax_cfg(args, teacher=False):
    kw = dict(clip_param=args.clip_param,
              value_loss_coef=args.value_loss_coef, lr=args.lr, eps=args.eps,
              clip_value_loss=args.clip_value_loss)
    if teacher:
        return jax_ppo.PPOConfig(
            ppo_epoch=args.adv_ppo_epoch,
            num_mini_batch=args.adv_num_mini_batch,
            entropy_coef=args.adv_entropy_coef,
            max_grad_norm=args.adv_max_grad_norm, **kw)
    return jax_ppo.PPOConfig(
        ppo_epoch=args.ppo_epoch, num_mini_batch=args.num_mini_batch,
        entropy_coef=args.entropy_coef, max_grad_norm=args.max_grad_norm,
        **kw)


class Learner:
    """A JAX model with its params and Adam state, carried across cycles."""

    def __init__(self, jnet, params, cfg):
        self.jnet, self.cfg = jnet, cfg
        self.state = jax_ppo.AgentTrainState(
            params=params, opt_state=jax_ppo.make_optimizer(cfg).init(params))

    def update(self, steps, returns, key, discard):
        """The PPO update (recurrent, or flat over the T·N rows) → the
        permutations it drew, for the port."""
        self.state, _ = jax_ppo.make_ppo_update(self.jnet, self.cfg, N)(
            self.state, steps, returns, self.jnet.initial_carry((N,)), key,
            discard)
        rows = N if self.jnet.is_recurrent else steps.rewards.size
        perms = jax.vmap(lambda r: jax.random.permutation(r, rows))(
            jax.random.split(key, self.cfg.ppo_epoch))
        return torch.tensor(np.asarray(perms))


class JaxCycles:
    """The runner's REPAIRED and minimax cycles rebuilt from the JAX
    package's public functions (JAX runner :527-643, :674-752)."""

    def __init__(self, args, jenv, students, teacher, shared):
        self.args, self.jenv = args, jenv
        self.learners = [Learner(j, p, jax_cfg(args)) for j, p in students]
        self.teacher = Learner(*teacher, jax_cfg(args, teacher=True))
        self.plr_cfg = plr_config(args) if args.use_plr else None
        self.bufs = None
        if args.use_plr:
            buf = jplr.init_plr(self.plr_cfg, (15, 15, 3))
            self.bufs = [buf, None if shared else buf]
        self.t_rollout = self.t_next = None

    def buf_of(self, i):
        return self.bufs[i] if self.bufs[i] is not None else self.bufs[0]

    def set_buf(self, i, buf):
        self.bufs[i if self.bufs[i] is not None else 0] = buf

    def phase(self, i, env_states, seeds, actions, key, discard, fold,
              reset_seeds=None):
        """Student i's rollout, GAE, fold into its buffer, PPO update →
        (rollout stats, staged scores and counts, permutations)."""
        args, jenv, learner = self.args, self.jenv, self.learners[i]
        r_ro, r_upd = jax.random.split(key)
        act_keys, reset_keys = rollout_keys(r_ro, T, N)
        reset_fn = None
        if reset_seeds is not None:
            reset_fn = scripted_replay_reset(jenv, reset_keys, reset_seeds,
                                             self.buf_of(i).levels)
        st, obs = jax.vmap(jenv.reset_agent)(env_states)
        carry = jax_rollout.initial_step_carry(jenv, learner.jnet, st, obs,
                                               r_ro, level_seeds=seeds)
        _, steps, next_value, ro = jax_rollout.make_student_rollout(
            jenv, ScriptedJaxStudent(learner.jnet, act_keys, actions),
            jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True),
            reset_fn=reset_fn)(learner.state.params, carry)
        returns = jax_compute_gae(steps, next_value, args.gamma,
                                  args.gae_lambda,
                                  use_proper_time_limits=True)
        staged = None
        if fold:
            buf, *staged = jplr.update_with_rollout(
                self.buf_of(i), self.plr_cfg, steps, returns, steps.values)
            self.set_buf(i, buf)
        return ro, staged, learner.update(steps, returns, r_upd, discard)

    def teacher_update(self, ros, key):
        env_ret, _ = JaxRunner._env_return(
            SimpleNamespace(args=self.args),
            SimpleNamespace(env_return_rms=None), ros[0], ros[-1])
        t_ro = self.t_rollout.replace_final_reward(env_ret)
        returns = jax_compute_gae(t_ro, self.t_next, self.args.gamma,
                                  self.args.gae_lambda)
        return self.teacher.update(t_ro, returns, key, False), env_ret

    def generate(self, key, moves, acts):
        """→ the port's injected draws for the same cycle."""
        jenv = self.jenv
        k_reset, k_t, k_upd, *k_stu = jax.random.split(key, 3 + len(acts))
        t_keys, zs = adversary_keys(k_t, jenv.adversary_rollout_steps, N)
        jst, jobs, reset_draws = jax_reset(jenv, k_reset, N)
        levels, self.t_rollout, self.t_next = (
            jax_rollout.make_adversary_rollout(
                jenv, ScriptedJaxStudent(self.teacher.jnet, t_keys, moves),
                jenv.adversary_rollout_steps)(
                self.teacher.state.params, jst, jobs, k_t))
        seeds = jnp.arange(N, dtype=jnp.int32) + S
        ros, staged, perms = [], [], []
        for i, a in enumerate(acts):
            fold = self.bufs is not None and (i == 0
                                              or self.bufs[1] is not None)
            ro, st, p = self.phase(i, levels, seeds, a, k_stu[i],
                                   discard=self.bufs is not None, fold=fold)
            ros.append(ro)
            staged.append(st)
            perms.append(p)
        if self.bufs is not None:
            lv = jax.vmap(jenv.get_level)(levels)
            for i, st in enumerate(staged):
                if st is not None:
                    self.bufs[i] = jplr.promote_staged(
                        self.bufs[i], self.plr_cfg, lv, *st,
                        staged_solvable=levels.passable)
        t_perms, env_ret = self.teacher_update(ros, k_upd)
        roles = ('agent', 'adversary_agent')[:len(acts)]
        return dict(
            replay=False if self.bufs is not None else None,
            sample_action_fn=script(acts[0]),
            teacher_sample_fn=script(moves),
            teacher_draws_fn=lambda t: {'random_z': torch.tensor(zs[t])},
            reset_draws=reset_draws,
            perms={**dict(zip(roles, perms)), 'adversary_env': t_perms},
            **({'antagonist_sample_fn': script(acts[1])}
               if len(acts) > 1 else {})), levels, env_ret

    def replay(self, key, acts, rng):
        """Each student's levels drawn from its buffer, scripted resets
        drawn from its filled slots; the teacher's update on the stored
        rollout → the port's injected draws."""
        k_upd, *ks = jax.random.split(key, 1 + 2 * len(acts))
        inject, perms, ros = {}, {}, []
        names = (('replay_seeds', 'replay_reset_seeds', 'sample_action_fn',
                  'agent'),
                 ('antagonist_replay_seeds', 'antagonist_replay_reset_seeds',
                  'antagonist_sample_fn', 'adversary_agent'))
        for i, a in enumerate(acts):
            seeds, levels, buf = jplr.sample_replay_levels(
                self.buf_of(i), self.plr_cfg, ks[2 * i], N)
            self.set_buf(i, buf)
            filled = np.flatnonzero(np.asarray(buf.filled))
            resets = rng.choice(filled, (T, N)).astype(np.int32)
            st, _ = jax.vmap(self.jenv.reset_to_level)(levels)
            ro, _, p = self.phase(i, st, seeds, a, ks[2 * i + 1],
                                  discard=False, fold=True,
                                  reset_seeds=resets)
            ros.append(ro)
            k_seeds, k_resets, k_act, role = names[i]
            inject.update({
                k_seeds: torch.tensor(np.asarray(seeds)),
                k_resets: (lambda r: lambda t: torch.tensor(r[t]))(resets),
                k_act: script(a)})
            perms[role] = p
        t_perms, env_ret = self.teacher_update(ros, k_upd)
        return dict(replay=True, perms={**perms, 'adversary_env': t_perms},
                    **inject), env_ret


def script(actions):
    return lambda logits, t: torch.tensor(actions[t]).long()


def assert_all(runner, ref, models):
    for role, learner in zip(('agent', 'adversary_agent'), ref.learners):
        assert_params_close(learner.state.params, models[role],
                            atol=PARAM_TOL)
    assert_params_close(ref.teacher.state.params, models['adversary_env'],
                        atol=PARAM_TOL)
    if ref.bufs is not None:
        assert_buffers(runner.plr_buffer, ref.bufs[0], atol=1e-5)
        if ref.bufs[1] is None:
            assert runner.plr_antagonist is None
        else:
            assert_buffers(runner.plr_antagonist, ref.bufs[1], atol=1e-5)


@pytest.mark.parametrize('shared', [False, True],
                         ids=['own_buffers', 'antagonist_plr'])
def test_repaired_sequence_matches_jax_reference(shared):
    """Generate, replay, generate.  After each cycle the three models'
    weights within PARAM_TOL = 1e-5 and the buffers within 1e-5 (levels,
    ids, counts and masks exact); the students' weights unchanged by the
    generate cycles (PLR⊥), the teacher's changed by every cycle."""
    flags = REPAIRED_FLAGS + (['--antagonist_plr', 'true'] if shared else [])
    args = parser.parse_args(flags)
    jenv = JaxEnv(JaxParams(**SHORT_EPISODES))
    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    (ja, pa, na), (jb, pb, nb) = student_pair(H, seed=4), student_pair(H, 5)
    jt, pt, nt = flat_teacher_pair(SHORT_EPISODES, seed=6)
    ref = JaxCycles(args, jenv, [(ja, pa), (jb, pb)], (jt, pt), shared)
    models = {'agent': na, 'adversary_agent': nb, 'adversary_env': nt}
    runner = AdversarialRunner(args, env, models, 'cpu')
    assert (runner.plr_antagonist is None) == shared
    rng = np.random.default_rng(40)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    weights = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    moved = lambda m, w: max(float((v - w[k]).abs().max())
                             for k, v in m.state_dict().items())

    history = []
    for cycle, key in zip(('generate', 'replay', 'generate'), keys):
        before = {r: weights(m) for r, m in models.items()}
        acts = [action_script(rng, T, N) for _ in range(2)]
        if cycle == 'generate':
            inject, _, env_ret = ref.generate(
                key, near_goal_moves(rng, N), acts)
        else:
            inject, env_ret = ref.replay(key, acts, rng)
        stats = runner.run(**inject)
        history.append(stats)
        assert_all(runner, ref, models)
        np.testing.assert_allclose(stats['mean_env_return'],
                                   float(env_ret.mean()), atol=1e-5)
        assert moved(nt, before['adversary_env']) > 1e-4
        for r in ('agent', 'adversary_agent'):
            assert (moved(models[r], before[r]) > 1e-4) == (cycle == 'replay')

    assert [s['level_replay'] for s in history] == [0, 1, 0]
    assert [s['total_student_grad_updates'] for s in history] == [0, 1, 1]
    assert history[-1]['total_seeds'] == 2 * N
    filled = int(np.asarray(ref.bufs[0].filled).sum())
    assert filled == 2 * N      # the antagonist stages into its own buffer
    assert 'mean_adversary_agent_return' in history[-1]
    assert 'plr_passable_ratio' in history[1]


def test_minimax_cycle_matches_jax_reference():
    """One minimax cycle with the teacher without a core: the student's and
    the teacher's weights within PARAM_TOL = 1e-5, the teacher's return
    (minus the student's best) within 1e-5."""
    args = parser.parse_args(MINIMAX_FLAGS)
    jenv = JaxEnv(JaxParams(**SHORT_EPISODES))
    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    ja, pa, na = student_pair(H, seed=7)
    jt, pt, nt = flat_teacher_pair(SHORT_EPISODES, seed=8)
    ref = JaxCycles(args, jenv, [(ja, pa)], (jt, pt), shared=False)
    models = {'agent': na, 'adversary_env': nt}
    runner = AdversarialRunner(args, env, models, 'cpu')
    rng = np.random.default_rng(41)
    inject, levels, env_ret = ref.generate(
        jax.random.PRNGKey(3), near_goal_moves(rng, N),
        [action_script(rng, T, N)])
    stats = runner.run(**inject)
    assert_all(runner, ref, models)
    np.testing.assert_allclose(stats['mean_env_return'],
                               float(env_ret.mean()), atol=1e-5)
    assert stats['mean_env_return'] < 0       # some level was solved
    np.testing.assert_allclose(stats['passable_ratio'],
                               float(levels.passable.mean()), atol=1e-6)


@pytest.mark.parametrize('config', ['repaired', 'minimax'])
def test_train_runs_the_shipped_configs(config, capsys):
    """Two cycles of each config through ``train.main`` (N = 8, the A.4
    flags off): finite stats, the teacher without a core, and for REPAIRED
    both buffers staged (PLR⊥: no student gradient step), on the 6x6 env
    with 64-step rollouts so that every level ends an episode."""
    flags, steps = MINIMAX_FLAGS, T
    if config == 'repaired':
        steps = 64
        flags = REPAIRED_FLAGS + ['--env_name', 'MultiGrid-MiniAdversarial-v0',
                                  '--num_steps', str(steps)]
    runner, history = train.main(flags + ['--num_env_steps',
                                          str(2 * N * steps)])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(history) == len(lines) == 2
    assert not runner.models['adversary_env'].is_recurrent
    for stats in history:
        assert all(np.isfinite(v) for v in stats.values())
        assert 'adversary_env_pg_loss' in stats
    if config == 'repaired':
        assert [s['level_replay'] for s in history] == [0, 0]
        assert history[-1]['total_student_grad_updates'] == 0
        for buf in (runner.plr_buffer, runner.plr_antagonist):
            assert int(buf.filled.sum()) > 0
    else:
        assert set(runner.models) == {'agent', 'adversary_env'}
        assert runner.plr_buffer is None
