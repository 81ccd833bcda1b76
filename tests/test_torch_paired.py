"""The port's PAIRED cycle against the JAX package: the teacher's return
(``_env_return``) against the JAX runner's method, one whole PAIRED cycle
against a reference cycle built from the JAX package's public functions,
and the training entry point for the teacher-trained methods.

As in test_torch_cycle.py, every random draw is injected into both sides:
numpy draws the move and action scripts, the JAX package draws the start
directions, ``random_z`` and the PPO permutations.
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
from dcd_isaac_tpu.runner.adversarial_runner import (
    RMS as JaxRMS, AdversarialRunner as JaxRunner,
)
from dcd_isaac_tpu_torch import train
from dcd_isaac_tpu_torch.arguments import parser
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.runner.adversarial_runner import (
    RMS, AdversarialRunner,
)
from test_torch_algos import (
    H, N, SHORT_EPISODES, T, ScriptedJaxStudent, action_script,
    assert_params_close, rollout_keys, student_pair,
)
from test_torch_teacher import adversary_keys, jax_reset, teacher_pair

# mg_25b_paired.json cut to N=8, T=16, LSTM-32 for all three nets.
PAIRED_FLAGS = [
    '--env_name', 'MultiGrid-GoalLastFewerBlocksAdversarial-v0',
    '--ued_algo', 'paired', '--use_plr', 'false',
    '--num_processes', str(N), '--num_steps', str(T), '--ppo_epoch', '5',
    '--num_mini_batch', '1', '--handle_timelimits', 'true', '--lr', '1e-4',
    '--gamma', '0.995', '--entropy_coef', '0.0', '--adv_entropy_coef', '0.0',
    '--recurrent_arch', 'lstm', '--recurrent_agent', 'true',
    '--recurrent_adversary_env', 'true', '--recurrent_hidden_size', str(H),
    '--no_cuda', 'true']


# -- (e) the teacher's return ---------------------------------------------

@pytest.mark.parametrize('clip', [None, 0.3])
@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('algo', ['paired', 'flexible_paired', 'minimax'])
def test_env_return_matches_jax(algo, normalize, clip):
    """Two cycles of returns: the port's teacher return and running
    statistics equal the JAX runner's within 1e-6."""
    argv = PAIRED_FLAGS + ['--ued_algo', algo, '--adv_normalize_returns',
                           str(normalize).lower()]
    if clip is not None:
        argv += ['--adv_clip_reward', str(clip)]
    args = parser.parse_args(argv)
    port = SimpleNamespace(args=args, env_return_rms=(
        RMS.create('cpu') if normalize else None))
    jstate = SimpleNamespace(env_return_rms=(
        JaxRMS.create() if normalize else None))
    rng = np.random.default_rng(0)
    for _ in range(2):
        ro = []
        for _ in range(2):
            mean = rng.random(N) * (rng.random(N) < 0.7)
            ro.append({'mean_return': mean.astype(np.float32),
                       'max_return': (mean + rng.random(N) * 0.3 * (mean > 0)
                                      ).astype(np.float32)})
        got = AdversarialRunner._env_return(
            port, *({k: torch.tensor(v) for k, v in r.items()} for r in ro))
        want, rms = JaxRunner._env_return(
            SimpleNamespace(args=args), jstate,
            *({k: jnp.asarray(v) for k, v in r.items()} for r in ro))
        jstate.env_return_rms = rms
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
        if normalize:
            for f in ('mean', 'var', 'count'):
                np.testing.assert_allclose(
                    float(getattr(port.env_return_rms, f)),
                    float(getattr(rms, f)), rtol=1e-6, err_msg=f)
    assert (got != 0).any()


# -- (f) one whole PAIRED cycle -------------------------------------------

def near_goal_moves(rng, n, interior=13, n_walls=25):
    """(27, n) goal-last teacher moves: 25 random walls, then a goal one or
    two cells from the agent's cell, so scripted students reach it."""
    moves = np.zeros((n_walls + 2, n), np.int32)
    loc = lambda x, y: (y - 1) * interior + (x - 1)
    for i in range(n):
        ax, ay = rng.integers(2, interior, 2)
        dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1), (2, 0), (1, 1)][
            rng.integers(6)]
        moves[:n_walls, i] = rng.integers(0, interior * interior, n_walls)
        moves[n_walls, i] = loc(ax + dx, ay + dy)
        moves[n_walls + 1, i] = loc(ax, ay)
    return moves


def jax_student_phase(jenv, jnet, params, levels, actions, key, cfg, args):
    """Rollout (same-level resets), GAE and PPO update of one student from
    the JAX package's functions → (new params, update stats, rollout
    stats, the update's permutations)."""
    r_ro, r_upd = jax.random.split(key)
    act_keys, _ = rollout_keys(r_ro, T, N)
    st, obs = jax.vmap(jenv.reset_agent)(levels)
    carry = jax_rollout.initial_step_carry(
        jenv, jnet, st, obs, r_ro, level_seeds=jnp.full((N,), -1, jnp.int32))
    _, steps, next_value, ro_stats = jax_rollout.make_student_rollout(
        jenv, ScriptedJaxStudent(jnet, act_keys, actions),
        jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True),
    )(params, carry)
    returns = jax_compute_gae(steps, next_value, args.gamma, args.gae_lambda,
                              use_proper_time_limits=True)
    new, upd = jax_ppo_update(jnet, cfg, params, steps, returns, r_upd)
    return new, upd, ro_stats, perms_of(r_upd, cfg)


def jax_ppo_update(jnet, cfg, params, steps, returns, key):
    state = jax_ppo.AgentTrainState(
        params=params, opt_state=jax_ppo.make_optimizer(cfg).init(params))
    return jax_ppo.make_ppo_update(jnet, cfg, N)(
        state, steps, returns, jnet.initial_carry((N,)), key, False)


def perms_of(key, cfg):
    """The minibatch permutations JAX make_ppo_update draws from ``key``."""
    perms = jax.vmap(lambda r: jax.random.permutation(r, N))(
        jax.random.split(key, cfg.ppo_epoch))
    return torch.tensor(np.asarray(perms))


def test_paired_cycle_matches_jax_reference():
    args = parser.parse_args(PAIRED_FLAGS)
    jnet_a, params_a, net_a = student_pair(H, seed=4)
    jnet_b, params_b, net_b = student_pair(H, seed=5)
    jnet_t, params_t, net_t = teacher_pair(SHORT_EPISODES, H, N, seed=6)
    moves = near_goal_moves(np.random.default_rng(20), N)
    acts_a = action_script(np.random.default_rng(23), T, N)
    acts_b = action_script(np.random.default_rng(24), T, N)
    cfg_kw = dict(clip_param=args.clip_param,
                  value_loss_coef=args.value_loss_coef, lr=args.lr,
                  eps=args.eps, clip_value_loss=args.clip_value_loss)
    cfg = jax_ppo.PPOConfig(
        ppo_epoch=args.ppo_epoch, num_mini_batch=args.num_mini_batch,
        entropy_coef=args.entropy_coef, max_grad_norm=args.max_grad_norm,
        **cfg_kw)
    adv_cfg = jax_ppo.PPOConfig(
        ppo_epoch=args.adv_ppo_epoch, num_mini_batch=args.adv_num_mini_batch,
        entropy_coef=args.adv_entropy_coef,
        max_grad_norm=args.adv_max_grad_norm, **cfg_kw)

    # --- reference cycle from the JAX package's public functions ---------
    jenv = JaxEnv(JaxParams(**SHORT_EPISODES))
    k_reset, k_t, k_a, k_b, k_upd = jax.random.split(jax.random.PRNGKey(0), 5)
    T_adv = jenv.adversary_rollout_steps
    t_keys, zs = adversary_keys(k_t, T_adv, N)
    jst, jobs, reset_draws = jax_reset(jenv, k_reset, N)
    levels, t_steps, t_next = jax_rollout.make_adversary_rollout(
        jenv, ScriptedJaxStudent(jnet_t, t_keys, moves), T_adv)(
        params_t, jst, jobs, k_t)
    new_a, upd_a, ro_a, perms_a = jax_student_phase(
        jenv, jnet_a, params_a, levels, acts_a, k_a, cfg, args)
    new_b, upd_b, ro_b, perms_b = jax_student_phase(
        jenv, jnet_b, params_b, levels, acts_b, k_b, cfg, args)
    env_ret, _ = JaxRunner._env_return(
        SimpleNamespace(args=args), SimpleNamespace(env_return_rms=None),
        ro_a, ro_b)
    t_ro = t_steps.replace_final_reward(env_ret)
    t_returns = jax_compute_gae(t_ro, t_next, args.gamma, args.gae_lambda)
    new_t, upd_t = jax_ppo_update(jnet_t, adv_cfg, params_t, t_ro, t_returns,
                                  k_upd)

    # --- the port's runner ------------------------------------------------
    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    models = {'agent': net_a, 'adversary_agent': net_b,
              'adversary_env': net_t}
    before = {r: {k: v.clone() for k, v in m.state_dict().items()}
              for r, m in models.items()}
    runner = AdversarialRunner(args, env, models, 'cpu')
    script = lambda acts: (lambda logits, t: torch.tensor(acts[t]).long())
    stats = runner.run(
        sample_action_fn=script(acts_a), antagonist_sample_fn=script(acts_b),
        teacher_sample_fn=script(moves),
        teacher_draws_fn=lambda t: {'random_z': torch.tensor(zs[t])},
        reset_draws=reset_draws,
        perms={'agent': perms_a, 'adversary_agent': perms_b,
               'adversary_env': perms_of(k_upd, adv_cfg)})

    for role, jparams in (('agent', new_a.params),
                          ('adversary_agent', new_b.params),
                          ('adversary_env', new_t.params)):
        assert_params_close(jparams, models[role], atol=1e-4)
        moved = max(float((v - before[role][k]).abs().max())
                    for k, v in models[role].state_dict().items())
        assert moved > 1e-4, role
    np.testing.assert_allclose(stats['mean_env_return'],
                               float(env_ret.mean()), atol=1e-4)
    assert stats['mean_env_return'] > 0     # some regret reached the teacher
    for port_key, jupd, key in (
            ('agent_value_loss', upd_a, 'value_loss'),
            ('adversary_value_loss', upd_b, 'value_loss'),
            ('adversary_pg_loss', upd_b, 'action_loss'),
            ('adversary_env_pg_loss', upd_t, 'action_loss'),
            ('adversary_env_value_loss', upd_t, 'value_loss'),
            ('adversary_env_dist_entropy', upd_t, 'dist_entropy')):
        np.testing.assert_allclose(stats[port_key], float(jupd[key]),
                                   atol=1e-4, err_msg=port_key)
    np.testing.assert_allclose(
        stats['mean_adversary_agent_return_batch'],
        float(ro_b['mean_return'].mean()), atol=1e-6)
    np.testing.assert_allclose(stats['passable_ratio'],
                               float(levels.passable.mean()), atol=1e-6)
    assert stats['steps'] == N * T and stats['total_student_grad_updates'] == 1


# -- (g) the training entry point -----------------------------------------

@pytest.mark.parametrize('algo', ['paired', 'flexible_paired', 'minimax'])
def test_train_entry_point_runs_teacher_cycles(algo, capsys):
    runner, history = train.main(
        PAIRED_FLAGS + ['--ued_algo', algo, '--num_env_steps',
                        str(2 * N * T)])
    assert len(history) == 2 and runner.num_updates == 2
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l['update'] for l in lines] == [1, 2]
    assert set(runner.models) == (
        {'agent', 'adversary_env'} if algo == 'minimax'
        else {'agent', 'adversary_agent', 'adversary_env'})
    for stats in history:
        assert all(np.isfinite(v) for v in stats.values())
        assert 0 < stats['num_blocks'] <= 25
        assert 'adversary_env_pg_loss' in stats
        assert ('mean_adversary_agent_return' in stats) == (algo != 'minimax')
    assert history[-1]['steps'] == 2 * N * T


def test_train_runs_the_bench_env():
    """bench.py's env (50 blocks, goal first, 52 teacher moves)."""
    runner, history = train.main(
        PAIRED_FLAGS + ['--env_name', 'MultiGrid-Adversarial-v0',
                        '--num_env_steps', str(N * T)])
    assert runner.env.adversary_rollout_steps == 52
    assert len(history) == 1
    assert all(np.isfinite(v) for v in history[0].values())
    assert 0 < history[0]['num_blocks'] <= 50
