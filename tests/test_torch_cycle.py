"""One domain-randomization cycle of the port's runner against a reference
cycle built from the JAX package's public functions (rollout with
scripted actions and reset levels, GAE, PPO update), with the same
levels, actions and minibatch permutations injected into both."""

import json

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
from dcd_isaac_tpu_torch import train
from dcd_isaac_tpu_torch.arguments import check_args, parser
from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
    AdversarialMultiGrid,
)
from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
from dcd_isaac_tpu_torch.runner.adversarial_runner import AdversarialRunner
from test_torch_algos import (
    H, N, SHORT_EPISODES, T, ScriptedJaxStudent, action_script,
    assert_params_close, near_goal_levels, rollout_keys, scripted_jax_reset,
    scripted_port, student_pair,
)

# mg_25b_dr.json without PLR, cut to N=8, T=16, LSTM-32.
DR_FLAGS = ['--env_name', 'MultiGrid-GoalLastFewerBlocksAdversarial-v0',
            '--ued_algo', 'domain_randomization', '--use_plr', 'false',
            '--num_processes', str(N), '--num_steps', str(T),
            '--ppo_epoch', '5', '--num_mini_batch', '1',
            '--handle_timelimits', 'true', '--lr', '1e-4', '--gamma', '0.995',
            '--entropy_coef', '0.01', '--recurrent_hidden_size', str(H),
            '--no_cuda', 'true']


def test_dr_cycle_matches_jax_reference():
    args = parser.parse_args(DR_FLAGS)
    jnet, params, net = student_pair(H, seed=4)
    levels0 = near_goal_levels(N, seed=21)
    reset_levels = near_goal_levels(T * N, seed=22).reshape(T, N, 15, 15, 3)
    actions = action_script(np.random.default_rng(23), T, N)

    # --- reference cycle from the JAX package's public functions ---------
    jenv = JaxEnv(JaxParams(**SHORT_EPISODES))
    r_stu, r_upd = jax.random.split(jax.random.PRNGKey(0))
    act_keys, reset_keys = rollout_keys(r_stu, T, N)
    jst, _ = jax.vmap(jenv.reset_to_level)(jnp.asarray(levels0))
    jst, jobs = jax.vmap(jenv.reset_agent)(jst)
    carry = jax_rollout.initial_step_carry(
        jenv, jnet, jst, jobs, r_stu,
        level_seeds=jnp.full((N,), -1, jnp.int32))
    _, steps, next_value, ro_stats = jax_rollout.make_student_rollout(
        jenv, ScriptedJaxStudent(jnet, act_keys, actions),
        jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True),
        reset_fn=scripted_jax_reset(jenv, reset_keys, reset_levels),
    )(params, carry)
    returns = jax_compute_gae(steps, next_value, args.gamma, args.gae_lambda,
                              use_proper_time_limits=True)
    cfg = jax_ppo.PPOConfig(
        clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
        num_mini_batch=args.num_mini_batch,
        value_loss_coef=args.value_loss_coef,
        entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
        max_grad_norm=args.max_grad_norm,
        clip_value_loss=args.clip_value_loss)
    jstate = jax_ppo.AgentTrainState(
        params=params, opt_state=jax_ppo.make_optimizer(cfg).init(params))
    jnew, jupd = jax_ppo.make_ppo_update(jnet, cfg, N)(
        jstate, steps, returns, jnet.initial_carry((N,)), r_upd, False)
    perms = jax.vmap(lambda r: jax.random.permutation(r, N))(
        jax.random.split(r_upd, cfg.ppo_epoch))

    # --- the port's runner ------------------------------------------------
    env = AdversarialMultiGrid(MultiGridParams(**SHORT_EPISODES))
    runner = AdversarialRunner(args, env, {'agent': net}, 'cpu')
    before = {k: v.clone() for k, v in net.state_dict().items()}
    sample, reset = scripted_port(env, actions, reset_levels)
    stats = runner.run(levels=torch.tensor(levels0), sample_action_fn=sample,
                       reset_fn=reset, perms=torch.tensor(np.asarray(perms)))

    assert_params_close(jnew.params, net, atol=1e-4)
    moved = max(float((v - before[k]).abs().max())
                for k, v in net.state_dict().items())
    assert moved > 1e-4     # the update moved the params beyond the tolerance
    assert stats['episodes'] == int(ro_stats['episode_count'].sum()) > N
    np.testing.assert_allclose(stats['mean_agent_return_batch'],
                               float(ro_stats['mean_return'].mean()),
                               atol=1e-6)
    assert stats['mean_agent_return_batch'] > 0
    for port_key, jax_key in (('agent_value_loss', 'value_loss'),
                              ('agent_pg_loss', 'action_loss'),
                              ('agent_dist_entropy', 'dist_entropy'),
                              ('agent_grad_norm', 'grad_norm')):
        np.testing.assert_allclose(stats[port_key], float(jupd[jax_key]),
                                   atol=1e-4, err_msg=port_key)
    assert stats['steps'] == N * T and stats['total_student_grad_updates'] == 1


def test_train_entry_point_runs_dr_cycles(capsys):
    runner, history = train.main(
        DR_FLAGS + ['--num_env_steps', str(2 * N * T)])
    assert len(history) == 2 and runner.num_updates == 2
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l['update'] for l in lines] == [1, 2]
    for stats in history:
        assert all(np.isfinite(v) for v in stats.values())
        assert stats['num_blocks'] == 12.0 and stats['passable_ratio'] == 1.0
    assert history[-1]['steps'] == 2 * N * T


@pytest.mark.parametrize('flags,error', [
    (['--ued_algo', 'paired'], NotImplementedError),
    (['--use_plr', 'true'], NotImplementedError),
    (['--bf16', 'true'], ValueError),
])
def test_unported_settings_are_refused(flags, error):
    with pytest.raises(error):
        train.main(DR_FLAGS + flags)


def test_train_runs_on_the_card_unless_no_cuda(monkeypatch):
    """``--no_cuda`` is the one device switch: without it the entry point
    asks for the card, and here, with none, it raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert DR_FLAGS[-2:] == ['--no_cuda', 'true']
    flags = DR_FLAGS[:-2]
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train.main(flags + ['--num_env_steps', str(N * T)])


def test_bf16_default_is_fp32():
    assert check_args(parser.parse_args(DR_FLAGS)).bf16 is None
