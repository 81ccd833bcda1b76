"""The DCD cycle: teacher → students → regret → teacher update.

Port of ``dcd_isaac_tpu/runner/adversarial_runner.py``'s generate cycle
(:527-643) for ``--use_plr false``:
  * ``domain_randomization``: N random levels (``reset_random``); the
    student rolls out with DR auto-reset (a fresh random level for every
    finished episode); no teacher.
  * ``paired``, ``flexible_paired``, ``minimax``: the teacher builds N
    levels move by move (``make_adversary_rollout``, kernel B5 with the
    teacher's projection B4); the protagonist, and for the PAIRED variants
    the antagonist, roll out on them with same-level auto-reset; the
    teacher's return (the regret, or minus the protagonist's best return)
    becomes the last reward of its rollout, and the teacher takes its own
    PPO update after both students.
Each student phase runs GAE and the recurrent PPO update.  The cycle runs
eagerly on the runner's device; ``run`` reads its stats back to the host
once.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..algos.ppo import PPOConfig, init_agent_state, make_ppo_update
from ..algos.rollout import (
    RolloutConfig, initial_step_carry, make_adversary_rollout,
    make_student_rollout,
)
from ..algos.storage import compute_gae

# The slice of the port each other method waits for (ROADMAP.md queue A).
_WAITS = {
    'alp_gmm': 'the remaining-methods slice',
}
_TEACHER_ALGOS = ('paired', 'flexible_paired', 'minimax')


@dataclasses.dataclass(frozen=True)
class RMS:
    """Running mean and variance of the teacher's returns (JAX runner
    :40-60, the reference's RunningMeanStd)."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device) -> 'RMS':
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return cls(f(0.0), f(1.0), f(1e-4))

    def update(self, x: torch.Tensor) -> 'RMS':
        bm, bv, bc = x.mean(), x.var(correction=0), x.shape[0]
        delta = bm - self.mean
        tot = self.count + bc
        new_mean = self.mean + delta * bc / tot
        m2 = self.var * self.count + bv * bc + delta ** 2 * self.count * bc / tot
        return RMS(new_mean, m2 / tot, tot)


class AdversarialRunner:
    """Owns the models, their optimizers and the host-side counters."""

    def __init__(self, args, env, models: Dict[str, torch.nn.Module],
                 device):
        algo = args.ued_algo
        if algo not in ('domain_randomization', *_TEACHER_ALGOS):
            raise NotImplementedError(
                f'ued_algo={algo!r} is not ported yet; it waits '
                f'for {_WAITS.get(algo, "a later slice")}')
        for flag in ('use_plr', 'use_editor', 'normalize_returns',
                     'use_popart', 'adv_use_popart'):
            if getattr(args, flag):
                raise NotImplementedError(f'--{flag} is not ported yet')
        self.args = args
        self.env = env
        self.models = models
        self.device = torch.device(device)
        self.is_training_env = algo in _TEACHER_ALGOS
        self.is_paired = algo in ('paired', 'flexible_paired')
        N = args.num_processes

        self.ppo_cfg = PPOConfig(
            clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
            num_mini_batch=args.num_mini_batch,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
            max_grad_norm=args.max_grad_norm,
            clip_value_loss=args.clip_value_loss)
        # The teacher's PPO (JAX runner :102-107).
        self.adv_ppo_cfg = dataclasses.replace(
            self.ppo_cfg, ppo_epoch=args.adv_ppo_epoch,
            num_mini_batch=args.adv_num_mini_batch,
            entropy_coef=args.adv_entropy_coef,
            max_grad_norm=args.adv_max_grad_norm)
        self._student_ro_cfg = RolloutConfig(
            num_steps=args.num_steps, clip_reward=args.clip_reward,
            handle_timelimits=args.handle_timelimits)

        # One train state, update and generator per role.
        roles = ['agent']
        if self.is_paired:
            roles.append('adversary_agent')
        if self.is_training_env:
            roles.append('adversary_env')
        self.train_states, self.updates, self.generators = {}, {}, {}
        for i, role in enumerate(roles):
            cfg = self.adv_ppo_cfg if role == 'adversary_env' else self.ppo_cfg
            self.train_states[role] = init_agent_state(models[role], cfg)
            self.updates[role] = make_ppo_update(models[role], cfg, N)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(args.seed + i)
            self.generators[role] = gen
        self.env_return_rms = (RMS.create(self.device)
                               if args.adv_normalize_returns else None)

        # host-side bookkeeping (reference runner.reset())
        self.num_updates = 0
        self.total_num_edits = 0
        self.total_episodes_collected = 0
        self.total_seeds_collected = 0
        self.student_grad_updates = 0
        self.agent_returns = deque(maxlen=10)
        self.adversary_agent_returns = deque(maxlen=10)

    # ------------------------------------------------------------------
    def _reset_random_fn(self):
        env, n = self.env, self.args.num_processes

        def reset_fn(t, state, seeds):
            state, obs = env.reset_random(n, self.generators['agent'],
                                          self.device)
            return state, obs, seeds
        return reset_fn

    def _generate_levels(self, levels: Optional[torch.Tensor] = None,
                         teacher_sample_fn: Optional[Callable] = None,
                         teacher_draws_fn: Optional[Callable] = None,
                         reset_draws: Optional[dict] = None):
        """→ (env_states, teacher rollout, teacher next value) (:321-344).

        The teacher builds the levels (``paired``, ``flexible_paired``,
        ``minimax``); DR draws them with ``reset_random``, or takes
        ``levels``.
        """
        N = self.args.num_processes
        if self.is_training_env:
            gen = self.generators['adversary_env']
            env_states, obs = self.env.reset(N, gen, self.device, reset_draws)
            rollout = make_adversary_rollout(
                self.env, self.models['adversary_env'],
                self.env.adversary_rollout_steps, teacher_sample_fn,
                teacher_draws_fn)
            return rollout(env_states, obs, gen)
        if levels is not None:
            env_states, _ = self.env.reset_to_level(levels.to(self.device))
        else:
            env_states, _ = self.env.reset_random(
                N, self.generators['agent'], self.device)
        return env_states, None, None

    def _student_phase(self, role, env_states, level_seeds, rollout_fn,
                       perms=None):
        """Rollout, GAE and PPO update of one student (:397-464, without
        PLR)."""
        args = self.args
        model = self.models[role]
        gen = self.generators[role]
        env_states, obs = self.env.reset_agent(env_states)
        carry = initial_step_carry(model, env_states, obs, level_seeds)
        _, steps, next_value, ro_stats = rollout_fn(carry, gen)
        returns = compute_gae(
            steps, next_value, args.gamma, args.gae_lambda,
            use_proper_time_limits=args.handle_timelimits)
        upd_stats = self.updates[role](
            self.train_states[role], steps, returns,
            model.initial_carry((args.num_processes,), self.device),
            gen, False, perms)
        return {'rollout': ro_stats, 'update': upd_stats}

    def _env_return(self, agent_ro, antag_ro):
        """The teacher's return (:487-511): the PAIRED regret, the
        flexible-PAIRED regret, minus the protagonist's best return
        (minimax), or zeros (DR); normalized by the running std with
        ``--adv_normalize_returns`` and clipped with ``--adv_clip_reward``.
        """
        args = self.args
        mean_p = agent_ro['mean_return']
        max_p = agent_ro['max_return']
        zero = torch.zeros_like(mean_p)
        if args.ued_algo == 'paired':
            env_ret = torch.maximum(antag_ro['max_return'] - mean_p, zero)
        elif args.ued_algo == 'flexible_paired':
            ant_wins = antag_ro['max_return'] > max_p
            env_max = torch.where(ant_wins, antag_ro['max_return'], max_p)
            env_mean = torch.where(ant_wins, mean_p, antag_ro['mean_return'])
            env_ret = torch.maximum(env_max - env_mean, zero)
        elif args.ued_algo == 'minimax':
            env_ret = -max_p
        else:
            env_ret = zero
        if self.env_return_rms is not None:
            self.env_return_rms = self.env_return_rms.update(env_ret)
            env_ret = env_ret / torch.sqrt(self.env_return_rms.var + 1e-8)
        if args.adv_clip_reward is not None:
            env_ret = env_ret.clamp(-args.adv_clip_reward,
                                    args.adv_clip_reward)
        return env_ret

    def _teacher_update(self, t_rollout, t_next_value, env_ret, perms=None):
        """The regret as the last reward, GAE, the teacher's PPO
        (:513-522)."""
        args = self.args
        t_rollout = t_rollout.replace_final_reward(env_ret)
        returns = compute_gae(t_rollout, t_next_value, args.gamma,
                              args.gae_lambda)
        model = self.models['adversary_env']
        return self.updates['adversary_env'](
            self.train_states['adversary_env'], t_rollout, returns,
            model.initial_carry((args.num_processes,), self.device),
            self.generators['adversary_env'], False, perms)

    def _device_stats(self, env_states, a_info, b_info, t_stats, env_ret):
        """The cycle's stats as device scalars (:798-840)."""
        ro, upd = a_info['rollout'], a_info['update']
        stats = {
            'mean_env_return': env_ret.mean(),
            'agent_value_loss': upd['value_loss'],
            'agent_pg_loss': upd['action_loss'],
            'agent_dist_entropy': upd['dist_entropy'],
            'agent_grad_norm': upd['grad_norm'],
            'mean_agent_return_batch': ro['mean_return'].mean(),
            'episodes': ro['episode_count'].sum(),
            'returns_sum': (ro['mean_return'] * ro['episode_count']).sum(),
        }
        max_r = ro['max_return']
        if b_info is not None:
            b_ro, b_upd = b_info['rollout'], b_info['update']
            stats.update({
                'adversary_value_loss': b_upd['value_loss'],
                'adversary_pg_loss': b_upd['action_loss'],
                'adversary_dist_entropy': b_upd['dist_entropy'],
                'mean_adversary_agent_return_batch':
                    b_ro['mean_return'].mean(),
                'adversary_episodes': b_ro['episode_count'].sum(),
                'adversary_returns_sum':
                    (b_ro['mean_return'] * b_ro['episode_count']).sum(),
            })
            # solved by either student (_get_env_stats_multigrid)
            max_r = torch.maximum(max_r, b_ro['max_return'])
        if t_stats is not None:
            stats.update({
                'adversary_env_pg_loss': t_stats['action_loss'],
                'adversary_env_value_loss': t_stats['value_loss'],
                'adversary_env_dist_entropy': t_stats['dist_entropy'],
            })
        solved = max_r > 0
        spl = env_states.shortest_path_length.float()
        stats.update({
            'num_blocks': env_states.n_clutter_placed.float().mean(),
            'passable_ratio': env_states.passable.float().mean(),
            'shortest_path_length': spl.mean(),
            'solved_path_length': torch.where(
                solved.any(),
                (spl * solved).sum() / solved.sum().clamp(min=1),
                torch.zeros_like(spl[0])),
        })
        return stats

    # ------------------------------------------------------------------
    def run(self, levels: Optional[torch.Tensor] = None,
            sample_action_fn: Optional[Callable] = None,
            reset_fn: Optional[Callable] = None,
            perms: Optional[Dict[str, torch.Tensor]] = None,
            antagonist_sample_fn: Optional[Callable] = None,
            teacher_sample_fn: Optional[Callable] = None,
            teacher_draws_fn: Optional[Callable] = None,
            reset_draws: Optional[dict] = None) -> Dict[str, float]:
        """One cycle; returns the host-side stats dict.

        The keyword arguments replace the cycle's random draws (the parity
        tests inject them): ``levels`` (N, W, H, 3) for DR's levels,
        ``sample_action_fn(logits, t)`` / ``antagonist_sample_fn`` /
        ``teacher_sample_fn`` for the actions of each role,
        ``reset_fn(t, state, seeds)`` for DR's auto-reset levels,
        ``reset_draws`` and ``teacher_draws_fn(t)`` for the draws of the
        teacher's ``reset`` and moves, and ``perms`` (role → (epochs, N))
        for the minibatch permutations.
        """
        N = self.args.num_processes
        perms = perms or {}
        env_states, t_rollout, t_next_value = self._generate_levels(
            levels, teacher_sample_fn, teacher_draws_fn, reset_draws)
        seeds = torch.full((N,), -1, dtype=torch.int32, device=self.device)
        if self.is_training_env:
            reset_fn = None     # same-level auto-reset (JAX _ro_same)
        else:
            reset_fn = reset_fn or self._reset_random_fn()
        self.student_grad_updates += 1
        a_info = self._student_phase(
            'agent', env_states, seeds, make_student_rollout(
                self.env, self.models['agent'], self._student_ro_cfg,
                reset_fn=reset_fn, sample_action_fn=sample_action_fn),
            perms.get('agent'))
        b_info = None
        if self.is_paired:
            b_info = self._student_phase(
                'adversary_agent', env_states, seeds, make_student_rollout(
                    self.env, self.models['adversary_agent'],
                    self._student_ro_cfg,
                    sample_action_fn=antagonist_sample_fn),
                perms.get('adversary_agent'))
        env_ret = self._env_return(
            a_info['rollout'],
            b_info['rollout'] if b_info is not None else a_info['rollout'])
        t_stats = None
        if self.is_training_env:
            t_stats = self._teacher_update(t_rollout, t_next_value, env_ret,
                                           perms.get('adversary_env'))
        stats = self._device_stats(env_states, a_info, b_info, t_stats,
                                   env_ret)
        self.total_seeds_collected += N
        self.num_updates += 1
        return self._host_assemble(stats)

    def _host_assemble(self, stats) -> Dict[str, float]:
        """Per-cycle stats on the host, with the run's counters (:986-1064)."""
        keys = list(stats)
        vals = torch.stack([stats[k].float() for k in keys]).tolist()
        host = dict(zip(keys, vals))
        n_epi = host.pop('episodes')
        ret_sum = host.pop('returns_sum')
        self.total_episodes_collected += int(n_epi)
        if n_epi > 0:
            self.agent_returns.append(ret_sum / n_epi)
        adv_epi = host.pop('adversary_episodes', None)
        adv_sum = host.pop('adversary_returns_sum', None)
        if adv_epi is not None and adv_epi > 0:
            self.adversary_agent_returns.append(adv_sum / adv_epi)
        host['mean_agent_return'] = (
            float(np.mean(self.agent_returns)) if self.agent_returns else 0.0)
        if self.is_paired:
            host['mean_adversary_agent_return'] = (
                float(np.mean(self.adversary_agent_returns))
                if self.adversary_agent_returns else 0.0)
        host.update({
            'episodes': int(n_epi),
            'steps': ((self.num_updates + self.total_num_edits)
                      * self.args.num_processes * self.args.num_steps),
            'total_episodes': self.total_episodes_collected,
            'total_seeds': self.total_seeds_collected,
            'total_student_grad_updates': self.student_grad_updates,
            'level_replay': 0,
            'total_num_edits': self.total_num_edits,
        })
        return host
