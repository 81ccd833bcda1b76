"""The DCD cycle, domain-randomization slice.

Port of ``dcd_isaac_tpu/runner/adversarial_runner.py`` for
``--ued_algo domain_randomization --use_plr false``: each cycle draws N
random levels (``reset_random``), rolls the student out with DR auto-reset
(a fresh random level for every finished episode), runs GAE and the
recurrent PPO update, and assembles the reference's per-cycle stats.
There is no teacher to train.  The cycle runs eagerly on the runner's
device; ``run`` reads its stats back to the host once.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..algos.ppo import PPOConfig, init_agent_state, make_ppo_update
from ..algos.rollout import (
    RolloutConfig, initial_step_carry, make_student_rollout,
)
from ..algos.storage import compute_gae

# The slice of the port each other method waits for (ROADMAP.md queue A).
_WAITS = {
    'paired': 'the PAIRED slice',
    'flexible_paired': 'the PAIRED slice',
    'minimax': 'the PAIRED slice',
    'alp_gmm': 'the remaining-methods slice',
}


class AdversarialRunner:
    """Owns the student, its optimizer and the host-side counters."""

    def __init__(self, args, env, models: Dict[str, torch.nn.Module],
                 device):
        if args.ued_algo != 'domain_randomization':
            raise NotImplementedError(
                f'ued_algo={args.ued_algo!r} is not ported yet; it waits '
                f'for {_WAITS.get(args.ued_algo, "a later slice")}')
        for flag in ('use_plr', 'use_editor', 'normalize_returns',
                     'use_popart'):
            if getattr(args, flag):
                raise NotImplementedError(f'--{flag} is not ported yet')
        self.args = args
        self.env = env
        self.models = models
        self.device = torch.device(device)
        N = args.num_processes

        self.ppo_cfg = PPOConfig(
            clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
            num_mini_batch=args.num_mini_batch,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
            max_grad_norm=args.max_grad_norm,
            clip_value_loss=args.clip_value_loss)
        self._student_ro_cfg = RolloutConfig(
            num_steps=args.num_steps, clip_reward=args.clip_reward,
            handle_timelimits=args.handle_timelimits)

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(args.seed)
        model = models['agent']
        self.agent = init_agent_state(model, self.ppo_cfg)
        self.update_agent = make_ppo_update(model, self.ppo_cfg, N)

        # host-side bookkeeping (reference runner.reset())
        self.num_updates = 0
        self.total_num_edits = 0
        self.total_episodes_collected = 0
        self.total_seeds_collected = 0
        self.student_grad_updates = 0
        self.agent_returns = deque(maxlen=10)

    # ------------------------------------------------------------------
    def _reset_random_fn(self):
        env, n = self.env, self.args.num_processes

        def reset_fn(t, state, seeds):
            state, obs = env.reset_random(n, self.generator, self.device)
            return state, obs, seeds
        return reset_fn

    def _generate_levels(self, levels: Optional[torch.Tensor] = None):
        """DR levels (the reset_random branch, :342-344), or given levels."""
        if levels is not None:
            env_states, _ = self.env.reset_to_level(levels.to(self.device))
        else:
            env_states, _ = self.env.reset_random(
                self.args.num_processes, self.generator, self.device)
        return env_states

    def _student_phase(self, env_states, level_seeds, rollout_fn,
                       perms=None):
        """Rollout, GAE and PPO update (:397-464, without PLR)."""
        args = self.args
        model = self.models['agent']
        env_states, obs = self.env.reset_agent(env_states)
        carry = initial_step_carry(model, env_states, obs, level_seeds)
        _, steps, next_value, ro_stats = rollout_fn(carry, self.generator)
        returns = compute_gae(
            steps, next_value, args.gamma, args.gae_lambda,
            use_proper_time_limits=args.handle_timelimits)
        upd_stats = self.update_agent(
            self.agent, steps, returns,
            model.initial_carry((args.num_processes,), self.device),
            self.generator, False, perms)
        return {'rollout': ro_stats, 'update': upd_stats}

    def _env_return(self, agent_ro):
        """Teacher return (:487-511).  DR has no teacher: zeros, which
        return normalization and clipping leave at zero."""
        return torch.zeros_like(agent_ro['mean_return'])

    def _device_stats(self, env_states, a_info, env_ret):
        ro, upd = a_info['rollout'], a_info['update']
        max_r = ro['max_return']
        solved = max_r > 0
        spl = env_states.shortest_path_length.float()
        return {
            'mean_env_return': env_ret.mean(),
            'agent_value_loss': upd['value_loss'],
            'agent_pg_loss': upd['action_loss'],
            'agent_dist_entropy': upd['dist_entropy'],
            'agent_grad_norm': upd['grad_norm'],
            'mean_agent_return_batch': ro['mean_return'].mean(),
            'episodes': ro['episode_count'].sum(),
            'returns_sum': (ro['mean_return'] * ro['episode_count']).sum(),
            'num_blocks': env_states.n_clutter_placed.float().mean(),
            'passable_ratio': env_states.passable.float().mean(),
            'shortest_path_length': spl.mean(),
            'solved_path_length': torch.where(
                solved.any(),
                (spl * solved).sum() / solved.sum().clamp(min=1),
                torch.zeros_like(spl[0])),
        }

    # ------------------------------------------------------------------
    def run(self, levels: Optional[torch.Tensor] = None,
            sample_action_fn: Optional[Callable] = None,
            reset_fn: Optional[Callable] = None,
            perms: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """One DR cycle; returns the host-side stats dict.

        The keyword arguments replace the cycle's random draws (the parity
        tests inject them): ``levels`` (N, W, H, 3) for the cycle's levels,
        ``sample_action_fn(logits, t)`` for the student's actions,
        ``reset_fn(t, state, seeds)`` for the auto-reset levels and
        ``perms`` (ppo_epoch, N) for the minibatch permutations.
        """
        N = self.args.num_processes
        env_states = self._generate_levels(levels)
        seeds = torch.full((N,), -1, dtype=torch.int32, device=self.device)
        rollout_fn = make_student_rollout(
            self.env, self.models['agent'], self._student_ro_cfg,
            reset_fn=reset_fn or self._reset_random_fn(),
            sample_action_fn=sample_action_fn)
        self.student_grad_updates += 1
        a_info = self._student_phase(env_states, seeds, rollout_fn, perms)
        env_ret = self._env_return(a_info['rollout'])
        stats = self._device_stats(env_states, a_info, env_ret)
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
        host['mean_agent_return'] = (
            float(np.mean(self.agent_returns)) if self.agent_returns else 0.0)
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
