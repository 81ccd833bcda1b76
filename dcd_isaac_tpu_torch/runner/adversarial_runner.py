"""The DCD cycle: levels → students → regret → curriculum updates.

Port of ``dcd_isaac_tpu/runner/adversarial_runner.py``: the generate cycle
(:527-643), the replay cycle (:674-752), the edit cycle (:754-796) and the
host loop that picks them (:924-984).
  * ``domain_randomization`` without PLR: N random levels
    (``reset_random``, kernel B9); the student rolls out with DR
    auto-reset; no teacher.
  * ``domain_randomization`` with PLR (PLR, PLR⊥ with
    ``--no_exploratory_grad_updates``, ACCEL with ``--use_editor``): each
    cycle a coin on the buffer (``sample_replay_decision``) picks a
    generate cycle, whose N levels a uniform-random teacher builds
    (``_random_design``, kernel B5; the walker and CarRacing, whose
    teachers are not discrete, draw them with ``reset_random``: B11, or
    B13b's track build and B12's frame) and which are staged,
    scored and promoted into the buffer (PLR⊥ discards that cycle's
    gradients), or a
    replay cycle, which draws N levels from the buffer by their weights
    and again on every finished episode, and scores them.  With the
    editor, a second coin may follow a replay cycle with an edit cycle:
    the levels (or the 4 'easy' ones) are mutated, evaluated without a
    gradient step and staged.  The buffer is kernel B8's
    (``level_replay/plr.py``).
  * ``paired``, ``flexible_paired``, ``minimax``: the teacher builds N
    levels move by move (``make_adversary_rollout``, kernel B5 with the
    teacher's projection B4); the protagonist, and for the PAIRED variants
    the antagonist, roll out on them with same-level auto-reset; the
    teacher's return (the regret, or minus the protagonist's best return)
    becomes the last reward of its rollout, and the teacher takes its own
    PPO update after both students.
  * REPAIRED (``paired`` with ``--use_plr``, JAX runner :266-286,
    :527-643, :674-752): the teacher's generate cycle stages both
    students' levels (PLR⊥ discards both students' gradients) and keeps
    the teacher's rollout; a replay cycle draws each student's levels from
    its own buffer (the antagonist's, or with ``--protagonist_plr`` or
    ``--antagonist_plr`` the protagonist's), scores them, and updates the
    teacher on the last generate cycle's rollout with the replay's regret
    (zeros before the first generate cycle, as the JAX runner pre-fills).
Each student phase runs GAE and the PPO update (recurrent, or flat for
the walker's MLP and CarRacing's CNN).  With ``--normalize_returns`` the
student's rewards go through VecNormalize, whose running statistics
(``ret_rms``) carry across the generate, replay and edit cycles.  The cycle runs eagerly on the
runner's device; ``run`` reads the coins and the stats back to the host.
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
from ..algos.storage import Rollout, batched_value_loss, compute_gae
from ..level_replay import plr as plr_lib

# The slice of the port each other method waits for (ROADMAP.md queue A).
_WAITS = {
    'alp_gmm': 'the remaining-methods slice',
}
_TEACHER_ALGOS = ('paired', 'flexible_paired', 'minimax')
# The draws ``run`` lets a caller inject.
_INJECTED = ('levels', 'sample_action_fn', 'antagonist_sample_fn',
             'teacher_sample_fn', 'edit_sample_fn', 'reset_fn',
             'reset_draws', 'teacher_draws_fn', 'design', 'replay',
             'replay_seeds', 'replay_reset_seeds',
             'antagonist_replay_seeds', 'antagonist_replay_reset_seeds',
             'edit_coin', 'mutation_draws', 'perms')


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
        for flag in ('use_popart', 'adv_use_popart'):
            if getattr(args, flag):
                raise NotImplementedError(f'--{flag} is not ported yet')
        if args.use_plr and not args.train_full_distribution:
            raise NotImplementedError(
                '--train_full_distribution false (a fixed PLR seed set) is '
                'not ported yet; it waits for the remaining-methods slice')
        N = args.num_processes
        if (args.use_editor and args.base_levels == 'easy'
                and N % 4):
            raise ValueError('--base_levels easy requires num_processes % 4 '
                             '== 0')
        self.args = args
        self.env = env
        self.models = models
        self.device = torch.device(device)
        self.is_training_env = algo in _TEACHER_ALGOS
        self.is_paired = algo in ('paired', 'flexible_paired')
        self.use_plr = args.use_plr
        self.use_editor = args.use_editor
        self.robust_plr = args.no_exploratory_grad_updates

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
        # PLR's buffer of levels (JAX runner :109-139, :266-286); with
        # PAIRED the antagonist's own unless it shares the protagonist's
        self.plr_cfg = self.plr_buffer = self.plr_antagonist = None
        if self.use_plr:
            self.plr_cfg = plr_lib.PLRConfig(
                capacity=args.level_replay_seed_buffer_size,
                num_actors=N,
                full_distribution=args.train_full_distribution,
                strategy=args.level_replay_strategy,
                replay_schedule=args.level_replay_schedule,
                score_transform=args.level_replay_score_transform,
                temperature=args.level_replay_temperature,
                eps=args.level_replay_eps,
                rho=args.level_replay_rho,
                replay_prob=args.level_replay_prob,
                alpha=args.level_replay_alpha,
                staleness_coef=args.staleness_coef,
                staleness_transform=args.staleness_transform,
                staleness_temperature=args.staleness_temperature,
                seed_buffer_priority=args.level_replay_seed_buffer_priority,
                gamma=args.gamma,
                reject_unsolvable=args.reject_unsolvable_seeds)
            self.plr_buffer = plr_lib.init_plr(
                self.plr_cfg, env.level_shape, self.device,
                level_dtype=env.level_dtype)
            if self.is_paired and not (args.protagonist_plr
                                       or args.antagonist_plr):
                self.plr_antagonist = plr_lib.init_plr(
                    self.plr_cfg, env.level_shape, self.device,
                    level_dtype=env.level_dtype)
        self._student_ro_cfg = RolloutConfig(
            num_steps=args.num_steps, clip_reward=args.clip_reward,
            handle_timelimits=args.handle_timelimits,
            record_log_dists=self.use_plr and args.level_replay_strategy in (
                'policy_entropy', 'least_confidence', 'min_margin'),
            normalize_returns_gamma=0.99 if args.normalize_returns else None)
        # VecNormalize's statistics (JAX runner :311-315): the return
        # accumulator (N,), and the returns' mean, var and count
        self.ret_rms = None
        if args.normalize_returns:
            f = lambda v: torch.tensor(v, dtype=torch.float32,
                                       device=self.device)
            self.ret_rms = (torch.zeros(N, device=self.device), f(0.0),
                            f(1.0), f(1e-4))

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
        # The last generate cycle's teacher rollout and bootstrap value,
        # which a REPAIRED replay cycle updates the teacher on; zeros until
        # the first (JAX runner :293-301).
        self.teacher_rollout = self.teacher_next_value = None
        if self.is_training_env:
            self.teacher_rollout, self.teacher_next_value = (
                self._zero_teacher_rollout())

        # host-side bookkeeping (reference runner.reset())
        self.num_updates = 0
        self.total_num_edits = 0
        self.total_episodes_collected = 0
        self.total_seeds_collected = 0
        self.student_grad_updates = 0
        self.agent_returns = deque(maxlen=10)
        self.adversary_agent_returns = deque(maxlen=10)
        self.latest_env_stats = {}

    # ------------------------------------------------------------------
    def _zero_teacher_rollout(self):
        """An all-zero teacher rollout of the construction's shape, and a
        zero bootstrap value."""
        T, N = self.env.adversary_rollout_steps, self.args.num_processes
        dev = self.device
        z = lambda dtype=torch.float32: torch.zeros((T, N), dtype=dtype,
                                                   device=dev)
        dtypes = {'image': torch.uint8, 'time_step': torch.int32}
        obs = {k: torch.zeros((T, N, *shape), dtype=dtypes.get(
                   k, torch.float32), device=dev)
               for k, shape in self.env.adversary_obs_shapes.items()}
        rollout = Rollout(
            obs=obs, actions=z(torch.int64), log_probs=z(), values=z(),
            rewards=z(), masks_pre=z(), dones=z(torch.bool), bad_masks=z(),
            trunc_values=z())
        return rollout, torch.zeros((N,), device=dev)

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
                         reset_draws: Optional[dict] = None,
                         design: Optional[dict] = None):
        """→ (env_states, teacher rollout, teacher next value) (:321-344).

        The teacher builds the levels (``paired``, ``flexible_paired``,
        ``minimax``); DR with PLR builds them with a uniform-random teacher
        (``design`` holds its injected draws); DR without PLR draws them
        with ``reset_random``; ``levels`` replaces DR's.
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
        elif (self.use_plr and not self.args.use_reset_random_dr
              and self.env.adversary_discrete):
            env_states = self._random_design(**(design or {}))
        else:
            env_states, _ = self.env.reset_random(
                N, self.generators['agent'], self.device)
        return env_states, None, None

    def _random_design(self, actions_fn: Optional[Callable] = None,
                       draws_fn: Optional[Callable] = None,
                       reset_draws: Optional[dict] = None):
        """N levels built by a uniform-random teacher (:346-366): the
        construction's moves, kernel B5, with uniform random placements.
        ``actions_fn(t)`` and ``draws_fn(t)`` replace the moves and
        ``step_adversary``'s draws, ``reset_draws`` those of ``reset``."""
        env, N = self.env, self.args.num_processes
        gen = self.generators['agent']
        env_states, _ = env.reset(N, gen, self.device, reset_draws)
        for t in range(env.adversary_rollout_steps):
            if actions_fn is None:
                moves = torch.randint(0, env.adversary_num_actions, (N,),
                                      generator=gen, device=self.device,
                                      dtype=torch.int32)
            else:
                moves = actions_fn(t).to(self.device, torch.int32)
            env_states, _, _ = env.step_adversary(
                env_states, moves, gen,
                draws_fn(t) if draws_fn is not None else None)
        return env_states

    def _replay_reset_fn(self, levels, weights,
                         seeds_fn: Optional[Callable] = None,
                         role: str = 'agent'):
        """Mid-rollout replay resets (:233-244): each finished slot takes a
        level drawn by the weights frozen at the rollout's start, with the
        role's generator; ``seeds_fn(t)`` (N,) replaces the draws of step
        t."""
        env, N = self.env, self.args.num_processes
        gen = self.generators[role]

        def reset_fn(t, state, seeds):
            if seeds_fn is None:
                new = torch.multinomial(weights, N, replacement=True,
                                        generator=gen)
            else:
                new = seeds_fn(t).to(self.device, torch.int64)
            state, obs = env.reset_to_level(levels[new])
            return state, obs, new.int()
        return reset_fn

    def _student_phase(self, role, env_states, level_seeds, rollout_fn,
                       perms=None, discard_grad: bool = False, plr=None):
        """Rollout, GAE, PLR scoring and PPO update of one student
        (:397-464).  With a PLR buffer ``plr`` the rollout folds into it:
        the folded buffer comes back in ``info['plr']``, its staged scores
        and counts in ``info['staged']``."""
        args = self.args
        model = self.models[role]
        gen = self.generators[role]
        env_states, obs = self.env.reset_agent(env_states)
        carry = initial_step_carry(model, env_states, obs, level_seeds,
                                   self.ret_rms)
        final, steps, next_value, ro_stats = rollout_fn(carry, gen)
        self.ret_rms = final.ret_rms
        returns = compute_gae(
            steps, next_value, args.gamma, args.gae_lambda,
            use_proper_time_limits=args.handle_timelimits)
        info = {'rollout': ro_stats}
        if plr is not None:
            cfg = self.plr_cfg
            plr_returns = returns
            if cfg.strategy == 'alt_advantage_abs':
                plr_returns = compute_gae(
                    steps, next_value, cfg.alt_gamma, args.gae_lambda,
                    use_proper_time_limits=args.handle_timelimits)
            info['plr'], st_scores, st_counts = plr_lib.update_with_rollout(
                plr, cfg, steps, plr_returns, steps.values)
            info['staged'] = (st_scores, st_counts)
        if self.use_plr:
            info['batched_value_loss'] = batched_value_loss(
                returns, steps.values, clipped=not (
                    args.adv_use_popart or args.adv_normalize_returns))
        info['update'] = self.updates[role](
            self.train_states[role], steps, returns,
            model.initial_carry((args.num_processes,), self.device),
            gen, discard_grad, perms)
        return info

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

    def _teacher_update(self, env_ret, perms=None):
        """The regret as the last reward of the stored teacher rollout,
        GAE, the teacher's PPO (:513-522)."""
        args = self.args
        t_rollout = self.teacher_rollout.replace_final_reward(env_ret)
        returns = compute_gae(t_rollout, self.teacher_next_value, args.gamma,
                              args.gae_lambda)
        model = self.models['adversary_env']
        return self.updates['adversary_env'](
            self.train_states['adversary_env'], t_rollout, returns,
            model.initial_carry((args.num_processes,), self.device),
            self.generators['adversary_env'], False, perms)

    def _device_stats(self, env_states, a_info, b_info, t_stats, env_ret):
        """The cycle's stats as device scalars (:798-862), and the env
        complexity stats of ``env_states`` (None without them)."""
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
        env_stats = (None if env_states is None
                     else self.env.env_stats(env_states, max_r))
        if self.use_plr:
            stats.update(plr_lib.plr_stats(self.plr_buffer, self.plr_cfg))
        return stats, env_stats

    # ------------------------------------------------------------------
    # The cycles (:527-796)
    # ------------------------------------------------------------------
    def _cycle_generate(self, inj: dict):
        """New levels: the teacher's (with its update), DR's, or with PLR
        the random teacher's, staged and promoted into the buffer."""
        N = self.args.num_processes
        perms = inj.get('perms') or {}
        env_states, t_rollout, t_next_value = self._generate_levels(
            inj.get('levels'), inj.get('teacher_sample_fn'),
            inj.get('teacher_draws_fn'), inj.get('reset_draws'),
            inj.get('design'))
        if self.use_plr:
            seeds = (torch.arange(N, dtype=torch.int32, device=self.device)
                     + self.plr_cfg.capacity)
        else:
            seeds = torch.full((N,), -1, dtype=torch.int32,
                               device=self.device)
        if self.is_training_env or self.use_plr:
            reset_fn = None     # same-level auto-reset (JAX _ro_same)
        else:
            reset_fn = inj.get('reset_fn') or self._reset_random_fn()
        discard = self.use_plr and self.robust_plr
        a_info = self._student_phase(
            'agent', env_states, seeds, make_student_rollout(
                self.env, self.models['agent'], self._student_ro_cfg,
                reset_fn=reset_fn,
                sample_action_fn=inj.get('sample_action_fn')),
            perms.get('agent'), discard, self.plr_buffer)
        b_info = None
        if self.is_paired:
            b_info = self._student_phase(
                'adversary_agent', env_states, seeds, make_student_rollout(
                    self.env, self.models['adversary_agent'],
                    self._student_ro_cfg,
                    sample_action_fn=inj.get('antagonist_sample_fn')),
                perms.get('adversary_agent'), discard, self.plr_antagonist)
        if self.use_plr:
            levels = self.env.get_level(env_states)
            solvable = self.env.solvable(env_states)
            self.plr_buffer = plr_lib.promote_staged(
                a_info['plr'], self.plr_cfg, levels, *a_info['staged'],
                staged_solvable=solvable)
            if self.plr_antagonist is not None:
                self.plr_antagonist = plr_lib.promote_staged(
                    b_info['plr'], self.plr_cfg, levels, *b_info['staged'],
                    staged_solvable=solvable)
        env_ret = self._env_return(
            a_info['rollout'],
            b_info['rollout'] if b_info is not None else a_info['rollout'])
        t_stats = None
        if self.is_training_env:
            self.teacher_rollout, self.teacher_next_value = (
                t_rollout, t_next_value)
            t_stats = self._teacher_update(env_ret,
                                           perms.get('adversary_env'))
        return self._device_stats(env_states, a_info, b_info, t_stats,
                                  env_ret)

    def _cycle_replay(self, inj: dict):
        """N levels drawn from the buffer, and again for every finished
        episode; the student's rollout scores them.  With PAIRED the
        antagonist does the same on its own draws (from its buffer, or the
        shared one), and the teacher updates on its stored rollout with
        the two replays' regret (:701-738).  → ((stats, env stats), seeds,
        the 'easy' metric mean return - batched value loss)."""
        perms = inj.get('perms') or {}
        seeds, env_states, a_info, self.plr_buffer = self._replay_phase(
            'agent', self.plr_buffer, inj.get('replay_seeds'),
            inj.get('replay_reset_seeds'), inj.get('sample_action_fn'),
            perms.get('agent'))
        b_info = None
        if self.is_paired:
            shared = self.plr_antagonist is None
            _, _, b_info, buf = self._replay_phase(
                'adversary_agent',
                self.plr_buffer if shared else self.plr_antagonist,
                inj.get('antagonist_replay_seeds'),
                inj.get('antagonist_replay_reset_seeds'),
                inj.get('antagonist_sample_fn'), perms.get('adversary_agent'))
            if shared:
                self.plr_buffer = buf
            else:
                self.plr_antagonist = buf
        env_ret = self._env_return(
            a_info['rollout'],
            b_info['rollout'] if b_info is not None else a_info['rollout'])
        t_stats = None
        if self.is_training_env:
            t_stats = self._teacher_update(env_ret,
                                           perms.get('adversary_env'))
        stats, env_stats = self._device_stats(
            env_states if self.args.log_replay_complexity else None, a_info,
            b_info, t_stats, env_ret)
        easy = a_info['rollout']['mean_return'] - a_info['batched_value_loss']
        return (stats, env_stats), seeds, easy

    def _replay_phase(self, role, buf, seeds=None, reset_seeds=None,
                      sample_action_fn=None, perms=None):
        """One student's replay: N levels drawn from ``buf`` (``seeds``
        replaces the draw), mid-rollout resets drawn by its weights
        (``reset_seeds(t)``), scored into it; → (seeds, env states, info,
        the buffer)."""
        N = self.args.num_processes
        seeds, levels, buf = plr_lib.sample_replay_levels(
            buf, self.plr_cfg, N, self.generators[role], seeds)
        env_states, _ = self.env.reset_to_level(levels)
        weights = plr_lib.sample_weights(buf, self.plr_cfg)
        reset_fn = self._replay_reset_fn(buf.levels, weights, reset_seeds,
                                         role)
        info = self._student_phase(
            role, env_states, seeds, make_student_rollout(
                self.env, self.models[role], self._student_ro_cfg,
                reset_fn=reset_fn, sample_action_fn=sample_action_fn),
            perms, plr=buf)
        return seeds, env_states, info, info['plr']

    def _cycle_edit(self, parents, inj: dict):
        """ACCEL (:754-796): the parents' levels mutated, evaluated without
        a gradient step, staged and promoted with one edit more."""
        N = self.args.num_processes
        buf = self.plr_buffer
        parents = parents.long()
        parent_edits = buf.num_edits[parents]
        env_states, _ = self.env.reset_to_level(buf.levels[parents])
        env_states, _ = self.env.mutate_level(
            env_states, self.args.num_edits, self.generators['agent'],
            inj.get('mutation_draws'))
        seeds = (torch.arange(N, dtype=torch.int32, device=self.device)
                 + self.plr_cfg.capacity)
        a_info = self._student_phase(
            'agent', env_states, seeds, make_student_rollout(
                self.env, self.models['agent'], self._student_ro_cfg,
                sample_action_fn=inj.get('edit_sample_fn')),
            (inj.get('perms') or {}).get('agent_edit'), discard_grad=True,
            plr=buf)
        self.plr_buffer = plr_lib.promote_staged(
            a_info['plr'], self.plr_cfg, self.env.get_level(env_states),
            *a_info['staged'], staged_solvable=self.env.solvable(env_states),
            staged_num_edits=parent_edits + 1)

    def _coin(self, value) -> torch.Tensor:
        if value is not None:
            return torch.as_tensor(value, dtype=torch.float32)
        return torch.rand((), generator=self.generators['agent'],
                          device=self.device)

    # ------------------------------------------------------------------
    def run(self, **inj) -> Dict[str, float]:
        """One cycle; returns the host-side stats dict.

        The keyword arguments replace the cycle's random draws (the parity
        tests inject them): ``levels`` (N, W, H, 3) for DR's levels,
        ``sample_action_fn(logits, t)`` / ``antagonist_sample_fn`` /
        ``teacher_sample_fn`` / ``edit_sample_fn`` for the actions of the
        student, the antagonist, the teacher and the edit cycle's student,
        ``reset_fn(t, state, seeds)`` for DR's auto-reset levels,
        ``reset_draws`` and ``teacher_draws_fn(t)`` for the draws of the
        teacher's ``reset`` and moves, ``design`` (``actions_fn``,
        ``draws_fn``, ``reset_draws``) for the random teacher of DR with
        PLR, ``replay`` (bool) for the replay decision, ``replay_seeds``
        (N,) for the replay cycle's levels, ``replay_reset_seeds(t)`` (N,)
        for its mid-rollout draws, ``edit_coin`` (a uniform) for the edit
        decision, ``mutation_draws`` (N, 2 num_edits + 2) for the edits,
        and ``perms`` (role → (epochs, N); ``'agent_edit'`` for the edit
        cycle) for the minibatch permutations.  Every other draw comes
        from the runner's generators.
        """
        unknown = set(inj) - set(_INJECTED)
        if unknown:
            raise TypeError(f'run() got unknown draws {sorted(unknown)}')
        args = self.args
        N = args.num_processes
        level_replay = False
        if self.use_plr:
            replay = inj.get('replay')
            if replay is None:
                replay = plr_lib.sample_replay_decision(
                    self.plr_buffer, self.plr_cfg, self._coin(None))
            level_replay = bool(replay)
        if not (self.use_plr and not level_replay and self.robust_plr):
            self.student_grad_updates += 1
        if level_replay:
            stats, seeds, easy = self._cycle_replay(inj)
        else:
            stats = self._cycle_generate(inj)
            self.total_seeds_collected += N
        if (self.use_editor and level_replay and float(
                self._coin(inj.get('edit_coin'))) < args.level_editor_prob):
            if args.base_levels == 'easy' and N >= 4:
                order = torch.argsort(easy, stable=True)[:4]
                parents = seeds[order].repeat(N // 4)
            else:
                parents = seeds
            self._cycle_edit(parents, inj)
            self.total_num_edits += 1
        self.num_updates += 1
        return self._host_assemble(*stats, level_replay)

    def _host_assemble(self, stats, env_stats,
                       level_replay: bool = False) -> Dict[str, float]:
        """Per-cycle stats on the host, with the run's counters
        (:986-1064): fresh env stats on generate cycles (and, with
        ``--log_replay_complexity``, 'plr_'-prefixed on replay cycles),
        else the latest ones again under PLR."""
        env_stats = env_stats or {}
        # device scalars in one read; an env's host-side stats (CarRacing's
        # track complexity) arrive as floats
        on_host = {k: v for k, v in env_stats.items()
                   if not torch.is_tensor(v)}
        keys = list(stats) + [f'_env_{k}' for k in env_stats
                              if k not in on_host]
        vals = torch.stack([v.float() for v in (
            *stats.values(), *(v for k, v in env_stats.items()
                               if k not in on_host))]).tolist()
        host = dict(zip(keys, vals))
        fresh = {k[len('_env_'):]: host.pop(k) for k in keys
                 if k.startswith('_env_')}
        fresh.update(on_host)
        if fresh:
            prefix = 'plr_' if level_replay else ''
            fresh = {prefix + k: v for k, v in fresh.items()}
            host.update(fresh)
            if self.use_plr:
                self.latest_env_stats.update(fresh)
        elif self.latest_env_stats:
            host.update(self.latest_env_stats)
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
            # ACCEL's edit rollouts count as N * T env steps (PARITY.md #9)
            'steps': ((self.num_updates + self.total_num_edits)
                      * self.args.num_processes * self.args.num_steps),
            'total_episodes': self.total_episodes_collected,
            'total_seeds': self.total_seeds_collected,
            'total_student_grad_updates': self.student_grad_updates,
            'level_replay': int(level_replay),
            'total_num_edits': self.total_num_edits,
        })
        return host
