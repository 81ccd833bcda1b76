#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:
  1. device: the card's name and ``nvidia-smi`` name and power limit;
  2. build: one ``nvcc`` per source, all started together, and one link
     (kernels/_build.py);
  3. kernels: each kernel against its plain PyTorch twin on the card:
     ``multigrid_step`` / ``multigrid_obs`` bit-exact over 300 steps with
     resets on random DR levels at N = 32 and N = 4096, ``gae`` within
     atol = rtol = 1e-5 at T = 256, N in {32, 4096}, with
     ``handle_timelimits`` on and off; the teacher's construction step
     (``multigrid_adversary.step``) bit-exact on every output of every
     move of whole random constructions at N = 32 and 4096 for four env
     variants (goal last with 25 blocks, goal first with 50, variable
     blocks, noisy goal), and its BFS alone (``shortest_path``) on 4096
     random levels; the LSTM recurrence of BPTT (``lstm_seq``) forward
     and backward at T = 256, N = 32, 8192 and 1000 and T = 52, N = 1024
     (outputs within 1e-5, gradients within atol = rtol = 1e-4, two runs
     bit-identical, the launch plans); the PPO loss
     (``ppo_loss``) at the students' and the teacher's widths, its means
     within 1e-6 relative of the float64 twin, its gradients within 1e-5 of
     the twin's largest entry plus 1e-5 relative, both bit-identical over
     two runs, with the advantage normalisation;
     the teacher's fused projection (``teacher_proj``) and
     its gradients within rtol = atol = 1e-4 at B = 32 and 27 * 32; the PLR
     buffer's kernels (``plr``: the score fold for every kernel strategy,
     the sample weights, the promotion into empty, part-filled and full
     buffers) at S = 4000, T = 256, N = 32, each bit-identical over two
     runs and within 1e-6 of its twin, and the level edits
     (``multigrid_edit``: ``mutate`` for each editor action set and
     ``reset_random``) bit-exact; the student's fused policy step
     (``policy_step``, B2) in its four modes at B = 32 and 8192 (logits,
     value, carry, log-probs within 1e-5 relative, the sampled actions
     equal away from a CDF entry, the rows near one counted); B4's
     backward kernels (``teacher_proj_backward``: dW, the conv gradients,
     g_e) at (B, N) = (864, 1024), (864, 64), (1664, 1024) within 1e-5 of
     the twin's largest entry plus 1e-5 relative, identical over two runs;
     one small DR, PAIRED, ACCEL (generate, replay, edit), REPAIRED
     (generate, replay, generate; both buffers) and minimax sequence on
     the card against the same on the CPU (plain twins) with their random
     draws injected; one whole PAIRED cycle of bench.py's workload (N =
     8192, T = 256; B2 in the rollouts, B4's backward kernels in the
     teacher update) with its phase split, launch counts and peak device
     memory, which must stay under half the card; the walker's kernels against
     their twins (``walker_vs_plain``: B11's terrain and placement bit for
     bit on 1024 levels each of the full, easy and POET ranges and five
     terrain kinds, B10 one step at a time from 120 states of 64 walkers
     within 1e-4, B7's Gaussian branch at R = 1024 and 32 768, B8's
     promotion of float levels with duplicates exact) and a small walker
     ACCEL sequence on the card against the CPU (``walker_vs_cpu``);
     CarRacing's kernels against their twins (``carracing_vs_plain``:
     B13b's track build bit for bit on 4096 levels with n in [3, 12] and
     the start angle set and unset, B12's frames bit for bit for 64 cars
     on each of 8 tracks at t = 0, 0.5, 2 with and without the stack
     shift and in the crop + grayscale variant, B13a one control step at a
     time over 125 steps of 64 cars within 1e-6 (and 40 steps of the
     sparse-reward and clip branches), failing unless wheels were on the
     grass, tiles visited and episodes ended, B7's Beta branch at R = 500
     and 2000 with actions at the clip edges, and GAE, B8's fold, weights
     and float promotion and the normalisation at CarRacing's shapes) and
     a small CarRacing DR and PLR⊥ sequence on the card against the CPU
     (``carracing_vs_cpu``); then each kernel's time at the main path's
     shapes beside its plain twin's and its bound;
  4. slices, each with every kernel's launch count read around it: two
     domain-randomization training cycles through the training entry
     point at the settings of
     train_scripts/grid_configs/minigrid/25_blocks/mg_25b_dr.json without
     PLR; PLR⊥ (mg_25b_robust_plr.json) and ACCEL
     (60_blocks_uniform/mg_60b_uni_accel_empty.json) at full width (N = 32,
     T = 256, LSTM-256, a buffer of 4000 levels filled to rho through
     promote_staged), each a generate and a replay cycle (ACCEL's with its
     edit cycle) and one cycle by the runner's own coin; two PAIRED cycles
     at the settings of mg_25b_paired.json (N = 32, T = 256, LSTM-256 for
     both students and the teacher, 5 PPO epochs, fp32), and one PAIRED
     cycle on bench.py's MultiGrid-Adversarial-v0; REPAIRED
     (mg_25b_repaired.json: both buffers of 4000 filled to rho through
     promote_staged, a generate and a replay cycle, the replay's teacher
     update on the stored rollout, and a coin cycle) and two minimax
     cycles (mg_25b_minimax.json) through the training entry point, the
     teacher without a core (B4 at N = 64);
     ``walker_cycles``: bipedal_accel.json at full width (N = 16,
     T = 2048, the MLP student, 5 epochs of 32 minibatches, VecNormalize,
     S = 1000 filled to rho through promote_staged) for a generate and a
     replay + edit cycle and one bipedal_robust_plr.json replay cycle, each
     with its seconds, launches, host syncs and peak memory; three cycles
     of bipedal_accel.json and one of bipedal_robust_plr.json,
     bipedal_dr.json and bipedal_accel_poet.json through the training
     entry point;
     ``carracing_cycles``: train_scripts/grid_configs/car_racing/
     cr_dr.json at full width (N = 16, T = 125, 96 x 96 x 12 frames, the
     CNN student with its Beta policy, 8 epochs of 4 minibatches,
     VecNormalize) for one cycle, and cr_robust_plr.json (S = 8000 filled
     to rho through promote_staged) for a generate and a replay cycle,
     each with its seconds, launches, host syncs and peak memory; then
     one cycle each of cr_dr.json, cr_plr.json and cr_robust_plr.json
     through the training entry point;
  5. the ``kernels`` JSON line, then the result line.

It exits non-zero, printing no result, if there is no CUDA card or any
check fails.  The port imports torch only; nothing here imports JAX.
"""

import json
import math
import statistics
import subprocess
import sys
import time

ENV_NAME = 'MultiGrid-GoalLastFewerBlocksAdversarial-v0'
# mg_25b_dr.json without PLR; two cycles of N * T = 32 * 256 steps.
SLICE_ARGS = [
    '--env_name', ENV_NAME, '--ued_algo', 'domain_randomization',
    '--use_plr', 'false', '--num_processes', '32', '--num_steps', '256',
    '--ppo_epoch', '5', '--num_mini_batch', '1', '--handle_timelimits', 'true',
    '--lr', '1e-4', '--gamma', '0.995', '--entropy_coef', '0.01',
    '--recurrent_arch', 'lstm', '--recurrent_agent', 'true',
    '--recurrent_hidden_size', '256', '--num_env_steps', str(2 * 32 * 256),
    '--seed', '1',
]
# mg_25b_paired.json; two cycles.
PAIRED_ARGS = [
    '--env_name', ENV_NAME, '--ued_algo', 'paired', '--use_plr', 'false',
    '--num_processes', '32', '--num_steps', '256', '--ppo_epoch', '5',
    '--num_mini_batch', '1', '--handle_timelimits', 'true', '--lr', '1e-4',
    '--gamma', '0.995', '--entropy_coef', '0.0', '--adv_entropy_coef', '0.0',
    '--recurrent_arch', 'lstm', '--recurrent_agent', 'true',
    '--recurrent_adversary_env', 'true', '--recurrent_hidden_size', '256',
    '--num_env_steps', str(2 * 32 * 256), '--seed', '1',
]
# bench.py's env: 50 blocks, goal first; one cycle.
BENCH_ENV_ARGS = PAIRED_ARGS + [
    '--env_name', 'MultiGrid-Adversarial-v0', '--num_env_steps',
    str(32 * 256)]
# bench.py's workload (bench.py:47-69): one PAIRED cycle at N = 8192.
BENCH_SIZE_N = 8192
BENCH_SIZE_ARGS = [
    '--env_name', 'MultiGrid-Adversarial-v0', '--ued_algo', 'paired',
    '--num_processes', str(BENCH_SIZE_N), '--num_steps', '256',
    '--ppo_epoch', '5', '--num_mini_batch', '1',
    '--recurrent_adversary_env', 'true', '--seed', '1',
]
ADVERSARY_ENVS = ('MultiGrid-GoalLastFewerBlocksAdversarial-v0',
                  'MultiGrid-Adversarial-v0',
                  'MultiGrid-GoalLastVariableBlocksAdversarialEnv-v0',
                  'MultiGrid-NoisyAdversarial-v0')
MAIN_N, MAIN_T = 32, 256
# mg_25b_robust_plr.json and mg_60b_uni_accel_empty.json without
# --log_action_complexity, --checkpoint and --archive_interval (the
# entry-points slice); the cycles are driven one by one.
PLR_COMMON = [
    '--ued_algo', 'domain_randomization', '--num_processes', '32',
    '--num_steps', '256', '--ppo_epoch', '5', '--num_mini_batch', '1',
    '--handle_timelimits', 'true', '--lr', '1e-4', '--gamma', '0.995',
    '--recurrent_arch', 'lstm', '--recurrent_agent', 'true',
    '--recurrent_adversary_env', 'false', '--recurrent_hidden_size', '256',
    '--use_plr', 'true', '--level_replay_rho', '0.5',
    '--level_replay_seed_buffer_size', '4000',
    '--level_replay_score_transform', 'rank',
    '--no_exploratory_grad_updates', 'true', '--log_plr_buffer_stats', 'true',
    '--log_replay_complexity', 'true', '--reject_unsolvable_seeds', 'false',
    '--seed', '1']
ROBUST_PLR_ARGS = PLR_COMMON + [
    '--env_name', ENV_NAME, '--entropy_coef', '0.01',
    '--level_replay_prob', '0.5', '--level_replay_temperature', '0.1',
    '--level_replay_strategy', 'grounded_signed_value_loss',
    '--staleness_coef', '0.3']
ACCEL_ARGS = PLR_COMMON + [
    '--env_name', 'MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0',
    '--entropy_coef', '0.0', '--adv_entropy_coef', '0.0',
    '--level_replay_prob', '0.8', '--level_replay_temperature', '0.3',
    '--level_replay_strategy', 'positive_value_loss', '--use_editor', 'true',
    '--level_editor_prob', '1.0', '--level_editor_method', 'random',
    '--num_edits', '5', '--base_levels', 'easy']
PLR_S = 4000
# mg_25b_repaired.json (PAIRED with PLR⊥ on both students, a teacher
# without a core) and mg_25b_minimax.json without the A.4 flags.
TEACHER_COMMON = [
    '--env_name', ENV_NAME, '--num_processes', '32', '--num_steps', '256',
    '--ppo_epoch', '5', '--num_mini_batch', '1', '--handle_timelimits', 'true',
    '--lr', '1e-4', '--gamma', '0.995', '--adv_entropy_coef', '0.0',
    '--recurrent_arch', 'lstm', '--recurrent_agent', 'true',
    '--recurrent_adversary_env', 'false', '--recurrent_hidden_size', '256',
    '--log_plr_buffer_stats', 'true', '--log_replay_complexity', 'true',
    '--reject_unsolvable_seeds', 'false', '--seed', '1']
REPAIRED_ARGS = TEACHER_COMMON + [
    '--ued_algo', 'paired', '--entropy_coef', '0.0', '--use_plr', 'true',
    '--level_replay_prob', '0.95', '--level_replay_rho', '0.5',
    '--level_replay_seed_buffer_size', str(PLR_S),
    '--level_replay_temperature', '0.1',
    '--level_replay_strategy', 'grounded_signed_value_loss',
    '--level_replay_score_transform', 'rank', '--staleness_coef', '0.3',
    '--no_exploratory_grad_updates', 'true']
MINIMAX_ARGS = TEACHER_COMMON + [
    '--ued_algo', 'minimax', '--entropy_coef', '0.01',
    '--num_env_steps', str(2 * 32 * 256)]
EDIT_ENVS = ('MultiGrid-GoalLastFewerBlocksAdversarial-EditWN-v0',
             'MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0',
             'MultiGrid-GoalLastFewerBlocksAdversarial-v0',
             'MultiGrid-GoalLastVariableBlocksAdversarialEnv-v0')


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12          # outside the tensor cores (the same data sheet)
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores (the same)


def log(phase, t0, **kw):
    print(json.dumps({'phase': phase, 'seconds': time.perf_counter() - t0,
                      **kw}), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_ms(fn, inner: int, samples: int = 25) -> float:
    """Median device time of one call of ``fn``, from CUDA events around
    ``inner`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int, samples: int = 25) -> float:
    """Median device time of one kernel launch made by ``fn``: ``inner``
    launches captured in a CUDA graph and replayed, so the host's cost of
    the Python wrapper is not in the time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return device_ms(graph.replay, 1, samples) / inner


def max_abs_diff(a, b) -> float:
    """Largest |a - b| of two tensors compared for equality (bools and
    integers as int64, floats as float64)."""
    import torch
    if a.dtype == torch.bool:
        a, b = a.long(), b.long()
    wide = torch.float64 if a.is_floating_point() else torch.int64
    return float((a.to(wide) - b.to(wide)).abs().max()) if a.numel() else 0.0


def random_actions(n, generator, device):
    """Actions 0..6 with FORWARD (2) four times in ten, so goals are hit."""
    import torch
    a = torch.randint(0, 10, (n,), generator=generator, device=device)
    return torch.where(a >= 7, torch.full_like(a, 2), a).int()


def check_multigrid(n: int, steps: int, device, seed: int = 0) -> dict:
    """Kernel 1 (step and view gather) against its plain twin, exact."""
    import torch
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels.multigrid_step import (
        multigrid_obs, multigrid_step, obs_plain, step_plain,
    )
    env = make_env(ENV_NAME)
    p = env.params
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    start, obs = env.reset_random(n, gen, device)
    state = start
    n_done = n_goal = 0
    err = 0.0
    for t in range(steps):
        image = multigrid_obs(state.grid, state.agent_pos, state.agent_dir,
                              p.agent_view_size)
        want = obs_plain(state.grid, state.agent_pos, state.agent_dir,
                         p.agent_view_size)
        err = max(err, max_abs_diff(image, want))
        if not torch.equal(image, want):
            raise AssertionError(f'multigrid_obs != obs_plain at step {t}')
        args = (state.grid, state.agent_pos, state.agent_dir,
                state.step_count, state.agent_done,
                random_actions(n, gen, device), p.agent_view_size,
                p.max_steps)
        got = multigrid_step(*args)
        want = step_plain(*args)
        for k, (a, b) in enumerate(zip(got, want)):
            err = max(err, max_abs_diff(a, b))
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                raise AssertionError(
                    f'multigrid_step output {k} != step_plain at step {t}')
        pos, d, sc, agent_done, _, reward, done, _ = got
        state = state.replace(agent_pos=pos, agent_dir=d, step_count=sc,
                              agent_done=agent_done)
        n_done += int(done.sum())
        n_goal += int((reward > 0).sum())
        state = start.where(done, state)   # same-level reset
    if n_done == 0 or n_goal == 0:
        raise AssertionError(f'N={n}: no episode ended ({n_done}) or no goal '
                             f'reached ({n_goal}) in {steps} steps')
    return {'n': n, 'steps': steps, 'episodes_ended': n_done,
            'goals': n_goal, 'max_abs_err': err}


def gae_inputs(T, N, device, seed=0, dense=False):
    """GAE's inputs: sparse rewards (MultiGrid's) or, with ``dense``, a
    reward every step of the size VecNormalize scales them to (the
    walker's)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    rewards = rn(T, N) * 0.3 if dense else r(T, N) * (r(T, N) < 0.1)
    return dict(rewards=rewards, values=rn(T, N),
                dones=r(T, N) < 0.05, bad_masks=(r(T, N) < 0.5).float(),
                trunc_values=rn(T, N), next_value=rn(N))


def check_gae(T, N, proper, device, gamma=0.995, gae_lambda=0.95,
              dense=False) -> dict:
    import torch
    from dcd_isaac_tpu_torch.kernels.gae import gae, gae_plain
    x = gae_inputs(T, N, device, dense=dense)
    got = gae(**x, gamma=gamma, gae_lambda=gae_lambda,
              use_proper_time_limits=proper)
    want = gae_plain(**x, gamma=gamma, gae_lambda=gae_lambda,
                     use_proper_time_limits=proper)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = float((got - want).abs().max())
    return {'T': T, 'N': N, 'proper': proper, 'gamma': gamma,
            'gae_lambda': gae_lambda, 'dense': dense, 'max_abs_err': err}


def weights(models: dict) -> dict:
    """role -> {name: a CPU copy of the tensor}."""
    return {r: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
            for r, m in models.items()}


def compare_weight_changes(before, cpu_after, card_after,
                           tol: float = 1e-5) -> dict:
    """Per role, how far the card's weight change (after minus before) is
    from the CPU's, and the CPU's largest change.  Raises unless the first
    is within ``tol`` and the second beyond it, so an update that moved
    nothing cannot pass.  Both sides start from the same weights."""
    res = {}
    for r, start in before.items():
        err = moved = 0.0
        for k, b in start.items():
            cpu_d, card_d = cpu_after[r][k] - b, card_after[r][k] - b
            err = max(err, float((card_d - cpu_d).abs().max()))
            moved = max(moved, float(cpu_d.abs().max()))
        res[r] = {'max_abs_err_weight_change': err,
                  'max_weight_change': moved}
        if err > tol or moved <= tol:
            raise AssertionError(f'card cycle != CPU cycle ({r}): weight '
                                 f'changes differ by {err}, largest change '
                                 f'{moved}, tolerance {tol}')
    return res


def check_cycle_against_cpu(device) -> dict:
    """One DR cycle (N = 8, T = 16, LSTM-32, episodes capped at 6 steps so
    time-limit resets happen) on the card and on the CPU, from the same
    initial weights, levels, actions, reset levels and permutations.  The
    CPU path runs the plain twins and is the one the CPU tests hold
    against the JAX package.  Each side's weight change (after minus
    before) must agree within 1e-5, and the largest change must exceed
    that tolerance, so an update that moved nothing cannot pass."""
    import numpy as np
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
        AdversarialMultiGrid,
    )
    from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    n, t = 8, 16
    args = parser.parse_args(SLICE_ARGS + [
        '--num_processes', str(n), '--num_steps', str(t),
        '--recurrent_hidden_size', '32'])
    env = AdversarialMultiGrid(MultiGridParams(
        size=15, n_clutter=25, choose_goal_last=True, max_steps=6))
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset_random(n * (t + 1), gen, 'cpu')
    levels = env.get_level(st)
    actions = torch.as_tensor(np.random.default_rng(0).integers(0, 3, (t, n)))
    perms = torch.stack([torch.randperm(n, generator=gen)
                         for _ in range(args.ppo_epoch)])
    out = []
    for dev in ('cpu', device):
        net = make_model(args, env, generator=torch.Generator().manual_seed(1))
        before = weights({'agent': net})
        runner = AdversarialRunner(args, env, {'agent': net.to(dev)}, dev)
        sample = lambda logits, k: actions[k].to(dev)

        def reset(k, state, seeds):
            state, obs = env.reset_to_level(
                levels[n * (k + 1):n * (k + 2)].to(dev))
            return state, obs, seeds
        stats = runner.run(levels=levels[:n].to(dev), sample_action_fn=sample,
                           reset_fn=reset, perms={"agent": perms.to(dev)})
        out.append((stats, weights({'agent': net})))
    (cpu_stats, cpu_after), (card_stats, card_after) = out
    res = compare_weight_changes(before, cpu_after, card_after)['agent']
    if card_stats['episodes'] != cpu_stats['episodes']:
        raise AssertionError(f'card cycle != CPU cycle: episodes '
                             f'{card_stats["episodes"]} vs '
                             f'{cpu_stats["episodes"]}')
    return {**res, 'episodes': card_stats['episodes'],
            'value_loss': [cpu_stats['agent_value_loss'],
                           card_stats['agent_value_loss']]}


def check_adversary(env_name: str, n: int, device, seed: int = 0) -> dict:
    """Kernel B5's construction step against its plain twin: whole
    constructions from uniform random moves and draws, every output of
    every move compared bit for bit.  Counts the levels whose agent move
    landed on the goal (the random fallback), whose goal move was noisy,
    and which came out unsolvable."""
    import torch
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    env = make_env(env_name)
    p = env.params
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state, _ = env.reset(n, gen, device)
    fallback = noisy = 0
    err = 0.0
    for t in range(p.adversary_max_steps):
        loc = torch.randint(0, p.adversary_action_dim, (n,), generator=gen,
                            device=device, dtype=torch.int32)
        u = torch.rand((n, 3), generator=gen, device=device)
        got = ma.step(state, loc, u, p)
        want = ma.step_plain(state, loc, u, p)
        for k, b in want.items():
            err = max(err, max_abs_diff(got[k], b))
            if not torch.equal(got[k], b):
                raise AssertionError(
                    f'{env_name} N={n}: multigrid_adversary.step output '
                    f'{k} != step_plain at move {t}')
        xy = torch.stack([loc % (p.width - 2) + 1, loc // (p.width - 2) + 1],
                         1)
        placed = lambda key: ((getattr(state, key)[:, 0] < 0)
                              & (got[key][:, 0] >= 0)
                              & (got[key] != xy).any(1))
        fallback += int(placed('agent_start_pos').sum())
        noisy += int(placed('goal_pos').sum())
        state = state.replace(**{k: got[k] for k in ma.STATE_OUT})
    if not bool(got['done'].all()):
        raise AssertionError(f'{env_name}: construction did not end')
    return {'env': env_name, 'n': n, 'moves': p.adversary_max_steps,
            'agent_on_goal_fallbacks': fallback, 'noisy_goals': noisy,
            'unsolvable': int((~state.passable).sum()),
            'mean_blocks': float(state.n_clutter_placed.float().mean()),
            'max_abs_err': err}


def random_levels(n, device, seed=0):
    """n random 15x15 grids (35 % walls inside the border), with random
    start and goal cells and every ninth start unplaced."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    grid = torch.where(torch.rand((n, 15, 15), generator=g, device=device)
                       < 0.35, 2, 1).to(torch.uint8)
    grid[:, 0] = grid[:, -1] = grid[:, :, 0] = grid[:, :, -1] = 2
    cell = lambda: torch.randint(1, 14, (n, 2), generator=g, device=device,
                                 dtype=torch.int32)
    start, goal = cell(), cell()
    start[::9] = -1
    return grid, start, goal


def check_shortest_path(n: int, device) -> dict:
    """Kernel B5's BFS alone against its plain twin, exact."""
    import torch
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    grid, start, goal = random_levels(n, device)
    got = ma.shortest_path(grid, start, goal, 170)
    want = ma.shortest_path_plain(grid, start, goal, 170)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError('shortest_path != shortest_path_plain')
    return {'n': n, 'passable': int(got[0].sum()),
            'unsolvable': int((~got[0]).sum()),
            'max_abs_err': max(max_abs_diff(a, b) for a, b in zip(got, want))}


def teacher_inputs(batch: int, device, seed: int = 0):
    """The teacher's projection inputs at the main path's widths: the
    weights of a freshly built mg_25b_paired teacher, random adversary
    images, time steps and random_z (e = scalar embed || random_z)."""
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    env = make_env(ENV_NAME)
    teacher = make_model(parser.parse_args(PAIRED_ARGS), env, 'adversary_env',
                         torch.Generator().manual_seed(seed)).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    obs = {'image': torch.randint(0, 11, (batch, 15, 15, 3), generator=g,
                                  device=device, dtype=torch.uint8),
           'time_step': torch.randint(0, 28, (batch,), generator=g,
                                      device=device),
           'random_z': torch.rand((batch, 50), generator=g, device=device)}
    with torch.no_grad():
        e = teacher._scalar_and_z(obs)
    return (obs['image'], teacher.image_conv.weight.detach(),
            teacher.image_conv.bias.detach(), e.contiguous(),
            teacher.core.w_i.weight.detach())


def fmaf(a, b, c):
    """CUDA's ``fmaf(a, b, c)`` of float32 tensors: a * b + c rounded once
    to float32.  The product is exact in double; the sum ``s`` rounds
    there, and where ``s`` falls halfway between two floats its rounding
    error (TwoSum) says which way the exact sum lies."""
    import torch
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    z = s - p
    err = (p - (s - z)) + (cd - z)
    r = s.float()
    d = s - r.double()
    away = torch.nextafter(r, torch.where(d > 0, math.inf, -math.inf)
                           .to(r.dtype))
    tie = (d != 0) & (away.double() - s == d)
    return torch.where(tie & (err * d > 0), away, r)


# The forward error bound of the kernel's 28-term fmaf chain (bias, then
# 27 products), relative to |b| + sum |w| |x|: gamma_27 = 27 u / (1 - 27 u).
CONV_PRE_GAMMA = 27 * 2.0 ** -24 / (1 - 27 * 2.0 ** -24)
# Pre-activations within this share of their scale get the kernel's
# order emulated exactly; beyond it the kernel's sign is the exact one.
CONV_PRE_NEAR = 1e-5


def kernel_conv_grads(img, conv_w, conv_b, e, w_i, grad, exact=False):
    """The conv weight and bias gradients of the projection with ReLU'
    taken as the kernels take it: from the pre-activation summed in their
    order (``csrc/teacher_proj.cu`` ``conv_pre``: the bias, then fmaf over
    q = (ci, di, dj) of w and byte / 10 rounded once).  Elsewhere it is
    the plain computation (dA = g W_i by matmul, the weight gradient by
    ``conv2d_weight``), in the twin's row chunks; in float64 if ``exact``
    (the gradients returned as float64).

    The pre-activation is computed in double (exact but for 28 ulps of
    double); where it lies within ``CONV_PRE_NEAR`` of its scale the
    kernel's fp32 chain is replayed by :func:`fmaf`, and beyond it the
    kernel's sign is the exact one (its error is at most
    ``CONV_PRE_GAMMA`` of the scale).  Returns the two gradients and a
    witness: the entries replayed, those whose kernel sign differs from
    the exact one (each within ``CONV_PRE_GAMMA`` of the scale, checked)
    and those whose mask differs from the twin's cuDNN pre-activation
    (``relu(conv)`` > 0, the twin's ReLU'), with the largest |pre| /
    scale among them and the first few entries."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    C = conv_w.shape[0]
    ox, oy = img.shape[1] - 2, img.shape[2] - 2
    kc = ox * oy * C
    lut = torch.from_numpy(np.arange(256, dtype=np.float32)
                           / np.float32(10.0)).to(img.device)
    rows = max(1, int(tp.CHUNK_BYTES // (4 * w_i.shape[1])))
    wide = torch.float64 if exact else torch.float32
    g_w = torch.zeros(conv_w.shape, dtype=wide, device=conv_w.device)
    g_b = torch.zeros(conv_b.shape, dtype=wide, device=conv_b.device)
    wit = {'replayed': 0, 'kernel_vs_exact': 0, 'kernel_vs_twin': 0,
           'max_flip_pre_over_scale': 0.0,
           'rounding_bound_over_scale': CONV_PRE_GAMMA, 'flips': []}
    for r in range(0, img.shape[0], rows):
        x = lut[img[r:r + rows].long()].permute(0, 3, 1, 2)
        with torch.no_grad():
            pre = F.conv2d(x.double(), conv_w.double(), conv_b.double())
            scale = F.conv2d(x, conv_w.abs(), conv_b.abs())
            mask = pre > 0
            near = (pre.abs() <= CONV_PRE_NEAR * scale).nonzero()
            b, c, i, j = near.unbind(1)
            v = conv_b[c]
            for q in range(27):
                ci, di, dj = q // 9, (q // 3) % 3, q % 3
                v = fmaf(conv_w[c, ci, di, dj], x[b, ci, i + di, j + dj], v)
            at = (b, c, i, j)
            off = (v > 0) != mask[at]
            if (pre[at][off].abs() > CONV_PRE_GAMMA * scale[at][off]).any():
                raise AssertionError('kernel_conv_grads: the replayed fp32 '
                                     'chain is off its error bound')
            mask[at] = v > 0
            wit['replayed'] += len(v)
            wit['kernel_vs_exact'] += int(off.sum())
            twin = tp.embed_plain(img[r:r + rows], conv_w, conv_b,
                                  e[r:r + rows])[:, :kc].view(
                -1, ox, oy, C).permute(0, 3, 1, 2) > 0
            flips = (twin != mask).nonzero()
            wit['kernel_vs_twin'] += len(flips)
            if len(flips):
                fb, fc, fi, fj = flips.unbind(1)
                ratio = (pre[fb, fc, fi, fj].abs()
                         / scale[fb, fc, fi, fj]).tolist()
                wit['max_flip_pre_over_scale'] = max(
                    wit['max_flip_pre_over_scale'], *ratio)
                for (fb_, fc_, fi_, fj_), ratio_ in zip(flips.tolist(),
                                                        ratio):
                    if len(wit['flips']) < 8:
                        wit['flips'].append({
                            'row': r + fb_, 'pixel': [fi_, fj_],
                            'channel': fc_, 'kernel_mask': bool(
                                mask[fb_, fc_, fi_, fj_]),
                            'pre_exact': float(pre[fb_, fc_, fi_, fj_]),
                            'pre_over_scale': ratio_})
            da = (grad[r:r + rows].to(wide) @ w_i[:, :kc].to(wide)).view(
                -1, ox, oy, C).permute(0, 3, 1, 2) * mask
            g_w += torch.nn.grad.conv2d_weight(x.to(wide), conv_w.shape, da)
            g_b += da.sum((0, 2, 3))
    return g_w, g_b, wit


def check_teacher_proj(batch: int, n_out: int, device) -> dict:
    """Kernel B4 and its autograd gradients against the plain twin within
    rtol = atol = 1e-4, for N = 1024 (the recurrent teacher's W_i) or 64
    (the teacher without a core): each output sums 21 692 fp32 products,
    in another order than cuBLAS and cuDNN sum them.  The conv gradients
    are held against the same computation in float64 with the kernels'
    ReLU' (``kernel_conv_grads``, ``exact``): a pre-activation within
    rounding of zero may take the other side in cuDNN's order, and the
    conv gradients' sums over 146 016 terms of each sign cancel so far
    that an fp32 reference is itself off by up to the tolerance.
    ``conv_twin_gap`` is the kernel's gap to the twin, ``conv_flips_part``
    what the flips alone move, ``conv_err_over_tol`` the largest error of
    the kernel's conv gradients and of the fp32 reference's, as a share of
    the tolerance."""
    import torch
    from dcd_isaac_tpu_torch.kernels.teacher_proj import (
        teacher_proj, teacher_proj_plain,
    )
    img, *weights = teacher_backward_inputs(batch, n_out, device)[:5]
    g = torch.Generator(device=device)
    g.manual_seed(1)
    g_out = torch.randn((batch, weights[-1].shape[0]), generator=g,
                        device=device)
    errs = {}
    for name, fn in (('kernel', teacher_proj), ('plain', teacher_proj_plain)):
        leaves = [w.clone().requires_grad_() for w in weights]
        out = fn(img, *leaves)
        grads = torch.autograd.grad(out, leaves, g_out)
        errs[name] = (out.detach(), grads)
    (out, grads), (want, want_grads) = errs['kernel'], errs['plain']
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    names = ('conv_w', 'conv_b', 'e', 'w_i')
    *exact, witness = kernel_conv_grads(img, *weights, g_out, exact=True)
    refs = (*exact, *want_grads[2:])
    for k, a, b in zip(names, grads, refs):
        torch.testing.assert_close(a.to(b.dtype), b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f'grad {k}: {m}')
    *fp32_ref, _ = kernel_conv_grads(img, *weights, g_out)
    over_tol = lambda a, x: float(((a.double() - x).abs()
                                   / (1e-4 + 1e-4 * x.abs())).max())
    return {'B': batch, 'N': n_out,
            'max_abs_err': float((out - want).abs().max()),
            'max_abs_out': float(want.abs().max()),
            'grad_max_abs_err': {k: float((a.to(b.dtype) - b).abs().max())
                                 for k, a, b in zip(names, grads, refs)},
            'grad_max_abs': {k: float(b.abs().max())
                             for k, b in zip(names, refs)},
            'conv_twin_gap': {k: float((a - b).abs().max()) for k, a, b
                              in zip(names[:2], grads, want_grads)},
            'conv_flips_part': {k: float((a - b).abs().max()) for k, a, b
                                in zip(names[:2], fp32_ref, want_grads)},
            'conv_err_over_tol': {
                who: {k: over_tol(a, x) for k, a, x in zip(names, got, exact)}
                for who, got in (('kernel', grads),
                                 ('fp32_reference', fp32_ref))},
            'relu_mask': witness}


def check_teacher_proj_forward(batch: int, device) -> dict:
    """Kernel B4's forward alone against the twin within rtol = atol =
    1e-4, at bench.py's shapes (a construction step's B = 8192 and the
    teacher update's 52 * 8192, where the forward needs no split-K and
    writes its tiles straight into zx); the twin runs in CHUNK_BYTES row
    chunks, as its (B, K) embed would not fit."""
    import torch
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    args = teacher_inputs(batch, device)
    rows = max(1, int(tp.CHUNK_BYTES // (4 * args[-1].shape[1])))
    with torch.no_grad():
        out = tp.teacher_proj(*args)
        want = in_row_chunks(tp.teacher_proj_plain, rows, *args)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    res = {'B': batch, 'N': args[-1].shape[0],
           'max_abs_err': float((out - want).abs().max()),
           'max_abs_out': float(want.abs().max())}
    del out, want, args
    torch.cuda.empty_cache()
    return res


def near_goal_moves(rng, n, interior=13, n_walls=25):
    """(27, n) goal-last teacher moves: 25 random walls, then a goal one or
    two cells from the agent's cell, so scripted students reach it."""
    import numpy as np
    moves = np.zeros((n_walls + 2, n), np.int64)
    loc = lambda x, y: (y - 1) * interior + (x - 1)
    for i in range(n):
        ax, ay = rng.integers(2, interior, 2)
        dx, dy = [(1, 0), (0, 1), (-1, 0), (0, -1), (2, 0), (1, 1)][
            rng.integers(6)]
        moves[:n_walls, i] = rng.integers(0, interior * interior, n_walls)
        moves[n_walls, i] = loc(ax + dx, ay + dy)
        moves[n_walls + 1, i] = loc(ax, ay)
    return moves


def check_paired_cycle_against_cpu(device) -> dict:
    """One PAIRED cycle (N = 8, T = 16, LSTM-32 for all three nets, 25
    blocks, episodes capped at 6 steps) on the card and on the CPU, from
    the same initial weights, teacher moves and draws, student actions and
    permutations.  Each model's weight change must agree within 1e-5
    between the two, and each model's largest change must exceed that."""
    import numpy as np
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
        AdversarialMultiGrid,
    )
    from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_all_models
    n, t = 8, 16
    args = parser.parse_args(PAIRED_ARGS + [
        '--num_processes', str(n), '--num_steps', str(t),
        '--recurrent_hidden_size', '32'])
    env = AdversarialMultiGrid(MultiGridParams(
        size=15, n_clutter=25, choose_goal_last=True, max_steps=6))
    rng = np.random.default_rng(0)
    T = env.adversary_rollout_steps
    f32 = lambda *s: torch.tensor(rng.random(s), dtype=torch.float32)
    moves = torch.tensor(near_goal_moves(rng, n))
    u, z = f32(T, n, 3), f32(T, n, 50)
    reset = {'start_dir': torch.tensor(rng.integers(0, 4, n)),
             'random_z': f32(n, 50)}
    acts = {r: torch.tensor(rng.integers(0, 3, (t, n)))
            for r in ('agent', 'adversary_agent')}
    gen = torch.Generator().manual_seed(0)
    perms = {r: torch.stack([torch.randperm(n, generator=gen)
                             for _ in range(5)])
             for r in ('agent', 'adversary_agent', 'adversary_env')}
    out = []
    for dev in ('cpu', device):
        models = {r: m.to(dev) for r, m in make_all_models(
            args, env, torch.Generator().manual_seed(1)).items()}
        before = weights(models)
        runner = AdversarialRunner(args, env, models, dev)
        script = lambda a: (lambda logits, k: a[k].to(dev))
        stats = runner.run(
            sample_action_fn=script(acts['agent']),
            antagonist_sample_fn=script(acts['adversary_agent']),
            teacher_sample_fn=script(moves),
            teacher_draws_fn=lambda k: {'u': u[k].to(dev),
                                        'random_z': z[k].to(dev)},
            reset_draws={k: v.to(dev) for k, v in reset.items()},
            perms={r: p.to(dev) for r, p in perms.items()})
        out.append((stats, weights(models)))
    (cpu_stats, cpu_after), (card_stats, card_after) = out
    res = compare_weight_changes(before, cpu_after, card_after)
    for k in ('episodes', 'num_blocks', 'passable_ratio'):
        if card_stats[k] != cpu_stats[k]:
            raise AssertionError(f'card PAIRED cycle != CPU cycle: {k} '
                                 f'{card_stats[k]} vs {cpu_stats[k]}')
    res['mean_env_return'] = [cpu_stats['mean_env_return'],
                              card_stats['mean_env_return']]
    res['episodes'] = card_stats['episodes']
    return res


def lstm_inputs(T, N, device, seed=0):
    """Kernel B3's inputs at LSTM-256: W_h of a freshly built core (the
    bias made random), random zx, carry and cotangents, and masks with
    resets for half the envs at t = 0 and about one step in twenty."""
    import torch
    from dcd_isaac_tpu_torch.models.common import RNNCore
    core = RNNCore(4, 256, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    masks = (torch.rand((T, N), generator=g, device=device) > 0.05).float()
    masks[0, ::2] = 0.0
    x = dict(zx=rn(T, N, 1024), masks=masks,
             w_h=core.w_h.weight.detach().to(device), b=rn(1024) * 0.1,
             c0=rn(N, 256), h0=rn(N, 256))
    return x, (rn(T, N, 256), rn(N, 256))


def check_lstm_seq(T, N, device) -> dict:
    """Kernel B3 forward and backward against the plain twins: outputs
    within 1e-5, gradients within atol + rtol * |ref| = 1e-4 + 1e-4 * |ref|
    (each z sums 256 products in another order than cuBLAS; dW_h sums T * N
    rows, in float64 on both sides); two runs bit-identical."""
    import torch
    from dcd_isaac_tpu_torch.kernels.lstm_seq import (
        lstm_seq, lstm_seq_plain_backward, lstm_seq_plain_forward, plan,
    )
    x, (g_h, g_c) = lstm_inputs(T, N, device)
    names = ('zx', 'w_h', 'b', 'c0', 'h0')
    for k in names:
        x[k].requires_grad_()
    runs = []
    for _ in range(2):
        h_all, (c_T, _) = lstm_seq(*x.values())
        grads = torch.autograd.grad((h_all, c_T), [x[k] for k in names],
                                    (g_h, g_c))
        runs.append((h_all.detach(), c_T.detach(), *grads))
        del h_all, c_T, grads
    identical = all(torch.equal(a, b) for a, b in zip(*runs))
    if not identical:
        raise AssertionError(f'lstm_seq ({T}, {N}): two runs differ')
    h_all, c_T, *grads = runs.pop()
    runs.clear()
    with torch.no_grad():
        x = {k: v.detach() for k, v in x.items()}
        want_h, want_c, (want_cT, _) = lstm_seq_plain_forward(**x)
        want_grads = lstm_seq_plain_backward(g_h, g_c, *x.values(), want_h,
                                             want_c)
    torch.testing.assert_close(h_all, want_h, atol=1e-5, rtol=0,
                               msg=lambda m: f'h_all ({T}, {N}): {m}')
    torch.testing.assert_close(c_T, want_cT, atol=1e-5, rtol=0,
                               msg=lambda m: f'c_T ({T}, {N}): {m}')
    for k, a, b in zip(names, grads, want_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f'grad {k} ({T}, {N}): {m}')
    return {'T': T, 'N': N, 'two_runs_identical': identical,
            'plan': plan(N, 256), 'plan_backward': plan(N, 256, True),
            'max_abs_err': max(float((h_all - want_h).abs().max()),
                               float((c_T - want_cT).abs().max())),
            'grad_max_abs_err': {k: float((a - b).abs().max()) for k, a, b
                                 in zip(names, grads, want_grads)},
            'grad_max_abs': {k: float(b.abs().max())
                             for k, b in zip(names, want_grads)}}


def ppo_inputs(R, device, A=7, seed=0):
    """Kernel B7's rows: random logits (R, A) and values; a quarter of the
    rows with the ratio exactly 1 and the values equal to the old values
    (the first minibatch's ties).  A = 7 for the students, 169 for the
    teacher's placements."""
    import torch
    from dcd_isaac_tpu_torch.models.distributions import categorical_log_prob
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    logits, values = rn(R, A), rn(R)
    actions = torch.randint(0, A, (R,), generator=g, device=device)
    tie = torch.rand((R,), generator=g, device=device) < 0.25
    old_lp = torch.where(tie, categorical_log_prob(logits, actions),
                         rn(R) * 0.3 - 2.0)
    old_v = torch.where(tie, values, values + rn(R) * 0.3)
    return (logits, values, actions, old_lp, old_v, values + rn(R), rn(R))


def check_ppo_loss(R, A, clip_value_loss, device) -> dict:
    """Kernel B7 against its twins: the four means within 1e-6 relative of
    the twin in float64; dlogits and dvalues within 1e-5 of the largest
    entry of the twin's backward plus 1e-5 relative (the loss is a mean, so
    every entry scales as 1/R: a fixed atol would pass a backward that
    writes zeros at the main path's R); both bit-identical over two runs;
    the advantage normalisation within 1e-6 of the twin in float64."""
    import torch
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        ppo_loss, ppo_loss_plain, ppo_loss_plain_backward,
    )
    rows = ppo_inputs(R, device, A)
    cfg = (0.2, clip_value_loss, 0.5, 0.01)
    upstream = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in rows[:2]]
        out = ppo_loss(*leaves, *rows[2:], *cfg)
        runs.append((torch.stack(out).detach(),
                     *torch.autograd.grad(out[0], leaves)))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    if not same:
        raise AssertionError(f'ppo_loss R={R}: two runs differ')
    wide = [t.double() if t.is_floating_point() else t for t in rows]
    want = torch.stack(ppo_loss_plain(*wide, *cfg))
    torch.testing.assert_close(runs[0][0].double(), want, rtol=1e-6,
                               atol=1e-9)
    want_grads = ppo_loss_plain_backward(upstream, *rows, *cfg)
    grads = {}
    for name, a, b in zip(('dlogits', 'dvalues'), runs[0][1:], want_grads):
        scale = float(b.abs().max())
        if not scale > 0:
            raise AssertionError(f'ppo_loss R={R}: {name} of the twin is 0')
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=1e-5,
                                   msg=lambda m: f'{name}: {m}')
        err = float((a - b).abs().max())
        grads[name] = {'max_abs_err': err, 'max_abs_ref': scale,
                       'max_err_over_ref': err / scale}
    norm = check_normalize(rows[5], rows[1])
    return {'R': R, 'A': A, 'clip_value_loss': clip_value_loss,
            'means': runs[0][0].tolist(),
            'max_rel_err_means': float(((runs[0][0].double() - want).abs()
                                        / want.abs()).max()),
            'max_abs_err': max(g['max_abs_err'] for g in grads.values()),
            'grads': grads,
            'normalize_max_abs_err': norm['max_abs_err'],
            'bit_identical_runs': same}


def check_normalize(returns, values) -> dict:
    """B7's advantage normalisation of returns - values (R,) against its
    twin in float64, within 1e-6."""
    import torch
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        normalize_advantages, normalize_advantages_plain,
    )
    adv = normalize_advantages(returns, values)
    want = normalize_advantages_plain(returns.double(), values.double())
    torch.testing.assert_close(adv.double(), want, atol=1e-6, rtol=1e-6)
    return {'R': returns.shape[0],
            'max_abs_err': float((adv.double() - want).abs().max())}


def check_paired_cycle_at_bench_size(device) -> dict:
    """One whole PAIRED cycle of bench.py's workload (N = 8192, T = 256,
    MultiGrid-Adversarial-v0, 5 epochs, 1 minibatch, recurrent teacher,
    no time-limit bootstrapping) through the runner's cycle, with a device
    sync around each phase: the teacher's build, each student's rollout
    (with its GAE) and update, the teacher's update.  Fails unless every
    stat is finite and the peak of allocated device memory stays under
    half the card."""
    import torch
    from dcd_isaac_tpu_torch.arguments import check_args, parser
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_all_models
    args = check_args(parser.parse_args(BENCH_SIZE_ARGS))
    env = make_env(args.env_name)
    models = {r: m.to(device) for r, m in make_all_models(
        args, env, torch.Generator().manual_seed(args.seed)).items()}
    runner = AdversarialRunner(args, env, models, device)
    seconds = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    runner._generate_levels = timed('teacher_build', runner._generate_levels)
    runner._teacher_update = timed('teacher_update', runner._teacher_update)
    for role in ('agent', 'adversary_agent'):
        runner.updates[role] = timed(f'{role}_update', runner.updates[role])
    phase = runner._student_phase

    def student_phase(role, *a, **k):
        return timed(f'{role}_phase', phase)(role, *a, **k)
    runner._student_phase = student_phase
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    stats = runner.run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for role in ('agent', 'adversary_agent'):
        seconds[f'{role}_rollout'] = (seconds.pop(f'{role}_phase')
                                      - seconds[f'{role}_update'])
    peak = torch.cuda.max_memory_allocated(device)
    card = torch.cuda.get_device_properties(device).total_memory
    bad = {k: v for k, v in stats.items() if not math.isfinite(float(v))}
    if bad or peak > card / 2:
        raise AssertionError(f'PAIRED cycle at N={args.num_processes}: '
                             f'non-finite {bad}, peak {peak / 2**30:.2f} GiB '
                             f'of {card / 2**30:.2f} GiB')
    return {'n': args.num_processes, 'T': args.num_steps,
            'seconds': seconds, 'total_seconds': total,
            'steps_per_second': args.num_processes * args.num_steps / total,
            'peak_allocated_gib': peak / 2**30,
            'card_gib': card / 2**30, 'stats': stats}


def view_cells_read(grid, agent_pos, agent_dir, v: int) -> int:
    """Grid cells the view gather must read for a batch: the in-bounds
    cells of each env's v x v view, less the agent's own cell, which is
    written EMPTY unread (out-of-bounds cells read as WALL unread)."""
    import torch
    from dcd_isaac_tpu_torch.kernels.multigrid_step import view_offset_table
    n, W, H = grid.shape
    table = torch.tensor(view_offset_table(v), device=grid.device)
    c = agent_pos[:, None, None, :] + table[agent_dir.long()]
    inb = (c[..., 0] >= 0) & (c[..., 0] < W) & (c[..., 1] >= 0) & (
        c[..., 1] < H)
    return int(inb.sum()) - n



# -- CarRacing: cr_dr.json, cr_plr.json, cr_robust_plr.json ------------------
CR_N, CR_T, CR_S = 16, 125, 8000
CR_COMMON = [
    '--env_name', 'CarRacing-Bezier-Adversarial-v0',
    '--ued_algo', 'domain_randomization', '--num_processes', str(CR_N),
    '--num_steps', str(CR_T), '--ppo_epoch', '8', '--num_mini_batch', '4',
    '--grayscale', 'false', '--crop_frame', 'false',
    '--num_action_repeat', '8', '--frame_stack', '4',
    '--normalize_returns', 'true', '--use_popart', 'false',
    '--handle_timelimits', 'true', '--recurrent_agent', 'false',
    '--recurrent_adversary_env', 'false', '--recurrent_hidden_size', '1',
    '--lr', '3e-4', '--max_grad_norm', '0.5', '--gamma', '0.99',
    '--gae_lambda', '0.9', '--value_loss_coef', '0.5',
    '--entropy_coef', '0.0', '--clip_value_loss', 'false',
    '--clip_param', '0.2', '--reward_shaping', 'true',
    '--log_plr_buffer_stats', 'true', '--log_grad_norm', 'true',
    '--seed', '1']
CR_DR_ARGS = CR_COMMON
CR_PLR_COMMON = CR_COMMON + [
    '--adv_entropy_coef', '0.01', '--use_categorical_adv', 'true',
    '--use_skip', 'false', '--choose_start_pos', 'false',
    '--sparse_rewards', 'false', '--use_plr', 'true',
    '--level_replay_strategy', 'positive_value_loss',
    '--level_replay_score_transform', 'power',
    '--level_replay_temperature', '1.0', '--staleness_coef', '0.7',
    '--level_replay_prob', '0.5', '--level_replay_rho', '0.5',
    '--level_replay_seed_buffer_size', str(CR_S),
    '--log_replay_complexity', 'true']
CR_PLR_ARGS = CR_PLR_COMMON + ['--no_exploratory_grad_updates', 'false']
CR_ROBUST_PLR_ARGS = CR_PLR_COMMON + ['--no_exploratory_grad_updates', 'true']
CR_STEP_TOL = 1e-6


def carracing_levels(n, device, seed=0, n_points=None):
    """(n, 28) CarRacing levels: control points uniform on the playfield,
    their count uniform in [3, 12] (``n_points`` fixes it), the start
    angle set on every other level and unset (-1) on the rest, dense
    rewards, a random seed."""
    import torch
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing,
    )
    from dcd_isaac_tpu_torch.envs.carracing.track import PLAYFIELD
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cps = torch.rand((n, 12, 2), generator=g, device=device) * PLAYFIELD
    if n_points is None:
        k = torch.randint(3, 13, (n,), generator=g, device=device)
    else:
        k = torch.full((n,), n_points, device=device)
    alpha = torch.rand((n,), generator=g, device=device) * 6.2831855
    alpha = torch.where(torch.arange(n, device=device) % 2 == 0, alpha,
                        torch.full_like(alpha, -1.0))
    seed_ = torch.randint(0, 1 << 24, (n,), generator=g, device=device)
    return AdversarialCarRacing.make_level(
        cps, k, alpha, torch.full((n,), -1, device=device), seed_)


def check_carracing_track(device, n=4096) -> dict:
    """Kernel B13b against its twin (``build_level_plain``) on 4096
    levels with n in [3, 12] and the start angle set and unset: every
    output bit for bit (points, betas, border and valid flags, counts,
    offsets, start tiles, the car)."""
    import torch
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing, build_level_plain,
    )
    from dcd_isaac_tpu_torch.kernels import carracing_track
    levels = carracing_levels(n, device, 11)
    cps, k, alpha, _, _ = AdversarialCarRacing.decode_level(levels)
    cps, k, alpha = cps.contiguous(), k.contiguous(), alpha.contiguous()
    tr, start, car = carracing_track.build(cps, k, alpha)
    ptr, pstart, pcar = build_level_plain(cps, k, alpha)
    err = 0.0
    for f in ('points', 'beta', 'border', 'valid', 'n_points', 'offset'):
        err = max(err, check_diff(f'carracing_track {f}', getattr(tr, f),
                                  getattr(ptr, f)))
    err = max(err, check_diff('carracing_track start', start, pstart))
    for f in ('pos', 'angle'):
        err = max(err, check_diff(f'carracing_track car {f}',
                                  getattr(car, f), getattr(pcar, f)))
    borders = int(tr.border.sum())
    if not (borders and int((start > 0).sum())):
        raise AssertionError(f'carracing_track: {borders} border tiles, '
                             f'{int((start > 0).sum())} start tiles > 0')
    return {'levels': n, 'max_abs_err': err, 'border_tiles': borders,
            'tiles': int(tr.n_points.sum()),
            'start_set': int((alpha >= 0).sum())}


def place_cars(state, g, device):
    """The cars of ``state`` moved onto their tracks: each on a random
    tile, across the road by 0 (on the road), the track width + 0.6 (on
    a border's band), 15 (on the grass) or 400 units (off the field) in
    turn, with random heading, speed, spin, wheel speeds and steering."""
    import torch
    from dcd_isaac_tpu_torch.envs.carracing.track import TRACK_WIDTH
    tr, car = state.track, state.car
    n = car.angle.shape[0]
    rows = torch.arange(n, device=device)
    tile = (torch.rand((n,), generator=g, device=device)
            * tr.n_points.float()).long()
    nrm = tr.beta[rows, tile]
    off = torch.tensor([0.0, TRACK_WIDTH + 0.6, 15.0, 400.0],
                       device=device)[rows % 4]
    off = off * torch.where(rows % 8 < 4, 1.0, -1.0)
    pos = tr.points[rows, tile] + off[:, None] * torch.stack(
        [torch.cos(nrm), torch.sin(nrm)], -1)
    u = lambda *s: torch.rand(s, generator=g, device=device) * 2 - 1
    return car.replace(
        pos=pos, angle=nrm + u(n) * 0.5, vel=u(n, 2) * 60,
        angvel=u(n) * 4, wheel_omega=u(n, 4) * 150, steer_angle=u(n) * 0.42)


def check_carracing_render(device, tracks=8, cars=64) -> dict:
    """Kernel B12 against its twin (``stack_frames_plain``) for 64 cars on
    each of 8 tracks at t = 0, 0.5 and 2 (the zoom ramp), on the road, on
    border bands, on the grass and off the field, with nonzero indicator
    bars: the new stack after random older frames, and a reset's
    replicated stack, bit for bit; the crop and grayscale variants
    too."""
    import torch
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing,
    )
    from dcd_isaac_tpu_torch.envs.carracing.env import (
        CarRacingConfig, stack_frames_plain,
    )
    from dcd_isaac_tpu_torch.kernels import carracing_render
    env = AdversarialCarRacing()
    levels = carracing_levels(tracks, device, 12,
                              n_points=12).repeat_interleave(cars, 0)
    state, _ = env.reset_to_level(levels)
    g = torch.Generator(device=device)
    g.manual_seed(13)
    car = place_cars(state, g, device)
    n = levels.shape[0]
    err, pixels = 0.0, {}
    for cfg in (CarRacingConfig(), CarRacingConfig(crop=True, grayscale=True,
                                                    frame_stack=2)):
        h, w = cfg.obs_hw
        old = torch.rand((n, h, w, cfg.obs_channels), generator=g,
                         device=device)
        for t in (0.0, 0.5, 2.0):
            tt = torch.full((n,), t, device=device)
            for frames in (old, None):
                got = carracing_render.render(cfg, car, state.track, tt,
                                              frames)
                want = stack_frames_plain(cfg, car, state.track, tt, frames)
                err = max(err, check_diff(
                    f'carracing_render crop={cfg.crop} t={t} '
                    f'shift={frames is not None}', got, want))
            if not cfg.crop:
                last = got[..., -3:]
                pixels[f't{t}'] = {
                    'road': int((last[..., 1] < -0.1).sum()),
                    'grass': int((last[..., 1] > 0.2).sum()),
                    'red': int(((last[..., 0] > 0.9)
                                & (last[..., 1] < -0.9)).sum())}
    if not all(all(v.values()) for v in pixels.values()):
        raise AssertionError(f'carracing_render: a layer is missing '
                             f'{pixels}')
    return {'cars': n, 'tracks': tracks, 'times': [0.0, 0.5, 2.0],
            'max_abs_err': err, 'pixels': pixels}


def check_carracing_step(device, steps=125, sparse=False, tracks=8,
                         cars=8) -> dict:
    """Kernel B13a against its twin (``step_dynamics_plain``) one control
    step at a time from the states of 64 cars on 8 tracks driven by
    random actions (mostly gas), each ended episode reset: every float
    within CR_STEP_TOL (relative, and absolute near zero), visited tiles,
    counts, done, truncation and the ring pointer exact.  Fails unless
    some wheels were on the grass, tiles were visited and episodes ended.
    ``sparse`` runs the sparse-reward goal bins with a reward clip of 5
    and a TimeLimit of 160 inner steps instead."""
    import torch
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing, CarRacingUEDParams,
    )
    from dcd_isaac_tpu_torch.envs.carracing.dynamics import wheel_positions
    from dcd_isaac_tpu_torch.envs.carracing.env import (
        CarRacingConfig, step_dynamics_plain,
    )
    from dcd_isaac_tpu_torch.envs.carracing.track import on_road
    from dcd_isaac_tpu_torch.kernels import carracing_step
    cfg = (CarRacingConfig(sparse_rewards=True, reward_shaping=False,
                           num_goal_bins=24, clip_reward=5.0,
                           max_inner_steps=160)
           if sparse else CarRacingConfig())
    env = AdversarialCarRacing(CarRacingUEDParams(cfg=cfg))
    levels = carracing_levels(tracks, device, 14,
                              n_points=12).repeat_interleave(cars, 0)
    n = levels.shape[0]
    if sparse:
        levels[:, 26] = torch.arange(n, device=device) % 24
    start, _ = env.reset_to_level(levels)
    g = torch.Generator(device=device)
    g.manual_seed(15)
    state = start
    err, grass, dones, truncs = 0.0, 0, 0, 0
    for _ in range(steps):
        a = torch.rand((n, 3), generator=g, device=device)
        a[:, 0] = a[:, 0] * 2 - 1
        a[:, 2] = torch.where(a[:, 2] < 0.8, 0.0, a[:, 2])
        wx, wy = wheel_positions(state.car)
        grass += int((~on_road(state.track, wx, wy)[0]).sum())
        got = carracing_step.step(cfg, state, a)
        want = step_dynamics_plain(cfg, state, a)
        for f in ('pos', 'angle', 'vel', 'angvel', 'wheel_omega',
                  'steer_angle', 'gas', 'fuel_spent'):
            err = max(err, check_diff(f'carracing_step car {f}',
                                      getattr(got[0].car, f),
                                      getattr(want[0].car, f), CR_STEP_TOL,
                                      CR_STEP_TOL))
        for f in ('reward_total', 'prev_reward', 't', 'reward_history',
                  'sparse_accum'):
            err = max(err, check_diff(f'carracing_step {f}',
                                      getattr(got[0], f), getattr(want[0], f),
                                      CR_STEP_TOL, CR_STEP_TOL))
        for f in ('visited', 'tile_visited_count', 'inner_steps', 'hist_ptr',
                  'done_latch', 'goal_reached'):
            check_diff(f'carracing_step {f}', getattr(got[0], f),
                       getattr(want[0], f))
        err = max(err, check_diff('carracing_step reward', got[1], want[1],
                                  CR_STEP_TOL, CR_STEP_TOL))
        check_diff('carracing_step done', got[2], want[2])
        check_diff('carracing_step truncated', got[3], want[3])
        dones += int(got[2].sum())
        truncs += int(got[3].sum())
        state = start.where(got[2], got[0])
    visited = int(state.tile_visited_count.sum())
    if not (grass and dones and visited):
        raise AssertionError(f'carracing_step: {grass} wheels on grass, '
                             f'{dones} ended episodes, {visited} tiles')
    return {'cars': n, 'steps': steps, 'sparse': sparse,
            'max_abs_err': err, 'wheel_steps_on_grass': grass,
            'episodes_ended': dones, 'truncated': truncs,
            'tiles_visited_at_end': visited, 'tol': CR_STEP_TOL}


def beta_inputs(R, device, seed=0):
    """Kernel B7's Beta rows: alphas and betas in [1, 9), actions in
    [0, 1] with an eighth at each clip edge (0 and 1), a quarter of the
    rows with the ratio exactly 1 and the values equal to the old
    values."""
    import torch
    from dcd_isaac_tpu_torch.models.distributions import beta_log_prob
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=device)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    alpha, beta, values = 1 + 8 * u(R, 3), 1 + 8 * u(R, 3), rn(R)
    x = u(R, 3)
    edge = u(R, 3)
    x = torch.where(edge < 0.125, torch.zeros_like(x),
                    torch.where(edge > 0.875, torch.ones_like(x), x))
    tie = u(R) < 0.25
    lp = beta_log_prob(alpha, beta, x)
    old_lp = torch.where(tie, lp, lp + rn(R) * 0.3)
    old_v = torch.where(tie, values, values + rn(R) * 0.3)
    return (alpha, beta, values, x, old_lp, old_v, values + rn(R), rn(R))


def check_ppo_loss_beta(R, clip_value_loss, device) -> dict:
    """Kernel B7's Beta branch against its twins: the four means within
    1e-6 relative of the twin in float64; dalpha, dbeta and dvalues within
    1e-5 of the twin's largest entry plus 1e-5 relative; bit-identical over
    two runs."""
    import torch
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        ppo_loss_beta, ppo_loss_beta_plain, ppo_loss_beta_plain_backward,
    )
    rows = beta_inputs(R, device)
    cfg = (0.2, clip_value_loss, 0.5, 0.01)
    upstream = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in rows[:3]]
        out = ppo_loss_beta(*leaves, *rows[3:], *cfg)
        runs.append((torch.stack(out).detach(),
                     *torch.autograd.grad(out[0], leaves)))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f'ppo_loss_beta R={R}: two runs differ')
    want = torch.stack(ppo_loss_beta_plain(*[t.double() for t in rows],
                                           *cfg))
    torch.testing.assert_close(runs[0][0].double(), want, rtol=1e-6,
                               atol=1e-9)
    grads = {}
    for name, a, b in zip(('dalpha', 'dbeta', 'dvalues'), runs[0][1:],
                          ppo_loss_beta_plain_backward(upstream, *rows,
                                                       *cfg)):
        scale = float(b.abs().max())
        if not scale > 0:
            raise AssertionError(f'ppo_loss_beta: {name} of the twin 0')
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=1e-5,
                                   msg=lambda m: f'{name}: {m}')
        e = float((a - b).abs().max())
        grads[name] = {'max_abs_err': e, 'max_abs_ref': scale,
                       'max_err_over_ref': e / scale}
    return {'R': R, 'clip_value_loss': clip_value_loss,
            'max_rel_err_means': float(((runs[0][0].double() - want).abs()
                                        / want.abs()).max()),
            'max_abs_err': max(g['max_abs_err'] for g in grads.values()),
            'grads': grads, 'identical_runs': True}



def check_carracing_against_cpu(device) -> dict:
    """A small CarRacing DR cycle, then a PLR⊥ generate and replay cycle
    (N = 4, T = 8, S = 16, 5-step episodes, VecNormalize, 2 epochs of 2
    minibatches), on the card and on the CPU from the same weights,
    levels, reset levels, actions, replay seeds and permutations.  Weight
    changes within 1e-5 (and a change beyond it), the buffers' levels,
    ids and masks exact and floats within 1e-5, the VecNormalize
    statistics within 1e-5, as ``walker_vs_cpu``.  Also the share of
    float32 inputs whose sin, cos, atan2 and sqrt differ between the CPU
    and the card (``float32_mismatch``)."""
    import dataclasses
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing, CarRacingUEDParams,
    )
    from dcd_isaac_tpu_torch.envs.carracing.env import CarRacingConfig
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    n, t, S = 4, 8, 16
    small = ['--num_processes', str(n), '--num_steps', str(t),
             '--ppo_epoch', '2', '--num_mini_batch', '2',
             '--level_replay_seed_buffer_size', str(S)]
    env = AdversarialCarRacing(CarRacingUEDParams(cfg=CarRacingConfig(
        max_inner_steps=40)))
    g = torch.Generator().manual_seed(0)
    levels = carracing_levels(n, 'cpu', 21, n_points=12)
    table = carracing_levels(t * n, 'cpu', 22).view(t, n, 28)
    acts = [torch.rand((t, n, 3), generator=g) for _ in range(3)]
    for a in acts:
        a[..., 0] = a[..., 0] * 2 - 1
    perms = [torch.stack([torch.randperm(t * n, generator=g)
                          for _ in range(2)]) for _ in range(3)]
    out = {}
    for name, argv in (('dr', CR_DR_ARGS), ('robust_plr',
                                             CR_ROBUST_PLR_ARGS)):
        args = parser.parse_args(argv + small)
        res = []
        for dev in ('cpu', device):
            net = make_model(args, env,
                             generator=torch.Generator().manual_seed(1))
            before = weights({'agent': net})
            runner = AdversarialRunner(args, env, {'agent': net.to(dev)},
                                       dev)
            script = lambda a: (lambda o, k: a[k].to(dev))
            reset = lambda k, st, seeds: (*env.reset_to_level(
                table[k].to(dev)), seeds)
            if name == 'dr':
                stats = runner.run(levels=levels.to(dev), reset_fn=reset,
                                   sample_action_fn=script(acts[0]),
                                   perms={'agent': perms[0].to(dev)})
                buf = {}
            else:
                runner.run(levels=levels.to(dev), replay=False,
                           sample_action_fn=script(acts[1]),
                           perms={'agent': perms[1].to(dev)})
                filled = runner.plr_buffer.filled.nonzero().flatten().cpu()
                seeds = filled[torch.arange(n) % filled.numel()]
                resets = filled[(torch.arange(t * n) * 3)
                                % filled.numel()].view(t, n)
                stats = runner.run(
                    replay=True, replay_seeds=seeds.to(dev),
                    replay_reset_seeds=lambda k: resets[k].to(dev),
                    sample_action_fn=script(acts[2]),
                    perms={'agent': perms[2].to(dev)})
                buf = {f.name: getattr(runner.plr_buffer, f.name).cpu()
                       for f in dataclasses.fields(runner.plr_buffer)
                       if not f.name.startswith('tscl')}
            res.append((stats, buf, weights({'agent': net}),
                        [x.cpu() for x in runner.ret_rms]))
        (cpu_stats, cpu_buf, cpu_after, cpu_rms), (
            card_stats, card_buf, card_after, card_rms) = res
        r = compare_weight_changes(before, cpu_after, card_after)['agent']
        r['ret_rms_max_abs_err'] = max(
            check_diff(f'card CarRacing {name} VecNormalize statistics '
                       'against the CPU', a, b, 1e-5, 1e-5)
            for a, b in zip(card_rms, cpu_rms))
        if buf:
            r['buffer_max_abs_err'] = max(
                check_diff(f'card CarRacing buffer {f} against the CPU', a,
                           cpu_buf[f], 1e-5 if a.is_floating_point()
                           and f != 'levels' else 0.0)
                for f, a in card_buf.items())
            r['filled'] = int(card_buf['filled'].sum())
        r['episodes'] = [cpu_stats['episodes'], card_stats['episodes']]
        if card_stats['episodes'] != cpu_stats['episodes'] or not (
                card_stats['episodes']):
            raise AssertionError(f'CarRacing {name}: episodes '
                                 f'{r["episodes"]}')
        out[name] = r
    # why the env's sin, cos, atan2 and sqrt are rounded from double: the
    # share of 10^6 float32 inputs in [-10, 10) whose float32 result
    # differs between the CPU and the card
    x = torch.rand(1_000_000, generator=g) * 20 - 10
    y = x.flip(0) + 0.5
    out['float32_mismatch'] = {
        name: float((f(x, y) != f(x.to(device), y.to(device)).cpu())
                    .double().mean())
        for name, f in (('sin', lambda a, b: torch.sin(a)),
                        ('cos', lambda a, b: torch.cos(a)),
                        ('atan2', torch.atan2),
                        ('sqrt', lambda a, b: torch.sqrt(a.abs())))}
    return out


def carracing_track_work(n_points, start_set: int) -> tuple:
    """(bytes, operations) that B13b must move and do for these levels,
    counted from csrc/carracing_track.cu: 104 B read a level (control
    points, count, start angle) and 6748 B written (points, betas,
    border and valid flags, count, offset, start tile, the car's position
    and angle), the 167-float table once.  Operations a level of n
    points: the mean 26, the rank sort 2 n², the segments 31 n; then 55
    a curve point (14 for its Bernstein sample, 11 for its step's angle,
    mask and bbox, 3 for |Δβ|, 22 for the border tests, 3 for the spread,
    2 for the centring), the tree sum's 511 adds; and 9 a point more on a
    level whose start angle is set (its polar angle and difference)."""
    n = n_points.double()
    levels = n.numel()
    ops = float((26 + 2 * n * n + 31 * n).sum()) + levels * (480 * 55 + 511)
    return (levels * (104 + 6748) + 167 * 4,
            ops + start_set * (480 * 9 + 30))


def carracing_render_work(state, frame_stack: int, shift: bool) -> tuple:
    """(bytes, operations) that B12 must move and do for these cars,
    counted from csrc/carracing_render.cu: a car's track read once (480 x
    14 B) and its state (60 B); the frame written (96 x 96 x 12 floats at
    the stack of 4) and, with the shift, the older frames read (9 of the
    12 channels); the 66-float table once.  Operations a pixel: 65 (the
    camera 25, the layers 40) and 8 for each valid point of its track."""
    n = state.track.n_points.shape[0]
    pixels = 96 * 96
    nbytes = (n * (480 * 14 + 60) + n * pixels * 3 * frame_stack * 4
              + (n * pixels * 3 * (frame_stack - 1) * 4 if shift else 0)
              + 66 * 4)
    ops = pixels * float((65 + 8 * state.track.n_points.double()).sum())
    return nbytes, ops


def carracing_step_work(state, repeat: int) -> tuple:
    """(bytes, operations) that B13a must move and do for these cars,
    counted from csrc/carracing_step.cu: 5308 B read a car (its state,
    track points and valid flags, visited flags, ring, counters, action)
    and 981 B written; the 30-float table once.  Operations a car: the
    4 wheel searches before the first substep, then in each substep the
    car step (300), 5 nearest-point searches (the 4 new wheel positions
    and the hull: 3 + 8 per valid point each) and 150 for the visits,
    rewards and the ring's tree sum."""
    nv = state.track.n_points.double()
    n = nv.numel()
    search = 3 + 8 * nv
    ops = float((4 * search + repeat * (300 + 5 * search + 150)).sum())
    return n * (5308 + 981) + 30 * 4, ops


def ppo_loss_beta_work(alpha, beta, clip_value_loss: bool,
                       backward: bool) -> tuple:
    """(bytes, fp32 operations, fp64 operations) that B7's Beta branch must
    move and do for these rows, counted from csrc/ppo_loss.cu's body
    (``beta_row``, ``digamma_d``, ``trigamma_d``, the rows, fold and
    backward kernels) for this data: an add, product, quotient,
    comparison, min, max, lgamma, log, log1p or exp is one operation.
    Bytes a row: alpha, beta and the actions (9 floats) and five scalars
    read; the four means written, or, backward, the four upstream
    gradients read and dalpha, dbeta and dvalues (7 floats) written.
    digamma at x does 17 + 4 k and trigamma 19 + 5 k, k = max(0, ceil(6 -
    x)) steps of the recurrence.  Forward, in double: 27 an action (log B
    6, the log-density 10, the entropy 11) and digamma of a, b and a + b;
    6 a row for the ratio and surrogates and 4 for its sums; the CTA trees
    (3 x 255 adds a CTA and in the fold), the fold's 3 a partial and its 9
    for the means.  In float: the clamp of the actions (2 an action) and
    the value term (5, or 9 clipped).  Backward, one thread a row: the
    forward row again, 4 + 15 for the coefficients and the surrogate's
    weights, 24 an action and digamma and trigamma of a, b and a + b in
    double; 2 + 6 + 6 (coefficient, clamps twice) and the value gradient
    (8, or 22 clipped) in float."""
    a, b = alpha.double(), beta.double()
    R = a.shape[0]
    steps = lambda x: (6.0 - x).ceil().clamp(min=0)
    dg = lambda x: 17 + 4 * steps(x)
    tg = lambda x: 19 + 5 * steps(x)
    row = float((27 + dg(a) + dg(b) + dg(a + b)).sum()) + 6 * R
    if not backward:
        ctas = min(max(-(-R // 256), 1), 512)
        f64 = row + 4 * R + (ctas + 1) * 3 * 255 + 3 * ctas + 9
        f32 = R * (6 + (9 if clip_value_loss else 5))
        return R * 14 * 4 + 4 * 4, f32, f64
    f64 = row + 19 * R + float((24 + dg(a + b) + tg(a + b) + dg(a) + tg(a)
                                + dg(b) + tg(b)).sum())
    f32 = R * (14 + (22 if clip_value_loss else 8))
    return R * (14 + 7) * 4 + 4 * 4, f32, f64


def time_carracing_kernels(device) -> dict:
    """Kernels B13b, B12, B13a and B7's Beta branch at the CarRacing
    path's shapes (N = 16 levels and cars; the minibatch R = 500 and the
    whole rollout R = 2000), with their twins and bounds (work:
    ``carracing_track_work``, ``carracing_render_work``,
    ``carracing_step_work``, ``ppo_loss_beta_work``)."""
    import torch
    from types import SimpleNamespace
    from dcd_isaac_tpu_torch.envs.carracing.adversarial import (
        AdversarialCarRacing, build_level_plain,
    )
    from dcd_isaac_tpu_torch.envs.carracing.env import (
        CarRacingConfig, stack_frames_plain, step_dynamics_plain,
    )
    from dcd_isaac_tpu_torch.kernels import carracing_render as cr
    from dcd_isaac_tpu_torch.kernels import carracing_step as cs
    from dcd_isaac_tpu_torch.kernels import carracing_track as ct
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        PPOLossBeta, ppo_loss_beta, ppo_loss_beta_plain,
        ppo_loss_beta_plain_backward,
    )
    n = CR_N
    env = AdversarialCarRacing()
    levels = carracing_levels(n, device, 31, n_points=12)
    levels[:, 25] = -1.0                # DR's levels start at tile 0
    cps, k, alpha, _, _ = env.decode_level(levels)
    cps, k, alpha = cps.contiguous(), k.contiguous(), alpha.contiguous()
    out = {}
    b = bound(*carracing_track_work(k, 0))
    out['carracing_track'] = {
        'ms': graph_ms(lambda: ct.build(cps, k, alpha), 50),
        'plain_ms': device_ms(lambda: build_level_plain(cps, k, alpha), 1, 5),
        'bound_ms': b[0], 'bound_by': b[1]}
    state, _ = env.reset_to_level(levels)
    g = torch.Generator(device=device)
    g.manual_seed(32)
    cfg = CarRacingConfig()
    a = torch.rand((n, 3), generator=g, device=device)
    for _ in range(20):                 # under way, tiles visited
        state = cs.step(cfg, state, a)[0]
    b = bound(*carracing_render_work(state, 4, True))
    out['carracing_render'] = {
        'ms': graph_ms(lambda: cr.render(cfg, state.car, state.track,
                                         state.t, state.frames), 20),
        'plain_ms': device_ms(lambda: stack_frames_plain(
            cfg, state.car, state.track, state.t, state.frames), 1, 5),
        'bound_ms': b[0], 'bound_by': b[1]}
    b = bound(*carracing_step_work(state, cfg.num_action_repeat))
    out['carracing_step'] = {
        'ms': graph_ms(lambda: cs.step(cfg, state, a), 50),
        'plain_ms': device_ms(lambda: step_dynamics_plain(cfg, state, a),
                              1, 3),
        'bound_ms': b[0], 'bound_by': b[1]}
    for R in (CR_N * CR_T // 4, CR_N * CR_T):
        rows = beta_inputs(R, device)
        cfg_ = (0.2, False, 0.5, 0.0)
        ctx = SimpleNamespace(saved_tensors=rows, cfg=cfg_)
        ones = [torch.ones((), device=device)] * 4
        fb = bound(*ppo_loss_beta_work(rows[0], rows[1], cfg_[1], False))
        bb = bound(*ppo_loss_beta_work(rows[0], rows[1], cfg_[1], True))
        out[f'ppo_loss_beta_r{R}'] = {
            'ms': graph_ms(lambda: ppo_loss_beta(*rows, *cfg_), 20),
            'backward_ms': graph_ms(
                lambda: PPOLossBeta.backward(ctx, *ones), 20),
            'plain_ms': device_ms(lambda: ppo_loss_beta_plain(
                *rows, *cfg_), 5, 10),
            'plain_backward_ms': device_ms(
                lambda: ppo_loss_beta_plain_backward(
                    torch.ones(4, device=device), *rows, *cfg_), 5, 10),
            'bound_ms': fb[0], 'bound_by': fb[1],
            'backward_bound_ms': bb[0], 'backward_bound_by': bb[1]}
    return out


def bound(nbytes, flops, flops64=0.0, tf32=0.0):
    """(least ms for the work, 'bytes' or 'operations'): the larger of the
    bytes over the HBM rate and the operations over the peak of their type
    (fp32 ``flops`` on the CUDA cores, fp64 ``flops64``, TF32 ``tf32`` on
    the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / FP32_FLOPS + flops64 / FP64_FLOPS
             + tf32 / TF32_FLOPS) * 1e3
    return (max(t_bytes, t_ops),
            'bytes' if t_bytes >= t_ops else 'operations')


def time_kernels(device) -> dict:
    """Kernel and plain-twin times at the main path's shapes, with bounds."""
    import torch
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels.gae import gae, gae_plain
    from dcd_isaac_tpu_torch.kernels.multigrid_step import (
        multigrid_obs, multigrid_step, obs_plain, step_plain,
    )
    env = make_env(ENV_NAME)
    p = env.params
    v = p.agent_view_size
    n = MAIN_N
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    s, _ = env.reset_random(n, gen, device)
    action = random_actions(n, gen, device)
    step_args = (s.grid, s.agent_pos, s.agent_dir, s.step_count,
                 s.agent_done, action, v, p.max_steps)
    obs_args = (s.grid, s.agent_pos, s.agent_dir, v)
    x = gae_inputs(MAIN_T, n, device)
    gae_kw = dict(gamma=0.995, gae_lambda=0.95, use_proper_time_limits=True)

    # Bytes each function must move at this batch: every needed input byte
    # read once, every output byte written once.  Of the grid, the view
    # gather needs the in-bounds cells of each view but the agent's own.
    # The step needs those of the new view; its forward cell lies in that
    # view unless the agent moves onto it, which adds one cell per move.
    new_pos, new_dir = step_plain(*step_args)[:2]
    moves = int((new_pos != s.agent_pos).any(-1).sum())
    view = v * v
    step_bytes = (view_cells_read(s.grid, new_pos, new_dir, v) + moves
                  + n * (8 + 4 + 4 + 1 + 4                   # state, action
                         + 8 + 4 + 4 + 1 + 3 * view + 4 + 1 + 1))
    obs_bytes = (view_cells_read(s.grid, s.agent_pos, s.agent_dir, v)
                 + n * (8 + 4 + 3 * view))
    gae_bytes = MAIN_T * n * (4 + 4 + 1 + 4 + 4 + 4) + n * 4
    # fp32 operations: the reward (3 per env); GAE about 12 per element.
    step_flops, obs_flops, gae_flops = 3 * n, 0, 12 * MAIN_T * n

    out = {}
    for name, fn, plain, nbytes, flops, inner in (
            ('multigrid_step', lambda: multigrid_step(*step_args),
             lambda: step_plain(*step_args), step_bytes, step_flops, 200),
            ('multigrid_obs', lambda: multigrid_obs(*obs_args),
             lambda: obs_plain(*obs_args), obs_bytes, obs_flops, 200),
            ('gae', lambda: gae(**x, **gae_kw),
             lambda: gae_plain(**x, **gae_kw), gae_bytes, gae_flops, 20)):
        b_ms, b_by = bound(nbytes, flops)
        out[name] = {'ms': graph_ms(fn, inner),
                     'plain_ms': device_ms(plain, 1, 20),
                     'bound_ms': b_ms, 'bound_by': b_by}
    return out


def tf32_bounds(nbytes, products, other, side_products=0.0) -> dict:
    """A 3xTF32 kernel's bound both ways: its own route, each fp32 product
    of ``products`` as three TF32 products on the tensor cores and the rest
    (``other``: B4's conv and its gradient reduction, B3's cell) in fp32 on
    the CUDA cores, with ``side_products`` that cuBLAS computes beside the
    kernel (B3's dW_h, in float64 on the FP64 tensor cores, whose 67
    TFLOP/s equal the CUDA cores' fp32 rate); and every operation in fp32
    on the CUDA cores (``_fp32_simt``)."""
    b_ms, b_by = bound(nbytes, other + side_products, tf32=3 * products)
    s_ms, s_by = bound(nbytes, products + other + side_products)
    return {'bound_ms': b_ms, 'bound_by': b_by,
            'bound_ms_fp32_simt': s_ms, 'bound_by_fp32_simt': s_by}


def in_row_chunks(fn, rows, *args):
    """``fn`` over consecutive row chunks of its batch arguments (the
    twins' CHUNK_BYTES budget: their (rows, K) embed would not fit)."""
    import torch
    return torch.cat([fn(*(a[r:r + rows] if i in (0, 3) else a
                           for i, a in enumerate(args)))
                      for r in range(0, args[0].shape[0], rows)])


def paired_ms(kernel, twin, pairs: int) -> dict:
    """Kernel and twin timed in turn ``pairs`` times (each call of
    ``kernel`` or ``twin`` measures and returns ms), so that the card's
    drift over a run falls on both alike: their medians, and the pairs
    in which the kernel was the faster."""
    got = [(kernel(), twin()) for _ in range(pairs)]
    return {'ms': statistics.median(k for k, _ in got),
            'plain_ms': statistics.median(t for _, t in got),
            'pairs_won': sum(k < t for k, t in got), 'pairs': pairs}


def time_teacher_proj(device) -> dict:
    """B4's forward where the main paths run it: B = 32 (a construction
    step), 27 * 32 (a teacher update, N = 1024 and the teacher without a
    core's N = 64), 8192 (a construction step of bench.py's workload) and
    52 * 8192 (its teacher update), paired with the twin (in CHUNK_BYTES
    row chunks; ``paired_ms``), with both bounds and the library
    yardstick: cuBLAS's SGEMM (``torch.matmul``) of a precomputed embed by
    W_i^T, one call a row chunk, a call the port never makes."""
    import torch
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    out = {}
    with torch.no_grad():
        for batch, n_out, inner, pairs in (
                (MAIN_N, 1024, 20, 9), (27 * MAIN_N, 1024, 5, 9),
                (27 * MAIN_N, 64, 5, 9), (BENCH_SIZE_N, 1024, 1, 5),
                (52 * BENCH_SIZE_N, 1024, 1, 3)):
            args = teacher_backward_inputs(batch, n_out, device)[:5]
            img, conv_w, conv_b, e, w_i = args
            k = w_i.shape[1]
            conv_dim = k - e.shape[1]
            rows = max(1, int(tp.CHUNK_BYTES // (4 * k)))
            nbytes = (w_i.numel() * 4 + img.numel() + conv_w.numel() * 4
                      + conv_b.numel() * 4 + e.numel() * 4 + batch * n_out * 4)
            samples = 5 if inner > 1 else 1
            times = {**paired_ms(
                         lambda: (graph_ms if inner > 1 else device_ms)(
                             lambda: tp.teacher_proj(*args), inner, samples),
                         lambda: device_ms(
                             lambda: in_row_chunks(tp.teacher_proj_plain,
                                                   rows, *args), 1, samples),
                         pairs),
                     **tf32_bounds(nbytes, 2 * batch * k * n_out,
                                   2 * 27 * batch * conv_dim)}
            full, rest = divmod(batch, rows)
            library = 0.0
            for n_rows, count in ((rows, full), (rest, 1)):
                if n_rows and count:
                    a = tp.embed_plain(img[:n_rows], conv_w, conv_b,
                                       e[:n_rows])
                    library += count * device_ms(
                        lambda: torch.matmul(a, w_i.T), 1, min(pairs, 5))
                    del a
            times['library_ms'] = library
            suffix = ('' if batch == MAIN_N else f'_b{batch}') + (
                '' if n_out == 1024 else f'_n{n_out}')
            out.update({f'{k_}{suffix}': v for k_, v in times.items()})
            del args, img, e
            torch.cuda.empty_cache()
    return {'teacher_proj': out}


def time_teacher_kernels(device) -> dict:
    """Kernel B5 (a construction move, the final move with its BFS, the BFS
    alone) at N = 32, with its plain twin and bound."""
    import torch
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary as ma
    env = make_env(ENV_NAME)
    p = env.params
    n = MAIN_N
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    moves = lambda: torch.randint(0, p.adversary_action_dim, (n,),
                                  generator=gen, device=device,
                                  dtype=torch.int32)
    state, _ = env.reset(n, gen, device)
    states = []
    for t in range(p.adversary_max_steps - 1):
        state, _, _ = env.step_adversary(state, moves(), gen)
        states.append(state)
    u = torch.rand((n, 3), generator=gen, device=device)
    loc = moves()
    cells = p.width * p.height
    # per level: the grid and ~64 bytes of state, loc and u read; the grid,
    # ~42 bytes of state, the image and done written
    step_bytes = n * (cells + 64 + cells + 42 + 3 * cells + 1)
    grid, start, goal = random_levels(n, device)
    bfs_bytes = n * (cells + 16 + 5)
    out = {}
    with torch.no_grad():
        for name, st in (('multigrid_adversary_step', states[10]),
                         ('multigrid_adversary_step_final', states[-1])):
            b_ms, b_by = bound(step_bytes, 0)
            out[name] = {
                'ms': graph_ms(lambda: ma.step(st, loc, u, p), 200),
                'plain_ms': device_ms(lambda: ma.step_plain(st, loc, u, p),
                                      1, 20),
                'bound_ms': b_ms, 'bound_by': b_by}
        b_ms, b_by = bound(bfs_bytes, 0)
        out['multigrid_shortest_path'] = {
            'ms': graph_ms(lambda: ma.shortest_path(grid, start, goal, 170),
                           200),
            'plain_ms': device_ms(
                lambda: ma.shortest_path_plain(grid, start, goal, 170), 1, 20),
            'bound_ms': b_ms, 'bound_by': b_by}
    return out


def policy_step_work(w, B) -> tuple:
    """(bytes, fp32 operations) of a sample-mode B2 step of B rows: the
    weights and each row's view, direction, carry, mask and uniform read
    once, its logits, value, carry, action and log-prob written once; the
    conv, the gate product, the cell, the trunks and heads, the softmax."""
    H, F = w.w_h.shape[1], w.w_i.shape[1]
    A, conv = w.actor[4].shape[0], w.w_i.shape[1] - 5
    weight_bytes = 4 * sum(t.numel() for t in (
        w.conv_w, w.conv_b, w.emb_w, w.emb_b, w.w_i, w.w_h, w.b_h, *w.actor,
        *w.critic))
    row = (75 + 4 + 2 * 4 * H + 4 + 4) + (4 * A + 4 + 2 * 4 * H + 8 + 4)
    flops = B * (2 * (conv * 27 + F * 4 * H + H * 4 * H + H * 64 + 32 * 64
                      + 32 * (A + 1)) + 10 * H + 10 * A)
    return weight_bytes + B * row, flops


def teacher_proj_backward_work(img, e, w_i, parts=3) -> tuple:
    """(bytes, product operations, other fp32 operations) of B4's backward
    (``parts`` 1 dW, 2 dA, 3 both): the image, e, W_i, the upstream
    gradient and the conv weights read once, dW, g_e and the conv
    gradients written once; the products 2 B N K each; the conv computed
    once (2 B conv_dim 27: A for dW, ReLU' for dA) and, for dA, reduced
    into its gradients (2 B conv_dim 28)."""
    B, N, K, E = img.shape[0], w_i.shape[0], w_i.shape[1], e.shape[1]
    conv_dim, C = K - E, 128
    read = img.numel() + 4 * (N * K + B * N + C * 28)
    nbytes = (read + (4 * N * K if parts & 1 else 0)
              + (4 * (B * E + C * 28) + 4 * B * E if parts & 2 else 0))
    products = 2 * B * N * K * ((parts & 1) + (parts >> 1))
    other = 2 * B * conv_dim * (27 + (28 if parts & 2 else 0))
    return nbytes, products, other


def time_policy_kernels(device) -> dict:
    """Kernel B2 at a rollout's B = 32 and at bench.py's B = 8192 (sample
    mode; the value mode at B = 32), with its twin and bound."""
    import torch
    from dcd_isaac_tpu_torch.kernels.policy_step import (
        policy_step, policy_step_plain,
    )
    out = {}
    with torch.no_grad():
        for B, inner in ((MAIN_N, 200), (BENCH_SIZE_N, 20)):
            w, x = policy_inputs(B, device)
            args = (x['image'], x['direction'], x['c'], x['h'], x['mask'], w)
            b_ms, b_by = bound(*policy_step_work(w, B))
            suffix = '' if B == MAIN_N else f'_b{B}'
            out.update({
                f'ms{suffix}': graph_ms(
                    lambda: policy_step(*args, 'sample', u=x['u']), inner),
                f'plain_ms{suffix}': device_ms(
                    lambda: policy_step_plain(*args, 'sample', u=x['u']), 1,
                    20),
                f'bound_ms{suffix}': b_ms, f'bound_by{suffix}': b_by})
            if B == MAIN_N:
                out['ms_value_mode'] = graph_ms(
                    lambda: policy_step(*args, 'value'), inner)
    return {'policy_step': out}


def time_teacher_backward(device) -> dict:
    """B4's backward (dW, dA and both) at the teacher updates' shapes: B =
    27 * 32 rows for N = 1024 (the recurrent teacher) and N = 64 (the
    teacher without a core), and bench.py's B = 52 * 8192 at N = 1024,
    with the bound and the twin, the two paired (``paired_ms``)."""
    import torch
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    out = {}
    for batch, n_out, samples, pairs in ((27 * MAIN_N, 1024, 10, 9),
                                         (27 * MAIN_N, 64, 10, 9),
                                         (52 * BENCH_SIZE_N, 1024, 2, 3)):
        args = teacher_backward_inputs(batch, n_out, device)
        img, _, _, e, w_i, _ = args
        suffix = '' if (batch, n_out) == (27 * MAIN_N, 1024) else (
            f'_n{n_out}' if batch == 27 * MAIN_N else f'_b{batch}')
        for name, parts in (('', 3), ('_dw', 1), ('_da', 2)):
            bounds = tf32_bounds(*teacher_proj_backward_work(
                img, e, w_i, parts))
            if parts == 3:
                each = (samples + 2) // 4
                pair = paired_ms(
                    lambda: device_ms(lambda: tp._launch_backward(*args),
                                      1, each),
                    lambda: device_ms(
                        lambda: tp.teacher_proj_backward_plain(*args), 1,
                        each), pairs)
                out.update({f'{k}{suffix}': v for k, v in pair.items()})
            else:
                out[f'ms{name}{suffix}'] = device_ms(
                    lambda: tp._launch_backward(*args, parts=parts), 1,
                    samples)
            out.update({f'{k}{name}{suffix}': v for k, v in bounds.items()})
        del args, img, e, w_i
        torch.cuda.empty_cache()
    return {'teacher_proj_backward': out}


def time_training_kernels(device) -> dict:
    """Kernels B3 and B7 on the update path, with their plain twins and
    bounds: B3's forward pass and its backward pass (one kernel for the
    recomputed gates and dz @ W_h, then the float64 dW_h products), the
    backward's kernel apart, each per pass and per step, with both bounds
    (3xTF32 and fp32) and the launch plans, at T = 256, H = 256 for N = 32
    (the slices) and N = 8192 (bench.py); B7's forward and backward at
    R = T * N rows for the same two N, and the advantage normalisation."""
    import torch
    from dcd_isaac_tpu_torch.kernels import lstm_seq as ls
    from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
    out = {'lstm_seq': {}, 'ppo_loss': {}}
    H = 256
    for n, inner, samples in ((MAIN_N, 3, 15), (BENCH_SIZE_N, 1, 3)):
        x, (g_h, g_c) = lstm_inputs(MAIN_T, n, device)
        args = tuple(x.values())
        tnh = MAIN_T * n * H
        prod = 2 * tnh * 4 * H      # one recurrent product over the pass
        with torch.no_grad():
            h_all, c_all = ls._launch_forward(*args)
            bwd_args = (g_h, g_c, *args, h_all, c_all)
            # the forward reads zx and writes c and h; the backward reads
            # zx, c, h and dh and writes dzx; its kernel takes two products
            # (z recomputed, dz @ W_h), its dW_h a third in float64
            fwd = tf32_bounds(4 * (4 * tnh + 2 * tnh), prod, 30 * tnh)
            bwd_bytes = 4 * (4 * tnh + 3 * tnh + 4 * tnh)
            bwd_k = tf32_bounds(bwd_bytes, 2 * prod, 40 * tnh)
            bwd = tf32_bounds(bwd_bytes, 2 * prod, 40 * tnh,
                              side_products=prod)
            sfx = '' if n == MAIN_N else f'_n{n}'
            ms = graph_ms(lambda: ls._launch_forward(*args), inner, samples)
            ms_b = graph_ms(lambda: ls._launch_backward(*bwd_args), inner,
                            samples)
            ms_k = graph_ms(lambda: ls._backward_kernel(*bwd_args), inner,
                            samples)
            row = {
                'ms': ms, 'ms_per_step': ms / MAIN_T,
                'plain_ms': device_ms(
                    lambda: ls.lstm_seq_plain_forward(*args), 1, samples),
                **fwd,
                'ms_backward': ms_b,
                'ms_backward_kernel': ms_k,
                'ms_backward_kernel_per_step': ms_k / MAIN_T,
                'plain_ms_backward': device_ms(
                    lambda: ls.lstm_seq_plain_backward(*bwd_args), 1,
                    samples),
                **{f'{k}_backward': v for k, v in bwd.items()},
                **{f'{k}_backward_kernel': v for k, v in bwd_k.items()},
                'plan': ls.plan(n, H), 'plan_backward': ls.plan(n, H, True)}
            out['lstm_seq'].update({k + sfx: v for k, v in row.items()})
        del x, args, h_all, c_all, bwd_args, g_h, g_c
        torch.cuda.empty_cache()

    # B7 at the students' R = T * N (7 actions) and the teacher's update at
    # bench.py's size (52 moves x 8192 levels, 169 placements)
    for R, A in ((MAIN_T * MAIN_N, 7), (MAIN_T * BENCH_SIZE_N, 7),
                 (52 * BENCH_SIZE_N, 169)):
        samples = 15 if R == MAIN_T * MAIN_N else 5
        rows = ppo_inputs(R, device, A)
        cfg = (0.2, True, 0.5, 0.0)
        upstream = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
        # A logits, 5 floats and an int64 action read a row; dlogits and
        # dvalues written by the backward; ~10 operations a logit
        fwd = bound(R * (A * 4 + 5 * 4 + 8), (10 * A + 30) * R)
        bwd = bound(R * (2 * A * 4 + 6 * 4 + 8), (14 * A + 40) * R)
        norm = bound(R * 3 * 4, 6 * R)
        suffix = ('' if R == MAIN_T * MAIN_N else
                  f'_r{R}' if A == 7 else f'_r{R}_a{A}')
        out['ppo_loss'].update({
            f'ms{suffix}': graph_ms(lambda: pl._launch_forward(*rows, *cfg),
                                    20, samples),
            f'plain_ms{suffix}': device_ms(
                lambda: pl.ppo_loss_plain(*rows, *cfg), 1, samples),
            f'bound_ms{suffix}': fwd[0], f'bound_by{suffix}': fwd[1],
            f'ms_backward{suffix}': graph_ms(
                lambda: pl._launch_backward(upstream, *rows, *cfg), 20,
                samples),
            f'plain_ms_backward{suffix}': device_ms(
                lambda: pl.ppo_loss_plain_backward(upstream, *rows, *cfg), 1,
                samples),
            f'bound_ms_backward{suffix}': bwd[0],
            f'bound_by_backward{suffix}': bwd[1],
            f'ms_normalize{suffix}': graph_ms(
                lambda: pl.normalize_advantages(rows[5], rows[1]), 20,
                samples),
            f'plain_ms_normalize{suffix}': device_ms(
                lambda: pl.normalize_advantages_plain(rows[5], rows[1]), 1,
                samples),
            f'bound_ms_normalize{suffix}': norm[0]})
        del rows
        torch.cuda.empty_cache()
    return out


def plr_buffer(S, device, seed=0, filled=0.6):
    """A PLR buffer of S slots: 15x15 levels (35 % walls, a goal and an
    agent) in a share of them, every fifth a copy of another, scores with
    ties, seen and unseen slots, staleness and known and unknown grounded
    values."""
    import torch
    from dcd_isaac_tpu_torch.level_replay import plr
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    full = r(S) < filled
    grid, start, goal = random_levels(S, device, seed)
    levels = torch.stack([grid, torch.where(grid == 2, 5, 0).to(torch.uint8),
                          torch.zeros_like(grid)], -1)
    rows = torch.arange(S, device=device)
    levels[rows, goal[:, 0].long(), goal[:, 1].long()] = torch.tensor(
        [8, 1, 0], dtype=torch.uint8, device=device)
    copies = torch.arange(0, S - 1, 5, device=device)
    levels[copies] = levels[copies + 1]
    levels = levels * full[:, None, None, None]
    scores = torch.round(torch.randn((S,), generator=g, device=device) * 4) / 4
    return plr.PLRBuffer(
        levels=levels, scores=scores * full,
        staleness=torch.floor(r(S) * 40),
        unseen=torch.where(full & (r(S) < 0.8), 0.0, 1.0),
        filled=full, solvable=r(S) < 0.9,
        grounded_values=torch.where(r(S) < 0.5, r(S),
                                    torch.full((S,), -1e9, device=device)),
        num_edits=torch.floor(r(S) * 4).int(),
        slot_ids=torch.where(full, rows, -1).int(),
        next_id=torch.tensor(S, dtype=torch.int32, device=device),
        sample_count=torch.tensor(12.0, device=device),
        tscl_returns=torch.zeros((S, 10), device=device),
        tscl_stamps=torch.zeros((S, 10), device=device),
        tscl_n=torch.zeros(S, dtype=torch.int32, device=device))


def plr_rollout(T, N, S, device, seed=0):
    """A student rollout's PLR fields: sparse rewards, episodes ending one
    step in twenty (the last step forced, a cliffhanger where no episode
    ended), each episode on a working seed among the first 300 slots (with
    repeats; all S when S < 300), on its env's staged seed S + n, or on
    none."""
    import torch
    from types import SimpleNamespace
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    dones = r(T, N) < 0.05
    cliff = torch.zeros_like(dones)
    cliff[-1] = ~dones[-1]
    dones[-1] = True
    episode = torch.cat([torch.zeros_like(dones[:1]), dones[:-1]]).long(
        ).cumsum(0)
    kind = r(N, T + 1)
    seed_of = torch.where(
        kind < 0.5, torch.floor(r(N, T + 1) * min(300, S)).long(),
        torch.where(kind < 0.8, S + torch.arange(N, device=device)[:, None],
                    torch.full_like(episode[:1].T, -1)))
    seeds = seed_of.gather(1, episode.T).T.int().contiguous()
    return SimpleNamespace(
        rewards=r(T, N) * (r(T, N) < 0.1), dones=dones, cliffhangers=cliff,
        level_seeds=seeds,
        values=torch.randn((T, N), generator=g, device=device),
        returns=torch.randn((T, N), generator=g, device=device))


def plr_staged(buf, N, device, seed=0, n_dups=3):
    """N staged levels: copies of filled slots, a pair of equal ones, the
    rest new; scores with ties, a fifth without a completed episode."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    grid, _, goal = random_levels(N, device, seed + 1)
    levels = torch.stack([grid, torch.zeros_like(grid),
                          torch.zeros_like(grid)], -1)
    filled = buf.filled.nonzero().flatten()
    k = min(n_dups, filled.numel(), N - 2)
    levels[:k] = buf.levels[filled[:k]]
    levels[-1] = levels[-2]
    scores = torch.round(torch.randn((N,), generator=g, device=device) * 4) / 4
    counts = torch.where(r(N) < 0.8, torch.floor(r(N) * 3) + 1, 0.0)
    return (levels.contiguous(), scores, counts, r(N) < 0.8,
            torch.floor(r(N) * 4 + 1).int())


def check_diff(name, a, b, atol=0.0, rtol=0.0) -> float:
    """``max_abs_diff(a, b)`` of a kernel's output and its twin's; raises
    where an entry's |a - b| passes atol + rtol * |b| (a NaN too)."""
    err = max_abs_diff(a, b)
    ok = err <= atol
    if rtol and not ok:
        d = (a.double() - b.double()).abs()
        ok = bool((d <= atol + rtol * b.double().abs()).all())
    if not ok:
        raise AssertionError(f'{name}: kernel and twin differ by up to '
                             f'{err} (atol {atol}, rtol {rtol})')
    return err


def check_plr_fold(T, N, S, device, strategy, seed=0, **kw) -> dict:
    """Kernel B8 (a) against ``update_with_rollout_plain``: scores,
    grounded values and staged scores within 1e-6, unseen, staleness and
    staged counts exact, and the kernel's two runs identical."""
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.level_replay import plr
    cfg = plr.PLRConfig(capacity=S, num_actors=N, strategy=strategy, **kw)
    buf = plr_buffer(S, device, seed)
    ro = plr_rollout(T, N, S, device, seed)
    args = (ro.rewards, ro.values, ro.returns, ro.dones, ro.cliffhangers,
            ro.level_seeds, buf.scores, buf.unseen, buf.grounded_values,
            buf.staleness, cfg, S)
    runs = [pk.score_fold(*args) for _ in range(2)]
    for a, b in zip(*runs):
        check_diff(f'score_fold {strategy} second run', a, b)
    nb, st, cnt = plr.update_with_rollout_plain(buf, cfg, ro, ro.returns,
                                                ro.values)
    want = (nb.scores, nb.unseen, nb.grounded_values, nb.staleness, st, cnt)
    names = ('scores', 'unseen', 'grounded', 'staleness', 'staged_scores',
             'staged_counts')
    err = max(check_diff(f'score_fold {strategy} {name}', a, b,
                         0.0 if name in ('unseen', 'staleness',
                                         'staged_counts') else 1e-6)
              for name, a, b in zip(names, runs[0], want))
    return {'strategy': strategy, **kw, 'T': T, 'N': N, 'S': S,
            'seeds_scored': int((nb.unseen != buf.unseen).sum()),
            'staged': int((cnt > 0).sum()), 'max_abs_err': err,
            'identical_runs': True}


# B8 (b)'s weights against the twin: a few float32 ulps of each weight
# (most weights of a rank transform at a low temperature are far below
# any useful absolute tolerance; the kernel differs from the twin at most
# in powf's last bits).
WEIGHT_RTOL = 4 * 2.0 ** -23


def check_plr_weights(S, device, seed=0, **kw) -> dict:
    """Kernel B8 (b) against ``sample_weights_plain`` within WEIGHT_RTOL of
    each weight (zero weights exactly), and its two runs identical."""
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.level_replay import plr
    cfg = plr.PLRConfig(capacity=S, num_actors=32, **kw)
    buf = plr_buffer(S, device, seed)
    runs = [pk.sample_weights(buf.scores, buf.staleness, buf.unseen, cfg)
            for _ in range(2)]
    check_diff('sample_weights second run', *runs)
    want = plr.sample_weights_plain(buf, cfg)
    e = check_diff(f'sample_weights {kw}', runs[0], want, rtol=WEIGHT_RTOL)
    rel = ((runs[0].double() - want.double()).abs()
           / want.double().abs().clamp_min(1e-300)).max()
    return {**kw, 'S': S, 'max_abs_err': e, 'max_rel_err': float(rel),
            'smallest_nonzero_weight': float(want[want > 0].min()),
            'identical_runs': True}


def check_plr_promote(S, N, device, filled, seed=0, **kw) -> dict:
    """Kernel B8 (c) against ``promote_staged_plain``: levels, ids, masks
    and counters exact, scores within 1e-6, the kernel's two runs
    identical."""
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.level_replay import plr
    cfg = plr.PLRConfig(capacity=S, num_actors=N, score_transform='rank',
                        temperature=0.1, alpha=0.5, **kw)
    buf = plr_buffer(S, device, seed, filled)
    staged = plr_staged(buf, N, device, seed)
    runs = [pk.promote(buf, cfg, *staged) for _ in range(2)]
    want = plr.promote_staged_plain(buf, cfg, *staged)
    err = 0.0
    for f in pk.PROMOTE_FIELDS:
        check_diff(f'promote {f} second run', runs[0][f], runs[1][f])
        e = check_diff(f'promote {f}', runs[0][f], getattr(want, f),
                       1e-6 if f == 'scores' else 0.0)
        err = max(err, e)
    return {'S': S, 'N': N, 'filled': filled, **kw,
            'accepted': int(want.next_id - buf.next_id),
            'duplicates_folded': int(((want.unseen == 0) & (buf.unseen > 0)
                                      & buf.filled).sum()),
            'max_abs_err': err, 'identical_runs': True}


def check_plr(device) -> dict:
    """Kernel B8's three entry points at the main path's S = 4000, T = 256,
    N = 32: the fold for every kernel strategy (and dense rewards, alpha
    0.5, a max-score mix, staleness off), the weights for each kernel
    transform with and without the staleness mix, the promotion into
    empty, part-filled and full buffers and with more staged levels than
    free slots."""
    from dcd_isaac_tpu_torch.kernels import plr as pk
    folds = [check_plr_fold(MAIN_T, MAIN_N, PLR_S, device, s, seed=k)
             for k, s in enumerate(sorted(pk.FOLD_STRATEGIES))]
    for k, kw in enumerate((
            dict(strategy='grounded_signed_value_loss',
                 use_dense_rewards=True),
            dict(strategy='positive_value_loss', alpha=0.5),
            dict(strategy='value_l1', max_score_coef=0.5),
            dict(strategy='grounded_signed_value_loss', staleness_coef=0.0))):
        folds.append(check_plr_fold(MAIN_T, MAIN_N, PLR_S, device,
                                    seed=20 + k, **kw))
    weights = [check_plr_weights(PLR_S, device, seed=k, score_transform=t,
                                 temperature=temp, staleness_transform=st,
                                 staleness_coef=c)
               for k, (t, temp, st, c) in enumerate((
                   ('rank', 0.1, 'power', 0.3), ('rank', 0.3, 'power', 0.3),
                   ('rank', 1.0, 'power', 0.3),
                   ('power', 0.3, 'rank', 0.3), ('rank', 0.3, 'power', 0.0),
                   ('power', 1.0, 'power', 0.0),
                   ('constant', 1.0, 'power', 0.3)))]
    promotes = [check_plr_promote(PLR_S, MAIN_N, device, f, seed=k, **kw)
                for k, (f, kw) in enumerate((
                    (0.0, {}), (0.5, {}), (1.0, {}),
                    (0.5, dict(seed_buffer_priority='score')),
                    (0.5, dict(reject_unsolvable=True)),
                    (0.5, dict(dedup=False))))]
    promotes.append(check_plr_promote(PLR_S, 2000, device, 0.7, seed=9))
    if not (sum(c['seeds_scored'] for c in folds)
            and sum(c['staged'] for c in folds)
            and sum(c['duplicates_folded'] for c in promotes)):
        raise AssertionError('the B8 checks scored, staged or folded nothing')
    return {'fold': folds, 'weights': weights, 'promote': promotes}


def check_multigrid_edit(device) -> dict:
    """Kernel B9 against its plain twins, bit for bit: ``mutate`` with 5
    and 40 edits for each editor action set and ``reset_random`` on four
    env variants, at N = 32 and 4096."""
    import torch
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels import multigrid_edit as me
    out = {'mutate': [], 'reset_random': []}
    err = {'mutate': 0.0, 'reset_random': 0.0}
    for k, name in enumerate(EDIT_ENVS):
        env = make_env(name)
        p = env.params
        for n in (MAIN_N, 4096):
            g = torch.Generator(device=device)
            g.manual_seed(k * 7 + n)
            u = torch.rand((n, me.reset_random_draws(p)), generator=g,
                           device=device)
            got, want = me.reset_random(u, p), me.reset_random_plain(u, p)
            err['reset_random'] = max(
                err['reset_random'],
                *(check_diff(f'{name} reset_random output {i}', a, b)
                  for i, (a, b) in enumerate(zip(got, want))))
            out['reset_random'].append({'env': name, 'n': n,
                                        'mean_walls': float(got[4].float()
                                                            .mean())})
            state, _ = env.reset_random(n, draws=u)
            for edits in (5, 40):
                um = torch.rand((n, me.mutate_draws(edits)), generator=g,
                                device=device)
                args = (state.grid, state.goal_pos, state.agent_start_pos,
                        um, edits, p.editor_actions)
                got, want = me.mutate(*args), me.mutate_plain(*args)
                err['mutate'] = max(
                    err['mutate'],
                    *(check_diff(f'{name} mutate output {i}', a, b)
                      for i, (a, b) in enumerate(zip(got, want))))
                out['mutate'].append({
                    'env': name, 'editor_actions': p.editor_actions, 'n': n,
                    'edits': edits,
                    'goals_moved': int((got[1] != state.goal_pos).any(1)
                                       .sum())})
    if not all(c['goals_moved'] for c in out['mutate'] if c['edits'] == 40
               and c['editor_actions'] != 'walls_none'):
        raise AssertionError('mutate moved no goal')
    out['max_abs_err'] = err
    return out


def check_accel_against_cpu(device) -> dict:
    """A small ACCEL sequence (N = 8, T = 16, S = 64, LSTM-32, 6-step
    episodes): a generate cycle, then a replay cycle with its edit cycle,
    on the card and on the CPU from the same weights, levels, actions,
    replay seeds and draws, edits and permutations.  The buffers must agree
    (levels, ids and masks exactly, floats within 1e-5) and so must the
    weight changes (1e-5), with a change beyond that."""
    import numpy as np
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
        AdversarialMultiGrid,
    )
    from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
    from dcd_isaac_tpu_torch.kernels import multigrid_edit as me
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    n, t, S = 8, 16, 64
    args = parser.parse_args(ACCEL_ARGS + [
        '--num_processes', str(n), '--num_steps', str(t),
        '--recurrent_hidden_size', '32', '--level_replay_seed_buffer_size',
        str(S)])
    env = AdversarialMultiGrid(MultiGridParams(
        size=15, n_clutter=0, choose_goal_last=True, max_steps=6,
        editor_actions='walls_none_goal'))
    gen = torch.Generator().manual_seed(0)
    st, _ = env.reset_random(n, gen, 'cpu')
    levels = env.get_level(st)
    rng = np.random.default_rng(0)
    acts = [torch.tensor(rng.integers(0, 3, (t, n))) for _ in range(3)]
    perms = [torch.stack([torch.randperm(n, generator=gen)
                          for _ in range(args.ppo_epoch)]) for _ in range(3)]
    u = torch.rand((n, me.mutate_draws(args.num_edits)), generator=gen)
    out = []
    for dev in ('cpu', device):
        net = make_model(args, env, generator=torch.Generator().manual_seed(1))
        before = weights({'agent': net})
        runner = AdversarialRunner(args, env, {'agent': net.to(dev)}, dev)
        script = lambda a: (lambda logits, k: a[k].to(dev))
        runner.run(levels=levels.to(dev), replay=False,
                   sample_action_fn=script(acts[0]),
                   perms={'agent': perms[0].to(dev)})
        filled = runner.plr_buffer.filled.nonzero().flatten().cpu()
        seeds = filled[torch.arange(n) % filled.numel()]
        resets = filled[(torch.arange(t * n) * 7) % filled.numel()].view(t, n)
        stats = runner.run(
            replay=True, replay_seeds=seeds.to(dev),
            replay_reset_seeds=lambda k: resets[k].to(dev),
            sample_action_fn=script(acts[1]), edit_coin=0.0,
            mutation_draws=u.to(dev), edit_sample_fn=script(acts[2]),
            perms={'agent': perms[1].to(dev),
                   'agent_edit': perms[2].to(dev)})
        buf = {f: getattr(runner.plr_buffer, f).cpu()
               for f in ('levels', 'scores', 'unseen', 'filled', 'staleness',
                         'grounded_values', 'num_edits', 'slot_ids',
                         'next_id', 'sample_count')}
        out.append((stats, buf, weights({'agent': net})))
    (cpu_stats, cpu_buf, cpu_after), (card_stats, card_buf, card_after) = out
    res = compare_weight_changes(before, cpu_after, card_after)['agent']
    err = max(check_diff(f'card ACCEL buffer {f} against the CPU', a,
                         cpu_buf[f], 1e-5 if a.is_floating_point() else 0.0)
              for f, a in card_buf.items())
    if card_stats['total_num_edits'] != 1 or int(card_buf['num_edits'].max()) < 1:
        raise AssertionError('the ACCEL sequence made no edit')
    return {**res, 'buffer_max_abs_err': err,
            'filled': int(card_buf['filled'].sum()),
            'max_score': [cpu_stats['max_score'], card_stats['max_score']]}


def fill_plr_buffer(runner) -> float:
    """Promote random-design levels (random scores, one completed episode
    each) into the runner's buffer, and REPAIRED's antagonist's, until each
    is filled to rho; returns the protagonist's proportion filled."""
    import torch
    from dcd_isaac_tpu_torch.level_replay import plr
    cfg = runner.plr_cfg
    n = runner.args.num_processes
    g = torch.Generator(device=runner.device)
    g.manual_seed(5)
    for attr in ('plr_buffer', 'plr_antagonist'):
        while (getattr(runner, attr) is not None and float(
                plr.proportion_filled(getattr(runner, attr))) < cfg.rho):
            states = runner._random_design()
            setattr(runner, attr, plr.promote_staged(
                getattr(runner, attr), cfg, runner.env.get_level(states),
                torch.rand((n,), generator=g, device=runner.device),
                torch.ones((n,), device=runner.device),
                staged_solvable=states.passable))
    return float(plr.proportion_filled(runner.plr_buffer))


def policy_inputs(B, device, seed=0):
    """Kernel B2's inputs at the main path's widths: the weights of a
    freshly built student (LSTM-256) with every entry moved by noise, so
    the biases are not zero; random views, directions, carries, masks
    (about one in ten 0), uniforms and actions."""
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    env = make_env(ENV_NAME)
    net = make_model(parser.parse_args(PAIRED_ARGS), env, 'agent',
                     torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    net = net.to(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    H = net.recurrent_hidden_size
    x = {'image': torch.randint(0, 11, (B, 5, 5, 3), generator=g,
                                device=device, dtype=torch.uint8),
         'direction': torch.randint(0, 4, (B,), generator=g, device=device,
                                    dtype=torch.int32),
         'c': torch.randn((B, H), generator=g, device=device),
         'h': torch.randn((B, H), generator=g, device=device),
         'mask': (torch.rand((B,), generator=g, device=device) > 0.1).float(),
         'u': torch.rand((B,), generator=g, device=device),
         'action': torch.randint(0, 7, (B,), generator=g, device=device)}
    with torch.no_grad():
        w = net.policy_weights()
    return w, x


def check_policy_step(B, device) -> dict:
    """Kernel B2 against its twin on the card in its four modes: logits,
    value, carry and log-probs within 1e-5 relative (|a - b| <= 1e-5 (|b|
    + max|b|): each output sums up to 405 fp32 products in another order
    than cuBLAS and cuDNN); the sampled actions equal wherever the twin's
    CDF is more than 1e-5 from the uniform (the rows nearer are counted)."""
    import torch
    from dcd_isaac_tpu_torch.kernels.policy_step import (
        MODES, policy_step, policy_step_plain,
    )
    w, x = policy_inputs(B, device)
    args = (x['image'], x['direction'], x['c'], x['h'], x['mask'], w)
    err = rel = 0.0
    near = 0
    with torch.no_grad():
        for mode in MODES:
            kw = {'u': x['u']} if mode == 'sample' else (
                {'action': x['action']} if mode == 'action' else {})
            got = policy_step(*args, mode, **kw)
            want = policy_step_plain(*args, mode, **kw)
            torch.cuda.synchronize()
            for name, a, b in zip(got._fields, got, want):
                if (a is None) != (b is None):
                    raise AssertionError(f'policy_step {mode}: {name} '
                                         f'written by one side only')
                if a is None:
                    continue
                if name == 'action':
                    cdf = torch.softmax(want.logits.double(), -1).cumsum(-1)
                    clear = ((cdf - x['u'].double()[:, None]).abs()
                             .min(-1).values > 1e-5)
                    near += int((~clear).sum()) if mode == 'sample' else 0
                    if not torch.equal(a[clear], b[clear]):
                        raise AssertionError(f'policy_step {mode}: actions '
                                             f'differ')
                    continue
                for t_a, t_b in (zip(a, b) if name == 'carry' else [(a, b)]):
                    d = (t_a - t_b).abs()
                    tol = 1e-5 * (t_b.abs() + t_b.abs().max())
                    if not (d <= tol).all():
                        top = float(t_b.abs().max())
                        raise AssertionError(
                            f'policy_step {mode} B={B}: {name} off by '
                            f'{float(d.max())} (largest {top})')
                    err = max(err, float(d.max()))
                    rel = max(rel, float((d / t_b.abs().max()).max()))
    return {'B': B, 'max_abs_err': err, 'max_err_of_largest': rel,
            'rows_within_1e-5_of_a_cdf_entry': near}


def teacher_backward_inputs(batch, n_out, device, seed=0):
    """B4's backward inputs: ``teacher_inputs`` with W the recurrent
    teacher's LSTM input (N = 1024) or, from a freshly built
    mg_25b_repaired teacher (no core), its stacked first trunk layers
    (N = 64), and a random upstream gradient."""
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    img, conv_w, conv_b, e, w_i = teacher_inputs(batch, device, seed)
    if n_out == 64:
        t = make_model(parser.parse_args(REPAIRED_ARGS), make_env(ENV_NAME),
                       'adversary_env', torch.Generator().manual_seed(seed))
        w_i = torch.cat([t.actor_trunk[0].weight, t.critic_trunk[0].weight]
                        ).detach().to(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 3)
    grad = torch.randn((batch, w_i.shape[0]), generator=g, device=device)
    return img, conv_w, conv_b, e, w_i, grad


def check_teacher_proj_backward(batch, n_out, device) -> dict:
    """B4's backward kernels against the twin (the chunked autograd
    backward) on the card, dW and g_e within 1e-5 of the twin's largest
    entry plus 1e-5 relative (sums of up to 425 984 rows or 21 692
    products, as B7's gradients are tied to their scale); the conv
    gradients the same against the twin with the kernels' ReLU'
    (``kernel_conv_grads``); ``twin_gap`` is the gap to the twin itself
    and ``flips_part`` what the ReLU' flips alone move.  Two runs give the
    same bits."""
    import torch
    from dcd_isaac_tpu_torch.kernels import teacher_proj as tp
    args = teacher_backward_inputs(batch, n_out, device)
    got = tp._launch_backward(*args)
    again = tp._launch_backward(*args)
    want = tp.teacher_proj_backward_plain(*args)
    *ref_conv, witness = kernel_conv_grads(*args)
    torch.cuda.synchronize()
    res = {'B': batch, 'N': n_out, 'relu_mask': witness}
    for name, a, a2, b, twin in zip(('conv_w', 'conv_b', 'e', 'w_i'), got,
                                    again, (*ref_conv, *want[2:]), want):
        if not torch.equal(a, a2):
            raise AssertionError(f'teacher_proj backward {name}: two runs '
                                 f'differ')
        d = (a - b).abs()
        top = float(b.abs().max())
        if not (d <= 1e-5 * top + 1e-5 * b.abs()).all():
            raise AssertionError(f'teacher_proj backward B={batch} '
                                 f'N={n_out}: {name} off by {float(d.max())}'
                                 f' (largest {top})')
        res[name] = {'max_abs_err': float(d.max()), 'max_abs': top,
                     'twin_gap': float((a - twin).abs().max()),
                     'flips_part': float((b - twin).abs().max())}
    res['max_abs_err'] = max(v['max_abs_err'] for k, v in res.items()
                             if k in ('conv_w', 'conv_b', 'e', 'w_i'))
    return res


def check_repaired_against_cpu(device) -> dict:
    """A small REPAIRED sequence (generate, replay, generate; N = 8, T =
    16, S = 64, LSTM-32 students, the teacher without a core, 6-step
    episodes) and one minimax cycle, on the card and on the CPU from the
    same weights, teacher moves and draws, actions, replay seeds and
    permutations.  Both buffers must agree (levels, ids and masks exactly,
    floats within 1e-5) and so must every model's weight change (1e-5),
    with a change beyond that."""
    import numpy as np
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.multigrid.adversarial import (
        AdversarialMultiGrid,
    )
    from dcd_isaac_tpu_torch.envs.multigrid.core import MultiGridParams
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_all_models
    n, t, S = 8, 16, 64
    small = ['--num_processes', str(n), '--num_steps', str(t),
             '--recurrent_hidden_size', '32']
    env = AdversarialMultiGrid(MultiGridParams(
        size=15, n_clutter=25, choose_goal_last=True, max_steps=6))
    T = env.adversary_rollout_steps
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.tensor(rng.random(s), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    students = ('agent', 'adversary_agent')
    cycles = []
    for _ in range(3):
        cycles.append({
            'moves': torch.tensor(near_goal_moves(rng, n)),
            'u': f32(T, n, 3), 'z': f32(T, n, 50),
            'reset': {'start_dir': torch.tensor(rng.integers(0, 4, n)),
                      'random_z': f32(n, 50)},
            'acts': {r: torch.tensor(rng.integers(0, 3, (t, n)))
                     for r in students},
            'perms': {**{r: torch.stack([torch.randperm(n, generator=gen)
                                         for _ in range(5)])
                         for r in students},
                      'adversary_env': torch.stack([
                          torch.randperm(T * n, generator=gen)
                          for _ in range(5)])}})

    def inject(c, dev, roles):
        script = lambda a: (lambda logits, k: a[k].to(dev))
        kw = dict(
            sample_action_fn=script(c['acts']['agent']),
            teacher_sample_fn=script(c['moves']),
            teacher_draws_fn=lambda k: {'u': c['u'][k].to(dev),
                                        'random_z': c['z'][k].to(dev)},
            reset_draws={k: v.to(dev) for k, v in c['reset'].items()},
            perms={r: p.to(dev) for r, p in c['perms'].items()
                   if r in roles})
        if 'adversary_agent' in roles:
            kw['antagonist_sample_fn'] = script(c['acts']['adversary_agent'])
        return kw

    def replay_draws(buf, stride):
        filled = buf.filled.nonzero().flatten().cpu()
        seeds = filled[torch.arange(n) % filled.numel()]
        resets = filled[(torch.arange(t * n) * stride)
                        % filled.numel()].view(t, n)
        return seeds, resets

    res = {}
    for name, argv in (('repaired', REPAIRED_ARGS), ('minimax',
                                                     MINIMAX_ARGS)):
        args = parser.parse_args(argv + small + [
            '--level_replay_seed_buffer_size', str(S)])
        out = []
        for dev in ('cpu', device):
            models = {r: m.to(dev) for r, m in make_all_models(
                args, env, torch.Generator().manual_seed(1)).items()}
            before = weights(models)
            runner = AdversarialRunner(args, env, models, dev)
            stats = []
            kinds = ('generate', 'replay', 'generate') if name == 'repaired' \
                else ('generate',)
            for c, kind in zip(cycles, kinds):
                kw = inject(c, dev, models)
                if name == 'repaired':
                    kw['replay'] = kind == 'replay'
                if kind == 'replay':
                    sa, ra = replay_draws(runner.plr_buffer, 7)
                    sb, rb = replay_draws(runner.plr_antagonist, 5)
                    kw.update(
                        replay_seeds=sa.to(dev),
                        replay_reset_seeds=lambda k: ra[k].to(dev),
                        antagonist_replay_seeds=sb.to(dev),
                        antagonist_replay_reset_seeds=lambda k: rb[k].to(dev))
                stats.append(runner.run(**kw))
            bufs = {}
            for attr in ('plr_buffer', 'plr_antagonist'):
                buf = getattr(runner, attr)
                if buf is not None:
                    bufs[attr] = {f: getattr(buf, f).cpu() for f in (
                        'levels', 'scores', 'unseen', 'filled', 'staleness',
                        'grounded_values', 'slot_ids', 'next_id',
                        'sample_count')}
            out.append((stats, bufs, weights(models)))
        (cpu_stats, cpu_bufs, cpu_after), (card_stats, card_bufs,
                                           card_after) = out
        r = compare_weight_changes(before, cpu_after, card_after)
        r['buffer_max_abs_err'] = max([check_diff(
            f'card {name} {attr} {f} against the CPU', a, cpu_bufs[attr][f],
            1e-5 if a.is_floating_point() else 0.0)
            for attr, fields in card_bufs.items()
            for f, a in fields.items()] or [0.0])
        r['filled'] = {attr: int(b['filled'].sum())
                       for attr, b in card_bufs.items()}
        r['mean_env_return'] = [[s['mean_env_return'] for s in cpu_stats],
                                [s['mean_env_return'] for s in card_stats]]
        if name == 'repaired' and [s['level_replay']
                                   for s in card_stats] != [0, 1, 0]:
            raise AssertionError('repaired_vs_cpu: not generate, replay, '
                                 'generate')
        res[name] = r
    return res


def time_plr_kernels(device) -> dict:
    """Kernels B8 and B9 at the main path's shapes (T = 256, N = 32,
    S = 4000), with their plain twins and bounds.  Bytes: what the function
    must move with the buffer updated in place, as the JAX runner's donated
    state is: the fold reads the rollout and reads and writes the four
    fields of the seeds this rollout touches; the weights read three
    fields and write one; the promotion reads every level (the hash) and
    the eviction order's fields, the staged levels, and writes the slots
    this run's data accepts or folds a duplicate into.  Operations: a
    sort's S log2 S comparisons for the rank, ~20 a step for the fold, two
    hash lanes over every level byte."""
    import math as m
    import torch
    from dcd_isaac_tpu_torch.envs.registry import make_env
    from dcd_isaac_tpu_torch.kernels import multigrid_edit as me
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.level_replay import plr
    T, N, S = MAIN_T, MAIN_N, PLR_S
    cfg = plr.PLRConfig(capacity=S, num_actors=N,
                        strategy='grounded_signed_value_loss',
                        score_transform='rank', temperature=0.1)
    buf = plr_buffer(S, device)
    ro = plr_rollout(T, N, S, device)
    staged = plr_staged(buf, N, device)
    L = buf.levels[0].numel()
    out = {}
    fold_args = (ro.rewards, ro.values, ro.returns, ro.dones, ro.cliffhangers,
                 ro.level_seeds, buf.scores, buf.unseen, buf.grounded_values,
                 buf.staleness, cfg, S)
    seeds = ro.level_seeds
    touched = int(torch.unique(seeds[(seeds >= 0) & (seeds < S)]).numel())
    b = bound(T * N * 18 + 2 * 16 * touched + N * 8, 20 * T * N)
    out['plr_score_fold'] = {'seeds_touched': touched,
        'ms': graph_ms(lambda: pk.score_fold(*fold_args), 20),
        'plain_ms': device_ms(lambda: plr.update_with_rollout_plain(
            buf, cfg, ro, ro.returns, ro.values), 1, 5),
        'bound_ms': b[0], 'bound_by': b[1]}
    b = bound(S * 16, S * m.log2(S) + 8 * S)
    out['plr_sample_weights'] = {
        'ms': graph_ms(lambda: pk.sample_weights(
            buf.scores, buf.staleness, buf.unseen, cfg), 20),
        'plain_ms': device_ms(lambda: plr.sample_weights_plain(buf, cfg), 1,
                              10),
        'bound_ms': b[0], 'bound_by': b[1]}
    want = plr.promote_staged_plain(buf, cfg, *staged)
    accepted = int(want.next_id - buf.next_id)
    folded = int(((want.slot_ids == buf.slot_ids)
                  & ((want.scores != buf.scores) | (want.unseen != buf.unseen)
                     | (want.staleness != buf.staleness))).sum())
    # levels and 4 + 4 + 1 + 4 bytes a slot read (scores, unseen, filled,
    # staleness for the replay-support order); a slot's L + 26 bytes
    # written, or 12 (scores, unseen, staleness) for a duplicate's fold
    b = bound(S * (L + 13) + N * (L + 13) + accepted * (L + 26)
              + folded * 12 + 8,
              2 * 2 * S * L + 2 * N * S + S * m.log2(S))
    out['plr_promote'] = {'slots_written': accepted,
                          'duplicates_folded': folded,
        'ms': graph_ms(lambda: pk.promote(buf, cfg, *staged), 20),
        'plain_ms': device_ms(lambda: plr.promote_staged_plain(
            buf, cfg, *staged), 1, 10),
        'bound_ms': b[0], 'bound_by': b[1]}
    env = make_env('MultiGrid-GoalLastEmptyAdversarialEnv-Edit-v0')
    p = env.params
    g = torch.Generator(device=device)
    g.manual_seed(3)
    state, _ = env.reset_random(N, g, device)
    um = torch.rand((N, me.mutate_draws(5)), generator=g, device=device)
    margs = (state.grid, state.goal_pos, state.agent_start_pos, um, 5,
             p.editor_actions)
    cells = p.width * p.height
    b = bound(N * (cells + 16 + 4 * me.mutate_draws(5) + cells + 20), 0)
    out['multigrid_mutate'] = {
        'ms': graph_ms(lambda: me.mutate(*margs), 200),
        'plain_ms': device_ms(lambda: me.mutate_plain(*margs), 1, 20),
        'bound_ms': b[0], 'bound_by': b[1]}
    p25 = make_env(ENV_NAME).params
    ur = torch.rand((N, me.reset_random_draws(p25)), generator=g,
                    device=device)
    b = bound(N * (4 * me.reset_random_draws(p25) + cells + 24), 0)
    out['multigrid_reset_random'] = {
        'ms': graph_ms(lambda: me.reset_random(ur, p25), 200),
        'plain_ms': device_ms(lambda: me.reset_random_plain(ur, p25), 1, 20),
        'bound_ms': b[0], 'bound_by': b[1]}
    return out


# -- the walker (slice 5) ---------------------------------------------------

# bipedal_accel.json without --checkpoint and --archive_interval (the
# entry-points slice): N = 16, T = 2048, the MLP student, 5 epochs of 32
# minibatches, VecNormalize, PLR⊥ (S = 1000) and ACCEL (3 edits, easy
# parents).
WALKER_N, WALKER_T, WALKER_S = 16, 2048, 1000
WALKER_COMMON = [
    '--ued_algo', 'domain_randomization', '--num_processes', str(WALKER_N),
    '--num_steps', str(WALKER_T), '--ppo_epoch', '5',
    '--num_mini_batch', '32', '--normalize_returns', 'true',
    '--recurrent_agent', 'false', '--recurrent_adversary_env', 'false',
    '--recurrent_hidden_size', '1', '--lr', '3e-4', '--max_grad_norm', '0.5',
    '--gamma', '0.99', '--gae_lambda', '0.9', '--value_loss_coef', '0.5',
    '--entropy_coef', '0.001', '--adv_entropy_coef', '0.01',
    '--clip_value_loss', 'false', '--clip_param', '0.2',
    '--handle_timelimits', 'true', '--use_plr', 'true',
    '--level_replay_strategy', 'positive_value_loss',
    '--level_replay_score_transform', 'rank', '--level_replay_rho', '0.5',
    '--level_replay_seed_buffer_size', str(WALKER_S), '--staleness_coef',
    '0.5', '--log_plr_buffer_stats', 'true', '--log_replay_complexity',
    'true', '--log_grad_norm', 'true', '--seed', '1']
BIPEDAL_ACCEL_ARGS = WALKER_COMMON + [
    '--env_name', 'BipedalWalker-Adversarial-Easy-v0',
    '--level_replay_prob', '0.9', '--no_exploratory_grad_updates', 'true',
    '--use_editor', 'true', '--level_editor_prob', '1.0',
    '--level_editor_method', 'random', '--num_edits', '3',
    '--base_levels', 'easy']
BIPEDAL_ROBUST_PLR_ARGS = WALKER_COMMON + [
    '--env_name', 'BipedalWalker-Adversarial-v0',
    '--level_replay_prob', '0.5', '--no_exploratory_grad_updates', 'true']
BIPEDAL_DR_ARGS = WALKER_COMMON + [
    '--env_name', 'BipedalWalker-Adversarial-v0',
    '--level_replay_prob', '0.0', '--no_exploratory_grad_updates', 'false']
BIPEDAL_POET_ARGS = BIPEDAL_ACCEL_ARGS + [
    '--env_name', 'BipedalWalker-POET-Easy-v0']
# one level of each terrain kind: (roughness, pit lo, pit hi, stump lo,
# stump hi, stair lo, stair hi, stair steps)
WALKER_KINDS = {
    'flat': [0, 0, 0, 0, 0, 0, 0, 1], 'rough': [6.0, 0, 0, 0, 0, 0, 0, 1],
    'stump': [1.0, 0, 0, 0.5, 2.0, 0, 0, 1],
    'stair': [0.5, 0, 0, 0, 0, 0.5, 1.5, 6.4],
    'pit': [0.5, 1.0, 4.0, 0, 0, 0, 0, 1]}
WALKER_STEP_ATOL = 1e-4


def walker_levels(n, device, seed=0):
    """n (9,) walker levels cycling through WALKER_KINDS, with random seeds
    in [0, 2^24)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kinds = torch.tensor(list(WALKER_KINDS.values()), dtype=torch.float32,
                         device=device)
    params = kinds[torch.arange(n, device=device) % len(kinds)]
    s = torch.randint(0, 1 << 24, (n,), generator=g, device=device)
    return torch.cat([params, s.float()[:, None]], 1)


def range_levels(n, ranges, poet, device, seed=0):
    """n levels uniform over a walker env's param ranges (POET: params 5-7
    zero), with random seeds: what reset_random draws."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = torch.tensor(ranges, dtype=torch.float32, device=device)
    u = torch.rand((n, 8), generator=g, device=device)
    params = u * (r[:, 1] - r[:, 0]) + r[:, 0]
    if poet:
        params[:, 5:] = 0.0
    s = torch.randint(0, 1 << 24, (n,), generator=g, device=device)
    return torch.cat([params, s.float()[:, None]], 1)


def check_walker_terrain(device) -> dict:
    """Kernel B11 against its twins (``generate_terrain`` of the seeds'
    hashed draws, ``place_walker``), bit for bit: 1024 levels each from the
    full, easy and POET ranges and the five terrain kinds."""
    import torch
    from dcd_isaac_tpu_torch.envs.walker.adversarial import (
        PARAM_RANGES_EASY, PARAM_RANGES_FULL,
    )
    from dcd_isaac_tpu_torch.envs.walker.env import (
        place_walker, placement_draw,
    )
    from dcd_isaac_tpu_torch.envs.walker.terrain import (
        generate_terrain, terrain_draws,
    )
    from dcd_isaac_tpu_torch.kernels import walker_terrain
    sets = {'full': range_levels(1024, PARAM_RANGES_FULL, False, device, 1),
            'easy': range_levels(1024, PARAM_RANGES_EASY, False, device, 2),
            'poet': range_levels(1024, PARAM_RANGES_FULL, True, device, 3),
            'kinds': walker_levels(1024, device, 4)}
    out, err = {}, 0.0
    for name, lv in sets.items():
        params, seeds = lv[:, :8].contiguous(), lv[:, 8].int().contiguous()
        terr, bodies = walker_terrain.generate(params, seeds)
        want_t = generate_terrain(params, terrain_draws(seeds))
        want_b = place_walker(placement_draw(seeds))
        for f in ('xs', 'ys', 'boxes', 'n_boxes'):
            err = max(err, check_diff(f'walker_terrain {name} {f}',
                                      getattr(terr, f), getattr(want_t, f)))
        for f in ('pos', 'angle', 'vel', 'angvel'):
            err = max(err, check_diff(f'walker_terrain {name} bodies {f}',
                                      getattr(bodies, f),
                                      getattr(want_b, f)))
        out[name] = {'levels': lv.shape[0],
                     'mean_boxes': float(terr.n_boxes.float().mean()),
                     'full_budget': int((terr.n_boxes == 64).sum())}
    if not out['full']['mean_boxes'] > 0:
        raise AssertionError('walker_terrain: the full range made no boxes')
    return {'max_abs_err': err, 'sets': out}


def on_first_box(state, which):
    """``state`` with the walkers where ``which`` (N,) moved, all bodies
    together, so that the left lower leg stands centred on the level's
    first box (a stump, a stair's tread or a pit's wall), its lowest corner
    1 cm deep: states whose contacts are with boxes, which a walk from the
    start (x = 4.7 m; no obstacle before x = 9.3 m) seldom reaches."""
    import dataclasses
    import torch
    from dcd_isaac_tpu_torch.envs.walker.physics import world_vertices
    b = state.bodies
    foot = world_vertices(b)[:, 2, :4]                      # (N, 4, 2)
    box = state.terrain.boxes[:, 0]
    shift = torch.stack([(box[:, 0] + box[:, 2]) / 2 - foot[..., 0].mean(1),
                         box[:, 3] - 0.01 - foot[..., 1].amin(1)], -1)
    shift = torch.where(which[:, None], shift, torch.zeros_like(shift))
    return state.replace(bodies=dataclasses.replace(
        b, pos=b.pos + shift[:, None, :]))


def check_walker_step(n, steps, device) -> dict:
    """Kernel B10 against its twin (``step_walker_plain``) one step at a
    time from the states of a random walk of n walkers over the five
    terrain kinds (reset when an episode ends), every other walker of a
    level with boxes starting on its first box (``on_first_box``): every
    float output within WALKER_STEP_ATOL (the card's cosf and sinf against
    torch's; the solver is chaotic, so the two are compared one step from
    the same state, never along a trajectory), the contact flags, done and
    finish exact.  Fails unless some steps start with a foot on the
    ground, with a vertex in a box, and some end an episode."""
    import torch
    from dcd_isaac_tpu_torch.envs.walker.adversarial import (
        AdversarialWalker, WalkerParams,
    )
    from dcd_isaac_tpu_torch.envs.walker.env import step_walker_plain
    from dcd_isaac_tpu_torch.envs.walker.physics import contact_candidates
    from dcd_isaac_tpu_torch.kernels import walker_step
    env = AdversarialWalker(WalkerParams())
    levels = walker_levels(n, device, 5)
    start, _ = env.reset_to_level(levels)
    start = on_first_box(start, (start.terrain.n_boxes > 0)
                         & (torch.arange(n, device=device) % 2 == 0))
    state = start
    g = torch.Generator(device=device)
    g.manual_seed(6)
    err = {'state': 0.0, 'obs': 0.0, 'reward': 0.0}
    contacts = dones = boxed = 0
    for _ in range(steps):
        a = torch.rand((n, 4), generator=g, device=device) * 2.4 - 1.2
        _, _, pen, on_box = contact_candidates(state.bodies, state.terrain)
        boxed += int((on_box & (pen > 0)).sum())
        got = walker_step.step(state, a)
        want = step_walker_plain(state, a)
        for f in ('pos', 'angle', 'vel', 'angvel'):
            err['state'] = max(err['state'], check_diff(
                f'walker_step {f}', getattr(got[0].bodies, f),
                getattr(want[0].bodies, f), WALKER_STEP_ATOL))
        for f in ('joint_angle', 'joint_speed', 'prev_shaping'):
            err['state'] = max(err['state'], check_diff(
                f'walker_step {f}', getattr(got[0], f), getattr(want[0], f),
                WALKER_STEP_ATOL))
        for f in ('lower_contact', 'game_over', 'step_count'):
            check_diff(f'walker_step {f}', getattr(got[0], f),
                       getattr(want[0], f))
        err['obs'] = max(err['obs'], check_diff(
            'walker_step obs', got[1], want[1], WALKER_STEP_ATOL))
        err['reward'] = max(err['reward'], check_diff(
            'walker_step reward', got[2], want[2], WALKER_STEP_ATOL))
        check_diff('walker_step done', got[3], want[3])
        check_diff('walker_step finish', got[4], want[4])
        contacts += int(got[0].lower_contact.sum())
        dones += int(got[3].sum())
        state = start.where(got[3], got[0])
    if not (contacts and dones and boxed):
        raise AssertionError(f'walker_step: {contacts} foot contacts, '
                             f'{boxed} box contacts, {dones} ended episodes')
    return {'n': n, 'steps': steps, 'max_abs_err': max(err.values()),
            'errors': err, 'foot_contacts': contacts, 'box_contacts': boxed,
            'episodes_ended': dones, 'atol': WALKER_STEP_ATOL}


def gauss_inputs(R, device, seed=0):
    """Kernel B7's Gaussian rows: means (R, 4), a shared log-std, actions
    drawn from the Gaussian, a quarter of the rows with the ratio exactly 1
    and the values equal to the old values."""
    import torch
    from dcd_isaac_tpu_torch.models.distributions import normal_log_prob
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    mean, values = rn(R, 4), rn(R)
    log_std = rn(4) * 0.3
    actions = mean + rn(R, 4) * log_std.exp()
    tie = torch.rand((R,), generator=g, device=device) < 0.25
    old_lp = torch.where(tie, normal_log_prob(mean, log_std, actions),
                         normal_log_prob(mean, log_std, actions)
                         + rn(R) * 0.3)
    old_v = torch.where(tie, values, values + rn(R) * 0.3)
    return (mean, log_std, values, actions, old_lp, old_v, values + rn(R),
            rn(R))


def check_ppo_loss_gaussian(R, clip_value_loss, device) -> dict:
    """Kernel B7's Gaussian branch against its twins: the four means within
    1e-6 relative of the twin in float64; dmean, dlog_std and dvalues
    within 1e-5 of the twin's largest entry plus 1e-5 relative (gradients
    of a mean scale as 1/R); bit-identical over two runs."""
    import torch
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        ppo_loss_gaussian, ppo_loss_gaussian_plain,
        ppo_loss_gaussian_plain_backward,
    )
    rows = gauss_inputs(R, device)
    cfg = (0.2, clip_value_loss, 0.5, 0.001)
    upstream = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in rows[:3]]
        out = ppo_loss_gaussian(*leaves, *rows[3:], *cfg)
        runs.append((torch.stack(out).detach(),
                     *torch.autograd.grad(out[0], leaves)))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f'ppo_loss_gaussian R={R}: two runs differ')
    want = torch.stack(ppo_loss_gaussian_plain(
        *[t.double() for t in rows], *cfg))
    torch.testing.assert_close(runs[0][0].double(), want, rtol=1e-6,
                               atol=1e-9)
    grads = {}
    for name, a, b in zip(('dmean', 'dlog_std', 'dvalues'), runs[0][1:],
                          ppo_loss_gaussian_plain_backward(upstream, *rows,
                                                           *cfg)):
        scale = float(b.abs().max())
        if not scale > 0:
            raise AssertionError(f'ppo_loss_gaussian: {name} of the twin 0')
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=1e-5,
                                   msg=lambda m: f'{name}: {m}')
        e = float((a - b).abs().max())
        grads[name] = {'max_abs_err': e, 'max_abs_ref': scale,
                       'max_err_over_ref': e / scale}
    return {'R': R, 'clip_value_loss': clip_value_loss,
            'max_rel_err_means': float(((runs[0][0].double() - want).abs()
                                        / want.abs()).max()),
            'max_abs_err': max(g['max_abs_err'] for g in grads.values()),
            'grads': grads, 'identical_runs': True}


def walker_buffer(S, device, seed=0, filled=0.6, make_levels=None):
    """plr_buffer's fields with (9,) float32 walker levels (every fifth a
    copy of another) in place of the grids; ``make_levels(n, device,
    seed)`` gives other float levels (CarRacing's (28,))."""
    buf = plr_buffer(S, device, seed, filled)
    levels = (make_levels or walker_levels)(S, device, seed)
    copies = list(range(0, S - 1, 5))
    levels[copies] = levels[[c + 1 for c in copies]]
    return buf.replace(levels=levels * buf.filled[:, None])


def walker_staged(buf, N, device, seed=0, make_levels=None):
    """N staged walker (or ``make_levels``) levels: copies of three filled
    slots, a pair of equal ones, the rest new; scores with ties, a fifth
    without a completed episode (plr_staged's mix)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    levels = (make_levels or walker_levels)(N, device, 50 + seed)
    full = buf.filled.nonzero().flatten()
    k = min(3, full.numel(), N - 2)
    levels[:k] = buf.levels[full[:k]]
    levels[-1] = levels[-2]
    scores = torch.round(torch.randn((N,), generator=g, device=device) * 4) / 4
    counts = torch.where(r(N) < 0.8, torch.floor(r(N) * 3) + 1, 0.0)
    return (levels.contiguous(), scores, counts, r(N) < 0.8,
            torch.floor(r(N) * 4 + 1).int())


def check_plr_promote_float(device, S=WALKER_S, N=WALKER_N,
                            make_levels=None, **kw) -> dict:
    """Kernel B8 (c) with float levels against ``promote_staged_plain``:
    levels, ids, masks and counters exact, scores within 1e-6, at the
    walker's S = 1000, N = 16 (or CarRacing's S = 8000 and (28,) levels)
    into part-filled and full buffers, staged copies of buffer levels among
    them (the value-cast hash folds them)."""
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.level_replay import plr
    out = []
    kw = kw or {'score_transform': 'rank', 'staleness_coef': 0.5}
    for k, filled in enumerate((0.3, 1.0)):
        cfg = plr.PLRConfig(capacity=S, num_actors=N, **kw)
        buf = walker_buffer(S, device, k, filled, make_levels)
        args = walker_staged(buf, N, device, k, make_levels)
        runs = [pk.promote(buf, cfg, *args) for _ in range(2)]
        want = plr.promote_staged_plain(buf, cfg, *args)
        err = 0.0
        for f in pk.PROMOTE_FIELDS:
            check_diff(f'promote float {f} second run', runs[0][f],
                       runs[1][f])
            err = max(err, check_diff(f'promote float {f}', runs[0][f],
                                      getattr(want, f),
                                      1e-6 if f == 'scores' else 0.0))
        folded = int(((want.unseen == 0) & (buf.unseen > 0)
                      & buf.filled).sum())
        out.append({'filled': filled, 'max_abs_err': err,
                    'accepted': int(want.next_id - buf.next_id),
                    'duplicates_folded': folded})
    if not sum(c['duplicates_folded'] for c in out):
        raise AssertionError('promote float: no duplicate was folded')
    return {'checks': out, 'max_abs_err': max(c['max_abs_err'] for c in out)}


def check_walker_accel_against_cpu(device) -> dict:
    """A small walker ACCEL sequence (N = 4, T = 16, S = 8, 8-step
    episodes, VecNormalize): a generate cycle, then a replay cycle with its
    edit cycle, on the card and on the CPU from the same weights, levels,
    actions, replay seeds, edits and permutations.  Weight changes within
    1e-5 (and a change beyond it), the buffers' levels, ids and masks exact
    and floats within 1e-5, as ``accel_vs_cpu``."""
    import dataclasses
    import torch
    from dcd_isaac_tpu_torch.arguments import parser
    from dcd_isaac_tpu_torch.envs.walker.adversarial import (
        AdversarialWalker, WalkerParams, mutate_draws,
    )
    from dcd_isaac_tpu_torch.runner.adversarial_runner import (
        AdversarialRunner,
    )
    from dcd_isaac_tpu_torch.utils.make_agent import make_model
    n, t, S = 4, 16, 8
    args = parser.parse_args(BIPEDAL_ACCEL_ARGS + [
        '--num_processes', str(n), '--num_steps', str(t),
        '--num_mini_batch', '2', '--level_replay_seed_buffer_size', str(S)])
    env = AdversarialWalker(WalkerParams(mode='easy', max_steps=8))
    g = torch.Generator().manual_seed(0)
    levels = walker_levels(n, 'cpu', 7)
    levels[:, :8] = torch.tensor([0.3, 0, 0.8, 0, 0.4, 0, 0.4, 1])
    acts = [torch.randn((t, n, 4), generator=g) for _ in range(3)]
    perms = [torch.stack([torch.randperm(t * n, generator=g)
                          for _ in range(args.ppo_epoch)]) for _ in range(3)]
    u = torch.rand((n, mutate_draws(args.num_edits)), generator=g)
    out = []
    for dev in ('cpu', device):
        net = make_model(args, env, generator=torch.Generator().manual_seed(1))
        before = weights({'agent': net})
        runner = AdversarialRunner(args, env, {'agent': net.to(dev)}, dev)
        script = lambda a: (lambda o, k: a[k].to(dev))
        runner.run(levels=levels.to(dev), replay=False,
                   sample_action_fn=script(acts[0]),
                   perms={'agent': perms[0].to(dev)})
        filled = runner.plr_buffer.filled.nonzero().flatten().cpu()
        seeds = filled[torch.arange(n) % filled.numel()]
        resets = filled[(torch.arange(t * n) * 3) % filled.numel()].view(t, n)
        stats = runner.run(
            replay=True, replay_seeds=seeds.to(dev),
            replay_reset_seeds=lambda k: resets[k].to(dev),
            sample_action_fn=script(acts[1]), edit_coin=0.0,
            mutation_draws=u.to(dev), edit_sample_fn=script(acts[2]),
            perms={'agent': perms[1].to(dev),
                   'agent_edit': perms[2].to(dev)})
        buf = {f.name: getattr(runner.plr_buffer, f.name).cpu()
               for f in dataclasses.fields(runner.plr_buffer)
               if not f.name.startswith('tscl')}
        out.append((stats, buf, weights({'agent': net}),
                    [x.cpu() for x in runner.ret_rms]))
    (cpu_stats, cpu_buf, cpu_after, cpu_rms), (
        card_stats, card_buf, card_after, card_rms) = out
    res = compare_weight_changes(before, cpu_after, card_after)['agent']
    err = max(check_diff(f'card walker ACCEL buffer {f} against the CPU', a,
                         cpu_buf[f], 1e-5 if a.is_floating_point()
                         and f != 'levels' else 0.0)
              for f, a in card_buf.items())
    rms_err = max(check_diff('card VecNormalize statistics against the CPU',
                             a, b, 1e-5, 1e-5)
                  for a, b in zip(card_rms, cpu_rms))
    if card_stats['total_num_edits'] != 1 or int(
            card_buf['num_edits'].max()) < 1:
        raise AssertionError('the walker ACCEL sequence made no edit')
    return {**res, 'buffer_max_abs_err': err, 'ret_rms_max_abs_err': rms_err,
            'filled': int(card_buf['filled'].sum()),
            'max_score': [cpu_stats['max_score'], card_stats['max_score']]}


def fill_walker_buffer(runner) -> float:
    """Promote random levels of the runner's env (random scores, one
    completed episode each) into its buffer until it is filled to rho, as
    fill_plr_buffer does for MultiGrid; returns the proportion filled."""
    import torch
    from dcd_isaac_tpu_torch.level_replay import plr
    cfg = runner.plr_cfg
    n = runner.args.num_processes
    g = torch.Generator(device=runner.device)
    g.manual_seed(5)
    while float(plr.proportion_filled(runner.plr_buffer)) < cfg.rho:
        states, _ = runner.env.reset_random(n, g, runner.device)
        runner.plr_buffer = plr.promote_staged(
            runner.plr_buffer, cfg, runner.env.get_level(states),
            torch.rand((n,), generator=g, device=runner.device),
            torch.ones((n,), device=runner.device))
    return float(plr.proportion_filled(runner.plr_buffer))


def walker_step_work(state) -> tuple:
    """(bytes, operations) that one B10 step of ``state`` must move and do,
    counted from csrc/walker_step.cu's body for this state's data: an
    add, product, quotient, comparison, min, max, sqrt, cos or sin is one
    operation.  Bytes a walker: the state read (129 B), the action (16 B),
    the heightfield (1600 B), the box count and its valid boxes (16 B
    each), the outputs written (265 B: state, contact flags, joints, obs,
    reward, done, finish); the 146-float constant table once.  Operations
    a walker: cos and sin of 5 angles (10); for each of the 21 valid
    contact candidates 72 (its world vertex 9, the heightfield lookup as a
    binary search of ceil(log2 200) = 8 and 2 to clip, the segment's
    height, normal and penetration 21, the choice of contact 4, its split,
    arms, masses and bias 28) and 13 per valid box; the joints' set-up
    4 x 56 and gravity 10; in each of the 40 sweeps the joints' motor,
    limit and point-to-point impulses and their scatter (264), the body
    sums' adds onto the velocities (30) and 52 for each active contact
    (the normal and friction impulses 22 + 24, their adds into the body
    sums 6); integration 30; for each of the 10 lidar rays 10, 27 per
    heightfield segment (199) and 20 per valid box; the reward, flags and
    observation 80."""
    from dcd_isaac_tpu_torch.envs.walker.physics import contact_candidates
    n = state.prev_shaping.shape[0]
    nb = int(state.terrain.n_boxes.sum())
    active = int((contact_candidates(state.bodies, state.terrain)[2] > 0)
                 .sum())
    nbytes = n * (129 + 16 + 1600 + 4 + 265) + 16 * nb + 146 * 4
    ops = (n * (10 + 21 * 72 + 4 * 56 + 10 + 40 * (264 + 30) + 30
                + 10 * (10 + 199 * 27) + 80)
           + (21 * 13 + 10 * 20) * nb + 40 * 52 * active)
    return nbytes, ops


def walker_terrain_work(n) -> tuple:
    """(bytes, operations) that B11 must move and do for n levels, counted
    from csrc/walker_terrain.cu: 36 B read a level (8 params, the seed) and
    2748 B written (xs 800, ys 800, 64 boxes 1024, n_boxes 4, bodies 120),
    the 33-float constant table once; 57 operations a column (two seed
    hashes of 17 integer operations, the grass step's 14, the next
    counter's 4, x and the column's shift 2, the state's tests 3; the
    sparse feature columns left out) and 50 for the set-up and placement."""
    return n * (36 + 2748) + 33 * 4, n * (200 * 57 + 50)


def time_walker_kernels(device) -> dict:
    """Kernels B10, B11, B7's Gaussian branch and B8 (c) with float levels
    at the walker path's shapes (N = 16; the student's minibatch R = 1024
    and the whole rollout R = 32 768; S = 1000), with their twins and
    bounds.  B10's and B11's work: ``walker_step_work``,
    ``walker_terrain_work``.  Bytes: B7 reads the rows (mean, actions,
    five scalars) and writes the means or the gradients; B8 (c) reads
    every level for the hash and the eviction order's fields and writes
    the slots this run's data accepts or folds.  Operations: B7 about 30 a
    row and action."""
    import math as m
    import torch
    from dcd_isaac_tpu_torch.envs.walker.adversarial import (
        AdversarialWalker, WalkerParams,
    )
    from dcd_isaac_tpu_torch.envs.walker.env import (
        place_walker, placement_draw, step_walker_plain,
    )
    from dcd_isaac_tpu_torch.envs.walker.terrain import (
        generate_terrain, terrain_draws,
    )
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.kernels import walker_step, walker_terrain
    from types import SimpleNamespace
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        PPOLossGaussian, ppo_loss_gaussian, ppo_loss_gaussian_plain,
        ppo_loss_gaussian_plain_backward,
    )
    from dcd_isaac_tpu_torch.level_replay import plr
    n = WALKER_N
    env = AdversarialWalker(WalkerParams(mode='easy'))
    levels = walker_levels(n, device, 8)
    state, _ = env.reset_to_level(levels)
    g = torch.Generator(device=device)
    g.manual_seed(9)
    a = torch.rand((n, 4), generator=g, device=device) * 2 - 1
    for _ in range(30):     # to a state with feet on the ground
        state = walker_step.step(state, a)[0]
    out = {}
    b = bound(*walker_step_work(state))
    out['walker_step'] = {
        'ms': graph_ms(lambda: walker_step.step(state, a), 50),
        'plain_ms': device_ms(lambda: step_walker_plain(state, a), 1, 5),
        'bound_ms': b[0], 'bound_by': b[1]}
    params, seeds = levels[:, :8].contiguous(), levels[:, 8].int().contiguous()
    b = bound(*walker_terrain_work(n))
    out['walker_terrain'] = {
        'ms': graph_ms(lambda: walker_terrain.generate(params, seeds), 50),
        'plain_ms': device_ms(lambda: (
            generate_terrain(params, terrain_draws(seeds)),
            place_walker(placement_draw(seeds))), 1, 3),
        'bound_ms': b[0], 'bound_by': b[1]}
    for R in (1024, WALKER_N * WALKER_T):
        rows = gauss_inputs(R, device)
        cfg = (0.2, False, 0.5, 0.001)

        # the backward alone: PPOLossGaussian.backward on the saved rows
        ctx = SimpleNamespace(saved_tensors=rows, cfg=cfg)
        ones = [torch.ones((), device=device)] * 4
        bwd = lambda: PPOLossGaussian.backward(ctx, *ones)
        plain_bwd = lambda: ppo_loss_gaussian_plain_backward(
            torch.ones(4, device=device), *rows, *cfg)
        # forward: mean, actions (8 floats) + 5 row scalars read, 4 written;
        # backward: the same read, dmean and dvalues (5 floats) written
        fb = bound(R * 4 * 13 + 16, 30 * 4 * R)
        bb = bound(R * 4 * (13 + 5) + 32, 40 * 4 * R)
        out[f'ppo_loss_gaussian_r{R}'] = {
            'ms': graph_ms(lambda: ppo_loss_gaussian(
                *rows, *cfg), 20),
            'backward_ms': graph_ms(bwd, 20),
            'plain_ms': device_ms(lambda: ppo_loss_gaussian_plain(
                *rows, *cfg), 5, 10),
            'plain_backward_ms': device_ms(plain_bwd, 5, 10),
            'bound_ms': fb[0], 'bound_by': fb[1],
            'backward_bound_ms': bb[0], 'backward_bound_by': bb[1]}
    cfg = plr.PLRConfig(capacity=WALKER_S, num_actors=n,
                        score_transform='rank', staleness_coef=0.5)
    buf = walker_buffer(WALKER_S, device, 3, 1.0)
    staged = walker_staged(buf, n, device, 3)
    want = plr.promote_staged_plain(buf, cfg, *staged)
    accepted = int(want.next_id - buf.next_id)
    L = 9 * 4
    b = bound(WALKER_S * (L + 13) + n * (L + 13) + accepted * (L + 26) + 8,
              2 * 2 * WALKER_S * 9 + 2 * n * WALKER_S
              + WALKER_S * m.log2(WALKER_S))
    out['plr_promote_float'] = {
        'slots_written': accepted,
        'ms': graph_ms(lambda: pk.promote(buf, cfg, *staged), 20),
        'plain_ms': device_ms(lambda: plr.promote_staged_plain(
            buf, cfg, *staged), 1, 10),
        'bound_ms': b[0], 'bound_by': b[1]}
    return out


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'needs a CUDA card', file=sys.stderr)
        return 1

    # -- 1. device -----------------------------------------------------------
    t0 = time.perf_counter()
    from dcd_isaac_tpu_torch import resolve_device
    from dcd_isaac_tpu_torch.kernels import _build
    from dcd_isaac_tpu_torch.kernels.gae import gae
    from dcd_isaac_tpu_torch.kernels.multigrid_step import (
        multigrid_obs, multigrid_step,
    )
    device = resolve_device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    print(smi, flush=True)
    log('device', t0, kind=kind, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    path, build_s = _build.build(verbose=True)
    _build.library()
    log('build', t0, library=path, nvcc_seconds=build_s)

    # -- 3. kernels against their plain twins ------------------------------
    t0 = time.perf_counter()
    checks = {'multigrid': [check_multigrid(n, 300, device)
                            for n in (MAIN_N, 4096)],
              'gae': [check_gae(MAIN_T, n, proper, device)
                      for n in (MAIN_N, 4096) for proper in (True, False)],
              'lstm_seq': [check_lstm_seq(t, n, device)
                           for t, n in ((MAIN_T, MAIN_N), (52, 1024),
                                        (MAIN_T, BENCH_SIZE_N),
                                        (MAIN_T, 1000))],
              'ppo_loss': [check_ppo_loss(r, a, cv, device)
                           for r, a, cv in ((MAIN_T * MAIN_N, 7, True),
                                            (MAIN_T * MAIN_N, 7, False),
                                            (MAIN_T * BENCH_SIZE_N, 7, True),
                                            (52 * 1024, 169, True))]}
    torch.cuda.synchronize()
    log('kernels_vs_plain', t0, **checks)
    t0 = time.perf_counter()
    adv = [check_adversary(name, n, device, seed=k)
           for k, name in enumerate(ADVERSARY_ENVS) for n in (MAIN_N, 4096)]
    bfs = check_shortest_path(4096, device)
    torch.cuda.synchronize()
    fallbacks = sum(c['agent_on_goal_fallbacks'] for c in adv)
    unsolvable = sum(c['unsolvable'] for c in adv)
    noisy = sum(c['noisy_goals'] for c in adv)
    if not (fallbacks and unsolvable and noisy and bfs['unsolvable']):
        raise AssertionError(
            f'the constructions missed a case: {fallbacks} agent-on-goal '
            f'fallbacks, {noisy} noisy goals, {unsolvable} unsolvable '
            f'levels, {bfs["unsolvable"]} unsolvable BFS levels')
    log('adversary_vs_plain', t0, step=adv, shortest_path=bfs)
    t0 = time.perf_counter()
    proj = [check_teacher_proj(b, n, device)
            for b, n in ((MAIN_N, 1024), (27 * MAIN_N, 1024),
                         (27 * MAIN_N, 64))]
    proj += [check_teacher_proj_forward(b, device)
             for b in (BENCH_SIZE_N, 52 * BENCH_SIZE_N)]
    log('teacher_proj_vs_plain', t0, checks=proj)
    t0 = time.perf_counter()
    pol = [check_policy_step(b, device) for b in (MAIN_N, BENCH_SIZE_N)]
    log('policy_step_vs_plain', t0, checks=pol)
    t0 = time.perf_counter()
    proj_bwd = [check_teacher_proj_backward(b, n, device)
                for b, n in ((27 * MAIN_N, 1024), (27 * MAIN_N, 64),
                             (52 * MAIN_N, 1024), (52 * BENCH_SIZE_N, 1024))]
    log('teacher_proj_backward_vs_plain', t0, checks=proj_bwd)
    t0 = time.perf_counter()
    log('cycle_vs_cpu', t0, **check_cycle_against_cpu(device))
    t0 = time.perf_counter()
    log('paired_cycle_vs_cpu', t0, **check_paired_cycle_against_cpu(device))
    t0 = time.perf_counter()
    plr_checks = check_plr(device)
    torch.cuda.synchronize()
    log('plr_vs_plain', t0, **plr_checks)
    t0 = time.perf_counter()
    edit_checks = check_multigrid_edit(device)
    torch.cuda.synchronize()
    log('edit_vs_plain', t0, **edit_checks)
    t0 = time.perf_counter()
    log('accel_vs_cpu', t0, **check_accel_against_cpu(device))
    t0 = time.perf_counter()
    log('repaired_vs_cpu', t0, **check_repaired_against_cpu(device))
    t0 = time.perf_counter()
    walker_checks = {
        'walker_terrain': check_walker_terrain(device),
        'walker_step': check_walker_step(64, 120, device),
        'ppo_loss_gaussian': [check_ppo_loss_gaussian(r, cv, device)
                              for r in (1024, WALKER_N * WALKER_T)
                              for cv in (False, True)],
        'plr_promote_float': check_plr_promote_float(device),
        # GAE, B8's fold and weights and the normalisation at the walker
        # path's shapes: T = 2048, N = 16, S = 1000, R = T·N
        'gae': [check_gae(WALKER_T, WALKER_N, proper, device, gamma=0.99,
                          gae_lambda=0.9, dense=True)
                for proper in (True, False)],
        'plr_fold': check_plr_fold(WALKER_T, WALKER_N, WALKER_S, device,
                                   'positive_value_loss',
                                   staleness_coef=0.5),
        'plr_weights': check_plr_weights(
            WALKER_S, device, score_transform='rank', temperature=0.1,
            staleness_transform='power', staleness_coef=0.5),
        'normalize_advantages': check_normalize(*[
            gauss_inputs(WALKER_T * WALKER_N, device, seed=7)[k]
            for k in (6, 2)])}
    if not (walker_checks['plr_fold']['seeds_scored']
            and walker_checks['plr_fold']['staged']):
        raise AssertionError('walker B8 fold: scored or staged nothing')
    torch.cuda.synchronize()
    log('walker_vs_plain', t0, **walker_checks)
    t0 = time.perf_counter()
    log('walker_vs_cpu', t0, **check_walker_accel_against_cpu(device))
    t0 = time.perf_counter()
    cr_checks = {
        'carracing_track': check_carracing_track(device),
        'carracing_render': check_carracing_render(device),
        'carracing_step': [check_carracing_step(device),
                           check_carracing_step(device, 40, sparse=True)],
        'ppo_loss_beta': [check_ppo_loss_beta(r, cv, device)
                          for r in (CR_N * CR_T // 4, CR_N * CR_T)
                          for cv in (False, True)],
        # GAE, B8's fold, weights and float promotion and the
        # normalisation at the CarRacing path's shapes: T = 125, N = 16,
        # S = 8000, (28,) levels, R = T·N
        'gae': [check_gae(CR_T, CR_N, proper, device, gamma=0.99,
                          gae_lambda=0.9, dense=True)
                for proper in (True, False)],
        'plr_fold': check_plr_fold(CR_T, CR_N, CR_S, device,
                                   'positive_value_loss',
                                   staleness_coef=0.7),
        'plr_weights': check_plr_weights(
            CR_S, device, score_transform='power', temperature=1.0,
            staleness_coef=0.7),
        'plr_promote_float': check_plr_promote_float(
            device, CR_S, CR_N, carracing_levels, score_transform='power',
            staleness_coef=0.7),
        'normalize_advantages': check_normalize(*[
            beta_inputs(CR_N * CR_T, device, seed=7)[k] for k in (6, 2)])}
    if not (cr_checks['plr_fold']['seeds_scored']
            and cr_checks['plr_fold']['staged']):
        raise AssertionError('CarRacing B8 fold: scored or staged nothing')
    torch.cuda.synchronize()
    log('carracing_vs_plain', t0, **cr_checks)
    t0 = time.perf_counter()
    log('carracing_vs_cpu', t0, **check_carracing_against_cpu(device))

    from dcd_isaac_tpu_torch import train
    from dcd_isaac_tpu_torch.arguments import check_args, parser
    from dcd_isaac_tpu_torch.kernels import multigrid_adversary
    from dcd_isaac_tpu_torch.kernels import multigrid_edit as me
    from dcd_isaac_tpu_torch.kernels import plr as pk
    from dcd_isaac_tpu_torch.kernels.lstm_seq import lstm_seq
    from dcd_isaac_tpu_torch.kernels.ppo_loss import (
        normalize_advantages, ppo_loss,
    )
    from dcd_isaac_tpu_torch.kernels.teacher_proj import teacher_proj
    from dcd_isaac_tpu_torch.kernels.policy_step import policy_step
    from dcd_isaac_tpu_torch.algos import rollout as rollout_mod
    from dcd_isaac_tpu_torch.kernels import walker_step, walker_terrain
    from dcd_isaac_tpu_torch.kernels.ppo_loss import ppo_loss_gaussian
    from dcd_isaac_tpu_torch.kernels import carracing_render as cr
    from dcd_isaac_tpu_torch.kernels import carracing_step as cs
    from dcd_isaac_tpu_torch.kernels import carracing_track as ct
    from dcd_isaac_tpu_torch.kernels.ppo_loss import ppo_loss_beta
    wrappers = {'multigrid_step': multigrid_step,
                'multigrid_obs': multigrid_obs, 'gae': gae,
                'multigrid_adversary_step': multigrid_adversary.step,
                'multigrid_shortest_path': multigrid_adversary.shortest_path,
                'teacher_proj': teacher_proj, 'lstm_seq': lstm_seq,
                'ppo_loss': ppo_loss,
                'normalize_advantages': normalize_advantages,
                'plr_score_fold': pk.score_fold,
                'plr_sample_weights': pk.sample_weights,
                'plr_promote': pk.promote, 'multigrid_mutate': me.mutate,
                'multigrid_reset_random': me.reset_random,
                'walker_step': walker_step.step,
                'walker_terrain': walker_terrain.generate,
                'ppo_loss_gaussian': ppo_loss_gaussian,
                'carracing_track': ct.build, 'carracing_render': cr.render,
                'carracing_step': cs.step, 'ppo_loss_beta': ppo_loss_beta,
                'policy_step': policy_step}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
            if hasattr(w, 'backward_launches'):
                w.backward_launches = 0

    def read_counts():
        counts = {k: w.launches for k, w in wrappers.items()}
        counts.update({f'{k}_backward': w.backward_launches
                       for k, w in wrappers.items()
                       if hasattr(w, 'backward_launches')})
        return counts

    def check_counts(phase, launches, need):
        short = {k: (launches[k], v) for k, v in need.items()
                 if launches[k] < v}
        if short:
            raise AssertionError(f'{phase}: launches short={short}')

    # B3 and B7 in one cycle: a forward and a backward pass in each of 5
    # epochs of 1 minibatch for each of the `nets` updated (the student of
    # DR; the two students and the teacher of PAIRED).  B3 launches one
    # kernel a pass, whatever the sequence's length; B7 two kernels forward
    # and one backward; the normalisation two once an update.
    def update_launches(nets):
        return {'lstm_seq': 5 * 2 * nets,
                'lstm_seq_backward': 5 * nets,
                'ppo_loss': 15 * nets,
                'ppo_loss_backward': 5 * nets,
                'normalize_advantages': 2 * nets}

    t0 = time.perf_counter()
    reset_counts()
    bench_cycle = check_paired_cycle_at_bench_size(device)
    torch.cuda.synchronize()
    bench_launches = read_counts()
    # B2: T steps and the bootstrap value a student (no time-limit
    # values at bench.py's settings); B4's backward: two kernels an epoch
    check_counts('paired_cycle_bench_size', bench_launches, {
        'multigrid_adversary_step': 52, 'teacher_proj': 52 + 1 + 5,
        'multigrid_step': 2 * MAIN_T, 'multigrid_obs': 2, 'gae': 3,
        'policy_step': 2 * (MAIN_T + 1), 'teacher_proj_backward': 2 * 5,
        **update_launches(3)})
    log('paired_cycle_bench_size', t0, launches=bench_launches,
        **bench_cycle)
    t0 = time.perf_counter()
    times = time_kernels(device)
    times.update(time_teacher_kernels(device))
    times.update(time_teacher_proj(device))
    times.update(time_training_kernels(device))
    times.update(time_plr_kernels(device))
    times.update(time_walker_kernels(device))
    times.update(time_carracing_kernels(device))
    times.update(time_policy_kernels(device))
    times.update(time_teacher_backward(device))
    log('kernel_times', t0, **times)

    # -- 4. the slices ------------------------------------------------------
    def run_slice(phase, argv, cycles, need_per_cycle):
        t0 = time.perf_counter()
        reset_counts()
        syncs = rollout_mod.make_student_rollout.host_syncs
        torch.cuda.reset_peak_memory_stats()
        _, history = train.main(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        for stats in history:
            bad = {k: v for k, v in stats.items()
                   if not math.isfinite(float(v))}
            if bad:
                raise AssertionError(f'{phase}: non-finite stats: {bad}')
        short = {k: (launches[k], cycles * v)
                 for k, v in need_per_cycle.items()
                 if launches[k] < cycles * v}
        episodes = sum(s['episodes'] for s in history)
        if len(history) != cycles or short or episodes <= 0:
            raise AssertionError(f'{phase}: cycles={len(history)} launches '
                                 f'short={short} episodes={episodes}')
        log(phase, t0, cycles=cycles, launches=launches, episodes=episodes,
            cycle_seconds=[s['cycle_time_s'] for s in history],
            host_syncs=rollout_mod.make_student_rollout.host_syncs - syncs,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            stats=history[-1])
        return launches

    def run_plr_slice(phase, argv, need):
        """A PLR⊥, ACCEL or REPAIRED runner of the training entry point at
        full width, its buffers filled to rho through promote_staged; then a
        generate cycle and a replay cycle (with ACCEL its edit cycle), with
        every kernel's launches counted around them; then one more cycle
        chosen by the runner's own coin."""
        t0 = time.perf_counter()
        runner = train.setup(check_args(parser.parse_args(argv)))
        t_fill = time.perf_counter()
        filled = fill_plr_buffer(runner)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t_fill
        reset_counts()
        history, seconds = [], []
        for replay in (False, True, None):
            c0 = time.perf_counter()
            history.append(runner.run() if replay is None
                           else runner.run(replay=replay))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - c0)
            if replay:
                launches = read_counts()
        bad = {k: v for s_ in history for k, v in s_.items()
               if not math.isfinite(float(v))}
        short = {k: (launches[k], v) for k, v in need.items()
                 if launches[k] < v}
        kinds = [s_['level_replay'] for s_ in history[:2]]
        # REPAIRED's teacher updates on every cycle, the replay's on the
        # generate cycle's stored rollout
        no_teacher = runner.is_training_env and not all(
            'adversary_env_pg_loss' in s_ for s_ in history)
        if bad or short or kinds != [0, 1] or no_teacher:
            raise AssertionError(f'{phase}: non-finite {bad}, launches '
                                 f'short={short}, cycles {kinds}, teacher '
                                 f'update missing: {no_teacher}')
        log(phase, t0, prefill_seconds=fill_s, proportion_filled=filled,
            cycles=['generate', 'replay + edit' if runner.use_editor
                    else 'replay', 'coin'],
            launches=launches, cycle_seconds=seconds,
            stats_finite=True, stats=history)
        return launches

    design = lambda moves: {'multigrid_adversary_step': moves}
    # B2 in a student rollout with time-limit values: T actions, T values
    # and the bootstrap value
    b2 = lambda rollouts: {'policy_step': rollouts * (2 * MAIN_T + 1)}
    plr_need = {'plr_score_fold': 2, 'plr_sample_weights': 4,
                'plr_promote': 2, 'multigrid_shortest_path': 1,
                'multigrid_step': 2 * MAIN_T, 'gae': 2, **b2(2),
                **update_launches(2)}
    # The teacher without a core: its construction (27 moves of B5, 28
    # B4 forwards at N = 64 with the bootstrap value), and its flat update
    # (5 epochs of one minibatch: a B4 forward, its backward's two kernels
    # and B7's launches an epoch).
    construction = {'multigrid_adversary_step': 27, 'teacher_proj': 28}
    flat_teacher_update = {'teacher_proj': 5,
                           'teacher_proj_backward': 2 * 5, 'ppo_loss': 15,
                           'ppo_loss_backward': 5, 'normalize_advantages': 2}

    def plus(*needs):
        out = {}
        for need in needs:
            for k, v in need.items():
                out[k] = out.get(k, 0) + v
        return out

    by_path = {
        'dr': run_slice('slice', SLICE_ARGS, 2, {
            'multigrid_step': MAIN_T, 'multigrid_obs': 1, 'gae': 1,
            'multigrid_shortest_path': 1, 'multigrid_reset_random': 1,
            **b2(1), **update_launches(1)}),
        'robust_plr': run_plr_slice('robust_plr_slice', ROBUST_PLR_ARGS, {
            **plr_need, **design(27)}),
        'accel': run_plr_slice('accel_slice', ACCEL_ARGS, {
            **plr_need, **design(2), 'plr_score_fold': 3, 'plr_promote': 4,
            'multigrid_mutate': 1, 'multigrid_step': 3 * MAIN_T, 'gae': 3,
            **b2(3), **update_launches(3)}),
        'paired': run_slice('paired_slice', PAIRED_ARGS, 2, {
            'multigrid_adversary_step': 27, 'teacher_proj': 27 + 1 + 5,
            'multigrid_step': 2 * MAIN_T, 'multigrid_obs': 2, 'gae': 3,
            **b2(2), 'teacher_proj_backward': 2 * 5,
            **update_launches(3)}),
        # REPAIRED's generate and replay cycles (the coin's third not
        # counted): four student rollouts and updates, one construction,
        # two teacher updates (the replay's on the stored rollout), both
        # buffers' promotions on the generate cycle
        'repaired': run_plr_slice('repaired_slice', REPAIRED_ARGS, plus(
            b2(4), construction, flat_teacher_update, flat_teacher_update,
            update_launches(4),
            {'multigrid_step': 4 * MAIN_T, 'gae': 6, 'plr_score_fold': 4,
             'plr_sample_weights': 4, 'plr_promote': 4})),
        'minimax': run_slice('minimax_slice', MINIMAX_ARGS, 2, plus(
            b2(1), construction, flat_teacher_update,
            update_launches(1),
            {'multigrid_step': MAIN_T, 'gae': 2, 'multigrid_obs': 1})),
    }
    def run_cycle(runner, phase, phases, need, **kw):
        """One cycle of a runner that runs ``phases`` student phases (2 for
        a replay cycle with its edit cycle): its seconds, steps a second
        (phases·N·T over the seconds, as PERF.md counts them), kernel
        launches, host syncs and peak device memory; fails on a
        non-finite stat or a kernel of the path, in ``need``, that did not
        run."""
        reset_counts()
        syncs = rollout_mod.make_student_rollout.host_syncs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = time.perf_counter()
        stats = runner.run(**kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - c0
        launches = read_counts()
        bad = {k: v for k, v in stats.items()
               if not math.isfinite(float(v))}
        if bad:
            raise AssertionError(f'{phase}: non-finite stats: {bad}')
        check_counts(phase, launches, need)
        args = runner.args
        return {'seconds': seconds,
                'sps': phases * args.num_processes * args.num_steps / seconds,
                'launches': launches,
                'host_syncs': (rollout_mod.make_student_rollout.host_syncs
                               - syncs),
                'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
                'stats': stats}

    def run_walker_cycle(runner, phase, phases, promotes=1, **kw):
        return run_cycle(runner, phase, phases,
                         walker_need(phases, promotes), **kw)

    def walker_need(phases, promotes=1):
        """Launches a walker cycle of ``phases`` student phases needs at
        least: B10 every step, B11 a reset each, GAE, B7's Gaussian branch
        for 5 epochs x 32 minibatches (2 forward and 2 backward launches),
        the advantage normalisation, the fold, and ``promotes``
        promotions (hash and promotion each)."""
        return {'walker_step': phases * WALKER_T,
                'walker_terrain': phases, 'gae': phases,
                'ppo_loss_gaussian': phases * 5 * 32 * 4,
                'ppo_loss_gaussian_backward': phases * 5 * 32 * 2,
                'normalize_advantages': 2 * phases,
                'plr_score_fold': phases, 'plr_promote': 2 * promotes,
                'plr_sample_weights': 1}

    t0 = time.perf_counter()
    runner = train.setup(check_args(parser.parse_args(BIPEDAL_ACCEL_ARGS)))
    t_fill = time.perf_counter()
    filled = fill_walker_buffer(runner)
    fill_s = time.perf_counter() - t_fill
    cycles = {
        'accel_generate': run_walker_cycle(runner, 'accel_generate', 1,
                                           replay=False),
        'accel_replay_edit': run_walker_cycle(runner, 'accel_replay_edit',
                                              2, replay=True)}
    if cycles['accel_replay_edit']['stats']['total_num_edits'] != 1:
        raise AssertionError('walker_cycles: the replay cycle made no edit')
    robust = train.setup(check_args(parser.parse_args(
        BIPEDAL_ROBUST_PLR_ARGS)))
    fill_walker_buffer(robust)
    cycles['robust_plr_replay'] = run_walker_cycle(
        robust, 'robust_plr_replay', 1, promotes=0, replay=True)
    for name, c in cycles.items():
        replay = name != 'accel_generate'
        if replay and not any(k.startswith('plr_') for k in c['stats']):
            raise AssertionError(f'{name}: no plr_ env stats')
    log('walker_cycles', t0, prefill_seconds=fill_s,
        proportion_filled=filled, **cycles)
    by_path['walker_accel'] = {
        k: cycles['accel_generate']['launches'][k]
        + cycles['accel_replay_edit']['launches'][k]
        for k in cycles['accel_generate']['launches']}
    # the training entry point: bipedal_accel's first three cycles (all
    # generate cycles: the buffer fills to rho after ~32) and one cycle of
    # each other configuration
    walker_slice_need = {'walker_step': WALKER_T, 'walker_terrain': 1,
                         'gae': 1, 'ppo_loss_gaussian': 5 * 32 * 4}
    by_path['walker_accel_train'] = run_slice(
        'bipedal_accel_train', BIPEDAL_ACCEL_ARGS + [
            '--num_env_steps', str(3 * WALKER_N * WALKER_T)], 3,
        walker_slice_need)
    for name, argv in (('bipedal_robust_plr', BIPEDAL_ROBUST_PLR_ARGS),
                       ('bipedal_dr', BIPEDAL_DR_ARGS),
                       ('bipedal_accel_poet', BIPEDAL_POET_ARGS)):
        by_path[name] = run_slice(name + '_train', argv + [
            '--num_env_steps', str(WALKER_N * WALKER_T)], 1,
            walker_slice_need)
    # B13a every step, B12 every step and at each reset (the student's
    # reset_agent at least), B13b at that reset, GAE, B7's Beta branch for
    # 8 epochs x 4 minibatches (2 forward and 1 backward launches), the
    # normalisation; with PLR the fold and the promotion (hash, promote)
    cr_need = {'carracing_step': CR_T, 'carracing_render': CR_T + 1,
               'carracing_track': 1, 'gae': 1,
               'ppo_loss_beta': 8 * 4 * 3, 'ppo_loss_beta_backward': 8 * 4,
               'normalize_advantages': 2}
    t0 = time.perf_counter()
    cr_runner = train.setup(check_args(parser.parse_args(CR_DR_ARGS)))
    cr_cycles = {'cr_dr': run_cycle(cr_runner, 'cr_dr', 1, cr_need)}
    robust = train.setup(check_args(parser.parse_args(CR_ROBUST_PLR_ARGS)))
    t_fill = time.perf_counter()
    filled = fill_walker_buffer(robust)
    fill_s = time.perf_counter() - t_fill
    cr_cycles['cr_robust_plr_generate'] = run_cycle(
        robust, 'cr_robust_plr_generate', 1, {
            **cr_need, 'plr_score_fold': 1, 'plr_promote': 2},
        replay=False)
    cr_cycles['cr_robust_plr_replay'] = run_cycle(
        robust, 'cr_robust_plr_replay', 1, {
            **cr_need, 'plr_score_fold': 1, 'plr_sample_weights': 1},
        replay=True)
    if not any(k.startswith('plr_track')
               for k in cr_cycles['cr_robust_plr_replay']['stats']):
        raise AssertionError('cr_robust_plr_replay: no plr_ track stats')
    log('carracing_cycles', t0, prefill_seconds=fill_s,
        proportion_filled=filled, **cr_cycles)
    by_path['carracing_dr'] = cr_cycles['cr_dr']['launches']
    by_path['carracing_robust_plr'] = {
        k: cr_cycles['cr_robust_plr_generate']['launches'][k]
        + cr_cycles['cr_robust_plr_replay']['launches'][k]
        for k in cr_cycles['cr_dr']['launches']}
    for name, argv in (('cr_dr', CR_DR_ARGS), ('cr_plr', CR_PLR_ARGS),
                       ('cr_robust_plr', CR_ROBUST_PLR_ARGS)):
        by_path[name + '_train'] = run_slice(name + '_train', argv + [
            '--num_env_steps', str(CR_N * CR_T)], 1, cr_need)
    run_slice('bench_env_slice', BENCH_ENV_ARGS, 1, {
        'multigrid_adversary_step': 52, 'teacher_proj': 52 + 1 + 5,
        'multigrid_step': 2 * MAIN_T, 'gae': 3,
        **update_launches(3)})
    by_path['paired_bench_size'] = bench_launches

    # -- 5. kernels line and result ----------------------------------------
    mg_err = max(c['max_abs_err'] for c in checks['multigrid'])
    errs = {'multigrid_step': mg_err, 'multigrid_obs': mg_err,
            'gae': max(c['max_abs_err']
                       for c in checks['gae'] + walker_checks['gae']),
            'multigrid_adversary_step': max(c['max_abs_err'] for c in adv),
            'multigrid_shortest_path': bfs['max_abs_err'],
            'teacher_proj': max(c['max_abs_err'] for c in proj),
            'lstm_seq': max(c['max_abs_err'] for c in checks['lstm_seq']),
            'ppo_loss': max(c['max_abs_err'] for c in checks['ppo_loss']),
            'plr_score_fold': max(
                c['max_abs_err']
                for c in plr_checks['fold'] + [walker_checks['plr_fold']]),
            'plr_sample_weights': max(
                c['max_abs_err'] for c in plr_checks['weights']
                + [walker_checks['plr_weights']]),
            'plr_promote': max(c['max_abs_err'] for c in plr_checks['promote']),
            'multigrid_mutate': edit_checks['max_abs_err']['mutate'],
            'multigrid_reset_random':
                edit_checks['max_abs_err']['reset_random'],
            'walker_step': walker_checks['walker_step']['max_abs_err'],
            'walker_terrain': walker_checks['walker_terrain']['max_abs_err'],
            'ppo_loss_gaussian': max(
                c['max_abs_err'] for c in walker_checks['ppo_loss_gaussian']),
            'carracing_track': cr_checks['carracing_track']['max_abs_err'],
            'carracing_render': cr_checks['carracing_render']['max_abs_err'],
            'carracing_step': max(c['max_abs_err']
                                  for c in cr_checks['carracing_step']),
            'ppo_loss_beta': max(c['max_abs_err']
                                 for c in cr_checks['ppo_loss_beta']),
            'policy_step': max(c['max_abs_err'] for c in pol),
            'teacher_proj_backward': max(c['max_abs_err'] for c in proj_bwd)}
    errs['gae'] = max(errs['gae'], *(c['max_abs_err']
                                     for c in cr_checks['gae']))
    errs['plr_score_fold'] = max(errs['plr_score_fold'],
                                 cr_checks['plr_fold']['max_abs_err'])
    errs['plr_sample_weights'] = max(errs['plr_sample_weights'],
                                     cr_checks['plr_weights']['max_abs_err'])
    errs['plr_promote'] = max(errs['plr_promote'],
                              cr_checks['plr_promote_float']['max_abs_err'])
    errs['plr_promote'] = max(
        errs['plr_promote'], walker_checks['plr_promote_float']['max_abs_err'])
    norms = [{'R': c['R'], 'max_abs_err': c['normalize_max_abs_err']}
             for c in checks['ppo_loss']]
    norms.append(walker_checks['normalize_advantages'])
    norms.append(cr_checks['normalize_advantages'])
    grad_errs = {'ppo_loss': {'grad_errors': [
        {'R': c['R'], 'A': c['A'], **c['grads']}
        for c in checks['ppo_loss']],
        'normalize_max_abs_err': max(c['max_abs_err'] for c in norms),
        'normalize_rows': sorted({c['R'] for c in norms})},
        'ppo_loss_gaussian': {'grad_errors': [
            {'R': c['R'], **c['grads']}
            for c in walker_checks['ppo_loss_gaussian']]},
        'ppo_loss_beta': {'grad_errors': [
            {'R': c['R'], **c['grads']}
            for c in cr_checks['ppo_loss_beta']]},
        'policy_step': {'rows_within_1e-5_of_a_cdf_entry': sum(
            c['rows_within_1e-5_of_a_cdf_entry'] for c in pol)},
        'teacher_proj_backward': {'grad_errors': [
            {k: v for k, v in c.items() if k != 'max_abs_err'}
            for c in proj_bwd]}}
    b = times.pop(f'ppo_loss_beta_r{CR_N * CR_T}')
    times['ppo_loss_beta'] = times.pop(f'ppo_loss_beta_r{CR_N * CR_T // 4}')
    times['ppo_loss_beta'].update(
        {f'{k}_r{CR_N * CR_T}': v for k, v in b.items()})
    g = times.pop(f'ppo_loss_gaussian_r{WALKER_N * WALKER_T}')
    times['ppo_loss_gaussian'] = times.pop('ppo_loss_gaussian_r1024')
    times['ppo_loss_gaussian'].update(
        {f'{k}_r{WALKER_N * WALKER_T}': v for k, v in g.items()})
    times['plr_promote'].update(
        {f'{k}_float_levels': v
         for k, v in times.pop('plr_promote_float').items()})
    times['multigrid_adversary_step']['ms_final_move'] = times.pop(
        'multigrid_adversary_step_final')['ms']
    meta = {
        'multigrid_step': ('dcd_isaac_tpu_torch/csrc/multigrid_step.cu',
                           'dcd_isaac_tpu/envs/multigrid/core.py:306'),
        'multigrid_obs': ('dcd_isaac_tpu_torch/csrc/multigrid_step.cu',
                          'dcd_isaac_tpu/envs/multigrid/core.py:265'),
        'gae': ('dcd_isaac_tpu_torch/csrc/gae.cu',
                'dcd_isaac_tpu/algos/storage.py:66'),
        'multigrid_adversary_step': (
            'dcd_isaac_tpu_torch/csrc/multigrid_adversary.cu',
            'dcd_isaac_tpu/envs/multigrid/adversarial.py:102'),
        'multigrid_shortest_path': (
            'dcd_isaac_tpu_torch/csrc/multigrid_adversary.cu',
            'dcd_isaac_tpu/envs/multigrid/core.py:369'),
        'teacher_proj': ('dcd_isaac_tpu_torch/csrc/teacher_proj.cu',
                         'dcd_isaac_tpu/models/multigrid_models.py:120'),
        'lstm_seq': ('dcd_isaac_tpu_torch/csrc/lstm_seq.cu',
                     'dcd_isaac_tpu/models/common.py:125'),
        'ppo_loss': ('dcd_isaac_tpu_torch/csrc/ppo_loss.cu',
                     'dcd_isaac_tpu/algos/ppo.py:82'),
        'plr_score_fold': ('dcd_isaac_tpu_torch/csrc/plr.cu',
                           'dcd_isaac_tpu/level_replay/plr.py:345'),
        'plr_sample_weights': ('dcd_isaac_tpu_torch/csrc/plr.cu',
                               'dcd_isaac_tpu/level_replay/plr.py:189'),
        'plr_promote': ('dcd_isaac_tpu_torch/csrc/plr.cu',
                        'dcd_isaac_tpu/level_replay/plr.py:525'),
        'multigrid_mutate': (
            'dcd_isaac_tpu_torch/csrc/multigrid_edit.cu',
            'dcd_isaac_tpu/envs/multigrid/adversarial.py:284'),
        'multigrid_reset_random': (
            'dcd_isaac_tpu_torch/csrc/multigrid_edit.cu',
            'dcd_isaac_tpu/envs/multigrid/adversarial.py:206'),
        'walker_step': ('dcd_isaac_tpu_torch/csrc/walker_step.cu',
                        'dcd_isaac_tpu/envs/walker/env.py:132'),
        'walker_terrain': ('dcd_isaac_tpu_torch/csrc/walker_terrain.cu',
                           'dcd_isaac_tpu/envs/walker/terrain.py:36'),
        'ppo_loss_gaussian': ('dcd_isaac_tpu_torch/csrc/ppo_loss.cu',
                              'dcd_isaac_tpu/algos/ppo.py:82'),
        'carracing_track': ('dcd_isaac_tpu_torch/csrc/carracing_track.cu',
                            'dcd_isaac_tpu/envs/carracing/adversarial.py:62'),
        'carracing_render': ('dcd_isaac_tpu_torch/csrc/carracing_render.cu',
                             'dcd_isaac_tpu/envs/carracing/track.py:148'),
        'carracing_step': ('dcd_isaac_tpu_torch/csrc/carracing_step.cu',
                           'dcd_isaac_tpu/envs/carracing/env.py:186'),
        'ppo_loss_beta': ('dcd_isaac_tpu_torch/csrc/ppo_loss.cu',
                          'dcd_isaac_tpu/algos/ppo.py:82'),
        'policy_step': ('dcd_isaac_tpu_torch/csrc/multigrid_policy.cu',
                        'dcd_isaac_tpu/models/multigrid_models.py:98'),
        'teacher_proj_backward': (
            'dcd_isaac_tpu_torch/csrc/teacher_proj.cu',
            'dcd_isaac_tpu/models/multigrid_models.py:120'),
    }
    # `launches` counts kernel launches, forward and backward (see
    # update_launches); B7's entry also carries the advantage
    # normalisation's launches and its gradients' error beside their scale.
    extra = {'lstm_seq': ('lstm_seq_backward',),
             'ppo_loss': ('ppo_loss_backward', 'normalize_advantages'),
             'ppo_loss_gaussian': ('ppo_loss_gaussian_backward',),
             'ppo_loss_beta': ('ppo_loss_beta_backward',)}
    kernels = [{'name': name, 'route': 'cuda', 'source': src,
                'replaces': rep,
                'launches': sum(c[name] for c in by_path.values()),
                'launches_by_path': {k: c[name] for k, c in by_path.items()},
                **{f'launches_{e}': sum(c[e] for c in by_path.values())
                   for e in extra.get(name, ())},
                'max_abs_err': errs[name], 'library_ms': None, **times[name],
                **grad_errs.get(name, {})}
               for name, (src, rep) in meta.items()]
    log('total', t_all)
    print(json.dumps({'kernels': kernels}), flush=True)
    torch.cuda.synchronize()
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
