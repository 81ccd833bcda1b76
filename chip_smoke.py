#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:
  1. device: the card's name and ``nvidia-smi`` name and power limit;
  2. build: one ``nvcc`` call for all kernels (kernels/_build.py);
  3. kernels: each kernel against its plain PyTorch twin on the card:
     ``multigrid_step`` / ``multigrid_obs`` bit-exact over 300 steps with
     resets on random DR levels at N = 32 and N = 4096, ``gae`` within
     atol = rtol = 1e-5 at T = 256, N in {32, 4096}, with
     ``handle_timelimits`` on and off; one small DR cycle on the card
     against the same cycle on the CPU (plain twins) with its random draws
     injected; then each kernel's time at the main path's shapes beside
     its plain twin's and its bound;
  4. slice: two domain-randomization training cycles through the training
     entry point at the settings of
     train_scripts/grid_configs/minigrid/25_blocks/mg_25b_dr.json without
     PLR (N = 32, T = 256, LSTM-256, 5 PPO epochs, fp32), with every
     kernel's launch count read around it;
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
MAIN_N, MAIN_T = 32, 256
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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
    for t in range(steps):
        image = multigrid_obs(state.grid, state.agent_pos, state.agent_dir,
                              p.agent_view_size)
        want = obs_plain(state.grid, state.agent_pos, state.agent_dir,
                         p.agent_view_size)
        if not torch.equal(image, want):
            raise AssertionError(f'multigrid_obs != obs_plain at step {t}')
        args = (state.grid, state.agent_pos, state.agent_dir,
                state.step_count, state.agent_done,
                random_actions(n, gen, device), p.agent_view_size,
                p.max_steps)
        got = multigrid_step(*args)
        want = step_plain(*args)
        for k, (a, b) in enumerate(zip(got, want)):
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
            'goals': n_goal, 'max_abs_err': 0.0}


def gae_inputs(T, N, device, seed=0):
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=device)
    rn = lambda *s: torch.randn(s, generator=g, device=device)
    return dict(rewards=r(T, N) * (r(T, N) < 0.1), values=rn(T, N),
                dones=r(T, N) < 0.05, bad_masks=(r(T, N) < 0.5).float(),
                trunc_values=rn(T, N), next_value=rn(N))


def check_gae(T, N, proper, device) -> dict:
    import torch
    from dcd_isaac_tpu_torch.kernels.gae import gae, gae_plain
    x = gae_inputs(T, N, device)
    got = gae(**x, gamma=0.995, gae_lambda=0.95, use_proper_time_limits=proper)
    want = gae_plain(**x, gamma=0.995, gae_lambda=0.95,
                     use_proper_time_limits=proper)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    err = float((got - want).abs().max())
    return {'T': T, 'N': N, 'proper': proper, 'max_abs_err': err}


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
    tol = 1e-5
    out = []
    for dev in ('cpu', device):
        net = make_model(args, env, generator=torch.Generator().manual_seed(1))
        before = {k: v.clone() for k, v in net.state_dict().items()}
        runner = AdversarialRunner(args, env, {'agent': net.to(dev)}, dev)
        sample = lambda logits, k: actions[k].to(dev)

        def reset(k, state, seeds):
            state, obs = env.reset_to_level(
                levels[n * (k + 1):n * (k + 2)].to(dev))
            return state, obs, seeds
        stats = runner.run(levels=levels[:n].to(dev), sample_action_fn=sample,
                           reset_fn=reset, perms=perms.to(dev))
        out.append((stats, {k: v.cpu() - before[k] for k, v in
                            net.state_dict().items()}))
    (cpu_stats, cpu_delta), (card_stats, card_delta) = out
    err = max(float((card_delta[k] - cpu_delta[k]).abs().max())
              for k in cpu_delta)
    moved = max(float(d.abs().max()) for d in cpu_delta.values())
    if (err > tol or moved <= tol
            or card_stats['episodes'] != cpu_stats['episodes']):
        raise AssertionError(f'card cycle != CPU cycle: weight changes '
                             f'differ by {err}, largest change {moved}, '
                             f'episodes {card_stats["episodes"]} vs '
                             f'{cpu_stats["episodes"]}')
    return {'max_abs_err_weight_change': err, 'max_weight_change': moved,
            'episodes': card_stats['episodes'],
            'value_loss': [cpu_stats['agent_value_loss'],
                           card_stats['agent_value_loss']]}


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

    def bound(nbytes, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        return (max(t_bytes, t_ops),
                'bytes' if t_bytes >= t_ops else 'operations')

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
                      for n in (MAIN_N, 4096) for proper in (True, False)]}
    torch.cuda.synchronize()
    log('kernels_vs_plain', t0, **checks)
    t0 = time.perf_counter()
    log('cycle_vs_cpu', t0, **check_cycle_against_cpu(device))
    t0 = time.perf_counter()
    times = time_kernels(device)
    log('kernel_times', t0, **times)

    # -- 4. the slice: two DR training cycles ------------------------------
    t0 = time.perf_counter()
    from dcd_isaac_tpu_torch import train
    wrappers = {'multigrid_step': multigrid_step,
                'multigrid_obs': multigrid_obs, 'gae': gae}
    for w in wrappers.values():
        w.launches = 0
    _, history = train.main(SLICE_ARGS)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    cycles = len(history)
    for stats in history:
        bad = {k: v for k, v in stats.items()
               if not math.isfinite(float(v))}
        if bad:
            raise AssertionError(f'non-finite stats: {bad}')
    episodes = sum(s['episodes'] for s in history)
    need = {'multigrid_step': cycles * MAIN_T, 'multigrid_obs': cycles,
            'gae': cycles}
    short = {k: (launches[k], need[k]) for k in need if launches[k] < need[k]}
    if cycles != 2 or short or episodes <= 0:
        raise AssertionError(f'slice: cycles={cycles} launches short={short} '
                             f'episodes={episodes}')
    log('slice', t0, cycles=cycles, launches=launches, episodes=episodes,
        cycle_seconds=[s['cycle_time_s'] for s in history],
        stats=history[-1])

    # -- 5. kernels line and result ----------------------------------------
    mg_err = max(c['max_abs_err'] for c in checks['multigrid'])
    errs = {'multigrid_step': mg_err, 'multigrid_obs': mg_err,
            'gae': max(c['max_abs_err'] for c in checks['gae'])}
    meta = {
        'multigrid_step': ('dcd_isaac_tpu_torch/csrc/multigrid_step.cu',
                           'dcd_isaac_tpu/envs/multigrid/core.py:306'),
        'multigrid_obs': ('dcd_isaac_tpu_torch/csrc/multigrid_step.cu',
                          'dcd_isaac_tpu/envs/multigrid/core.py:265'),
        'gae': ('dcd_isaac_tpu_torch/csrc/gae.cu',
                'dcd_isaac_tpu/algos/storage.py:66'),
    }
    kernels = [{'name': name, 'route': 'cuda', 'source': src,
                'replaces': rep, 'launches': launches[name],
                'max_abs_err': errs[name], **times[name],
                'library_ms': None}
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
