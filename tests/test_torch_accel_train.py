"""PLR⊥ and ACCEL through the training entry point on the CPU: a few
cycles of ``train.main`` from an empty buffer (split from
test_torch_accel.py so that the two slow cases run on a worker of their
own)."""

import json

import numpy as np
import pytest

from dcd_isaac_tpu_torch import train
from test_torch_accel import ACCEL_FLAGS, ROBUST_PLR_FLAGS
from test_torch_algos import N


# -- the training entry point ---------------------------------------------

@pytest.mark.parametrize('method', ['robust_plr', 'accel'])
def test_train_runs_plr_cycles(method, capsys):
    """A few PLR⊥ or ACCEL cycles through ``train.main`` on the CPU, from an
    empty buffer of 32 slots, on the 6x6 env with 50-step episodes and
    64-step rollouts, so every level completes an episode and is staged:
    generate cycles fill the buffer past rho, then replay (and edit) cycles
    run."""
    flags = ROBUST_PLR_FLAGS if method == 'robust_plr' else ACCEL_FLAGS
    cycles, steps = 14, 64
    runner, history = train.main(flags + [
        '--env_name', 'MultiGrid-MiniAdversarial-v0', '--num_steps',
        str(steps), '--level_replay_seed_buffer_size', '32',
        '--num_env_steps', str(cycles * N * steps)])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert len(history) == len(lines) == cycles
    for stats in history:
        assert all(np.isfinite(v) for v in stats.values())
        assert 0 <= stats['solvable_mass'] <= 1 + 1e-5
    replays = sum(s['level_replay'] for s in history)
    assert 0 < replays < cycles
    assert history[-1]['proportion_filled'] >= 0.5
    edits = history[-1]['total_num_edits']
    assert edits == (replays if method == 'accel' else 0)
    assert history[-1]['steps'] == (cycles + edits) * N * steps
    assert history[-1]['total_student_grad_updates'] == replays
    if method == 'accel':
        assert history[-1]['weighted_num_edits'] > 0
