"""Training entry point of the port (dcd_isaac_tpu/train.py:26-131).

``python -m dcd_isaac_tpu_torch.train --env_name ... --ued_algo
paired ...`` parses the port's arguments, builds the env (MultiGrid, the
walker's three training names or CarRacing's two), the models of ``--ued_algo``
(``make_all_models``) and the runner on the card (``--no_cuda true`` asks
for the CPU) and runs cycles until ``--num_env_steps``, printing one JSON
stats line per cycle.  With ``--use_plr true`` the runner keeps a PLR
buffer (with PAIRED, REPAIRED: one for each student unless they share
it) and picks generate, replay (and with ``--use_editor true``, edit)
cycles.  CSV logs, checkpoints and
in-training evaluation come with the entry-points slice.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .arguments import check_args, parser
from .device import resolve_device
from .envs.registry import make_env
from .runner.adversarial_runner import AdversarialRunner
from .utils.make_agent import make_all_models


def setup(args) -> AdversarialRunner:
    """The runner that checked arguments build: env, models, device."""
    device = resolve_device('cpu' if args.no_cuda else None)
    env = make_env(args.env_name, args)
    init_gen = torch.Generator().manual_seed(args.seed)
    models = {role: model.to(device) for role, model in
              make_all_models(args, env, init_gen).items()}
    return AdversarialRunner(args, env, models, device)


def main(argv=None):
    """Train; returns ``(runner, per-cycle stats dicts)``."""
    args = check_args(parser.parse_args(argv))
    print(f'dcd_isaac_tpu_torch.train: no CSV log is written to '
          f'--log_dir {args.log_dir} yet (ROADMAP queue A.4); the stats go '
          f'to stdout, one JSON line per cycle; --test_env_names '
          f'{args.test_env_names} and in-training evaluation wait for the '
          f'same slice, and so do --screenshot_interval, '
          f'--weight_log_interval, --log_interval and --test_interval, '
          f'which are read and ignored', file=sys.stderr)
    runner = setup(args)

    num_updates = args.num_env_steps // args.num_steps // args.num_processes
    history = []
    for j in range(num_updates):
        t0 = time.perf_counter()
        stats = runner.run()    # ends in a host read of the stats
        dt = time.perf_counter() - t0
        stats['cycle_time_s'] = dt
        stats['sps'] = args.num_processes * args.num_steps / dt
        history.append(stats)
        print(json.dumps({'update': j + 1, 'of': num_updates, **stats}),
              flush=True)
    return runner, history


if __name__ == '__main__':
    main()
