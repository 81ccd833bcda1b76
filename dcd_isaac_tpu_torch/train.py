"""Training entry point of the port (dcd_isaac_tpu/train.py:26-131).

``python -m dcd_isaac_tpu_torch.train --env_name ... --ued_algo
domain_randomization ...`` parses the port's arguments, builds env, model
and runner on the card (``--no_cuda true`` asks for the CPU) and runs cycles
until ``--num_env_steps``, printing one JSON stats line per cycle.  CSV logs,
checkpoints and in-training evaluation come with the entry-points slice.
"""

from __future__ import annotations

import json
import time

import torch

from .arguments import check_args, parser
from .device import resolve_device
from .envs.registry import make_env
from .runner.adversarial_runner import AdversarialRunner
from .utils.make_agent import make_model


def main(argv=None):
    """Train; returns ``(runner, per-cycle stats dicts)``."""
    args = check_args(parser.parse_args(argv))
    device = resolve_device('cpu' if args.no_cuda else None)
    env = make_env(args.env_name)
    init_gen = torch.Generator().manual_seed(args.seed)
    model = make_model(args, env, generator=init_gen).to(device)
    runner = AdversarialRunner(args, env, {'agent': model}, device)

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
