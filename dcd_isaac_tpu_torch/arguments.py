"""CLI config surface of the PyTorch port.

A copy of the JAX package's parser (dcd_isaac_tpu/arguments.py), which
mirrors the reference's flags one for one (same names, same defaults) so the
grid configs in train_scripts/grid_configs/*.json drive the port unchanged.
The JAX package's XLA/TPU-only knobs are not copied; the port refuses
``--bf16 true`` (it is fp32) and, until the entry-points slice, the
logging settings it would otherwise ignore: ``--log_action_complexity
true``, ``--checkpoint true`` and ``--archive_interval`` > 0.  The PLR
and editor flags run (``--log_plr_buffer_stats`` is accepted: the PLR
stats are in every cycle's stats, as in the JAX package), with DR and,
as REPAIRED, with PAIRED (``--protagonist_plr`` / ``--antagonist_plr``
share the protagonist's buffer); ``--recurrent_adversary_env false``
builds the teacher without a core.  The runner refuses the methods that
wait for later slices (ALP-GMM, a fixed PLR seed set, PopArt), the
registry the walker's and CarRacing's evaluation levels (and ACCEL's
edits on CarRacing), and the model factory the walker's and CarRacing's
teachers, a student without a core, the global critic and the GRU core.
``--no_cuda true`` asks for the CPU; otherwise the entry points run on the
card.
"""

import argparse


def str2bool(v):
    if isinstance(v, bool):
        return v
    return str(v).lower() in ('yes', 'true', 't', 'y', '1')


# (dest, type, default) — transcription of the reference parser's surface.
_FLAGS = [
    # PPO / optimization
    ('algo', str, 'ppo'),
    ('lr', float, 1e-4),
    ('eps', float, 1e-5),
    ('alpha', float, 0.99),
    ('gamma', float, 0.995),
    ('use_gae', str2bool, True),
    ('gae_lambda', float, 0.95),
    ('entropy_coef', float, 0.0),
    ('adv_entropy_coef', float, 0.0),
    ('value_loss_coef', float, 0.5),
    ('max_grad_norm', float, 0.5),
    ('adv_max_grad_norm', float, 0.5),
    ('normalize_returns', str2bool, False),
    ('adv_normalize_returns', str2bool, False),
    ('use_popart', str2bool, False),
    ('adv_use_popart', str2bool, False),
    ('seed', int, 1),
    ('num_processes', int, 32),
    ('num_steps', int, 256),
    ('ppo_epoch', int, 5),
    ('adv_ppo_epoch', int, 5),
    ('num_mini_batch', int, 1),
    ('adv_num_mini_batch', int, 1),
    ('clip_param', float, 0.2),
    ('clip_value_loss', str2bool, True),
    ('clip_reward', float, None),
    ('adv_clip_reward', float, None),
    ('num_env_steps', int, 500000),
    # model
    ('recurrent_arch', str, 'lstm'),
    ('recurrent_agent', str2bool, True),
    ('recurrent_adversary_env', str2bool, False),
    ('recurrent_hidden_size', int, 256),
    # UED
    ('ued_algo', str, 'paired'),
    ('protagonist_plr', str2bool, False),
    ('antagonist_plr', str2bool, False),
    ('use_reset_random_dr', str2bool, False),
    # PLR
    ('use_plr', str2bool, False),
    ('level_replay_strategy', str, 'value_l1'),
    ('level_replay_eps', float, 0.05),
    ('level_replay_score_transform', str, 'rank'),
    ('level_replay_temperature', float, 0.1),
    ('level_replay_schedule', str, 'proportionate'),
    ('level_replay_rho', float, 1.0),
    ('level_replay_prob', float, 0.0),
    ('level_replay_alpha', float, 1.0),
    ('staleness_coef', float, 0.3),
    ('staleness_transform', str, 'power'),
    ('staleness_temperature', float, 1.0),
    ('train_full_distribution', str2bool, True),
    ('level_replay_seed_buffer_size', int, 4000),
    ('level_replay_seed_buffer_priority', str, 'replay_support'),
    ('reject_unsolvable_seeds', str2bool, False),
    ('no_exploratory_grad_updates', str2bool, False),
    # ACCEL
    ('use_editor', str2bool, False),
    ('level_editor_prob', float, 0.0),
    ('level_editor_method', str, 'random'),
    ('base_levels', str, 'batch'),
    ('num_edits', int, 0),
    # fine-tuning / logging / checkpointing
    ('xpid_finetune', str, None),
    ('model_finetune', str, 'model'),
    ('no_cuda', str2bool, False),
    ('xpid', str, 'latest'),
    ('log_dir', str, '~/logs/dcd/'),
    ('log_interval', int, 1),
    ('checkpoint_interval', int, 100),
    ('archive_interval', int, 0),
    ('checkpoint_basis', str, 'num_updates'),
    ('weight_log_interval', int, 0),
    ('screenshot_interval', int, 5000),
    ('screenshot_batch_size', int, 1),
    ('render', str2bool, False),
    ('checkpoint', str2bool, False),
    ('disable_checkpoint', str2bool, False),
    ('log_grad_norm', str2bool, False),
    ('log_action_complexity', str2bool, False),
    ('log_replay_complexity', str2bool, False),
    ('log_plr_buffer_stats', str2bool, False),
    ('verbose', str2bool, False),
    # evaluation
    ('test_interval', int, 250),
    ('test_num_episodes', int, 10),
    ('test_num_processes', int, 2),
    ('test_env_names', str,
     'MultiGrid-SixteenRooms-v0,MultiGrid-Labyrinth-v0,MultiGrid-Maze-v0'),
    # environment
    ('env_name', str, 'MultiGrid-GoalLastAdversarial-v0'),
    ('handle_timelimits', str2bool, False),
    ('singleton_env', str2bool, False),
    ('use_global_critic', str2bool, False),
    ('use_global_policy', str2bool, False),
    # CarRacing
    ('grayscale', str2bool, False),
    ('crop_frame', str2bool, False),
    ('reward_shaping', str2bool, False),
    ('num_action_repeat', int, 1),
    ('frame_stack', int, 1),
    ('num_control_points', int, 12),
    ('min_rad_ratio', float, 0.333333333),
    ('max_rad_ratio', float, 1.0),
    ('use_skip', str2bool, False),
    ('choose_start_pos', str2bool, False),
    ('use_sketch', str2bool, True),
    ('use_categorical_adv', str2bool, False),
    ('sparse_rewards', str2bool, False),
    ('num_goal_bins', int, 1),
    # --- additions of the PyTorch port ----------------------------------
    # Model compute type. This slice runs fp32 only; `--bf16 true` is
    # refused by check_args.
    ('bf16', str2bool, None),
]


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='dcd_isaac_tpu_torch')
    for dest, typ, default in _FLAGS:
        kwargs = dict(type=typ, default=default)
        if typ is str2bool:
            kwargs.update(nargs='?', const=True)
        parser.add_argument(f'--{dest}', **kwargs)
    return parser


parser = make_parser()


def defaults() -> argparse.Namespace:
    return parser.parse_args([])


def check_args(args: argparse.Namespace) -> argparse.Namespace:
    """Refuse settings this slice of the port does not implement."""
    if args.bf16:
        raise ValueError(
            '--bf16 true is not supported: the PyTorch port runs fp32 only')
    waits = 'it waits for the entry-points slice (ROADMAP queue A.4)'
    if args.log_action_complexity:
        raise NotImplementedError(
            f'--log_action_complexity true is not ported yet: {waits}')
    if args.checkpoint:
        raise NotImplementedError(
            f'--checkpoint true is not ported yet: {waits}')
    if args.archive_interval > 0:
        raise NotImplementedError(
            f'--archive_interval {args.archive_interval} is not ported yet '
            f'(checkpoint archives): {waits}')
    if args.xpid_finetune is not None:
        raise NotImplementedError(
            f'--xpid_finetune {args.xpid_finetune} is not ported yet '
            f'(loading a base run\'s agent): {waits}')
    return args
