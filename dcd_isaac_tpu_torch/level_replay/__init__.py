from .plr import (
    PLRBuffer, PLRConfig, init_plr, plr_stats, promote_staged,
    proportion_filled, sample_replay_decision, sample_replay_levels,
    sample_weights, update_with_rollout,
)
