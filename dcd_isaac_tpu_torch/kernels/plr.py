"""Kernel B8: the PLR score fold, sample weights and promotion on the card.

Replaces ``dcd_isaac_tpu/level_replay/plr.py``: ``update_with_rollout``
(:345-518) with ``_step_scores`` (:276-338), ``sample_weights`` and
``_score_transform`` (:158-207) and ``promote_staged`` (:525-643).  The
CUDA source is ``csrc/plr.cu``: each entry point is one block of
:data:`BLOCK` threads over the whole buffer (the promotion first hashes
every level with a grid), so every sum runs in one fixed order and two
runs agree bit for bit.  The fold walks each env's T steps in order and
folds each seed's episodes in (env, episode) order; the weights rank by
counting; the promotion pairs the staged levels with empty, then
low-priority, slots.  Bound on the H100: the dependent chains of a single
block (the T-step walks, the O(S^2) rank counts), not its few megabytes.

These wrappers take CUDA tensors only: ``level_replay/plr.py`` holds the
plain PyTorch twins (``update_with_rollout_plain``,
``sample_weights_plain``, ``promote_staged_plain``) and takes them for a
buffer on the CPU.  Each wrapper counts its kernel launches in
``.launches``.  The kernel takes the strategies in
:data:`FOLD_STRATEGIES` and the transforms in :data:`TRANSFORMS`; the
others raise here and run on the CPU only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

BLOCK = 1024
# strategy → the kernel's code (csrc/plr.cu); others have no kernel path.
FOLD_STRATEGIES = {
    'uniform': 0, 'random': 0, 'off': 0, 'sequential': 0,
    'gae': 1, 'signed_value_loss': 1,
    'value_l1': 2, 'alt_advantage_abs': 2,
    'positive_value_loss': 3,
    'grounded_signed_value_loss': 4,
    'grounded_positive_value_loss': 5,
    'one_step_td_error': 6,
}
TRANSFORMS = {'constant': 0, 'rank': 1, 'power': 2}


def _on_card(name, t):
    if t.device.type == 'cpu':
        raise ValueError(f'{name}: kernels.plr takes CUDA tensors; the CPU '
                         'path is level_replay.plr\'s plain twin')


def _transform(name, transform):
    if transform not in TRANSFORMS:
        raise NotImplementedError(
            f'{name} {transform!r} has no kernel B8 path on the card '
            f'(kernel transforms: {sorted(TRANSFORMS)}); it runs on the CPU '
            'only (--no_cuda true)')
    return TRANSFORMS[transform]


def weight_args(cfg) -> list:
    """The sample-weight settings of a PLRConfig as the C arguments
    (transform, p, stale_on, stale_transform, stale_p, e, coef,
    one_minus_coef)."""
    stale_on = cfg.staleness_coef > 0
    return [
        _transform('score_transform', cfg.score_transform),
        ctypes.c_float(1.0 / cfg.temperature), int(stale_on),
        _transform('staleness_transform', cfg.staleness_transform)
        if stale_on else 0,
        ctypes.c_float(1.0 / cfg.staleness_temperature),
        ctypes.c_float(0.0 if stale_on else 1e-3),
        ctypes.c_float(cfg.staleness_coef),
        ctypes.c_float(1 - cfg.staleness_coef)]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def score_fold(rewards, values, returns, dones, cliffhangers, level_seeds,
               scores, unseen, grounded, staleness, cfg, staging_base: int):
    """update_with_rollout's fold → (scores, unseen, grounded, staleness,
    staged_scores (N,), staged_counts (N,)), new tensors; one launch."""
    if rewards.dim() != 2:
        raise ValueError(f'rewards: expected (T, N), got '
                         f'{tuple(rewards.shape)}')
    T, N = rewards.shape
    S = scores.shape[0]
    dev = rewards.device
    _on_card('rewards', rewards)
    for name, t, dtype, shape in (
            ('rewards', rewards, torch.float32, (T, N)),
            ('values', values, torch.float32, (T, N)),
            ('returns', returns, torch.float32, (T, N)),
            ('dones', dones, torch.bool, (T, N)),
            ('cliffhangers', cliffhangers, torch.bool, (T, N)),
            ('level_seeds', level_seeds, torch.int32, (T, N)),
            ('scores', scores, torch.float32, (S,)),
            ('unseen', unseen, torch.float32, (S,)),
            ('grounded', grounded, torch.float32, (S,)),
            ('staleness', staleness, torch.float32, (S,))):
        _build.check_tensor(name, t, dtype, shape, dev)
    if cfg.strategy not in FOLD_STRATEGIES:
        raise NotImplementedError(
            f'PLR strategy {cfg.strategy!r} has no kernel B8 path on the '
            f'card (kernel strategies: {sorted(FOLD_STRATEGIES)}); it runs '
            'on the CPU only (--no_cuda true)')
    lib = _build.library()
    out = [x.clone() for x in (scores, unseen, grounded, staleness)]
    staged_scores = torch.empty(N, dtype=torch.float32, device=dev)
    staged_counts = torch.empty(N, dtype=torch.float32, device=dev)
    ne = N * (T + 1)
    iws = torch.empty(6 * ne + 3 * N, dtype=torch.int32, device=dev)
    fws = torch.empty(3 * ne, dtype=torch.float32, device=dev)
    a, msc = cfg.alpha, cfg.max_score_coef
    rc = lib.dcd_plr_score_fold(
        rewards.data_ptr(), values.data_ptr(), returns.data_ptr(),
        dones.data_ptr(), cliffhangers.data_ptr(), level_seeds.data_ptr(),
        *(x.data_ptr() for x in out), staged_scores.data_ptr(),
        staged_counts.data_ptr(), iws.data_ptr(), fws.data_ptr(), T, N, S,
        staging_base, FOLD_STRATEGIES[cfg.strategy],
        int(cfg.use_dense_rewards), int(cfg.staleness_coef > 0),
        ctypes.c_float(a), ctypes.c_float(1 - a), ctypes.c_float(msc),
        ctypes.c_float(1 - msc), ctypes.c_float(cfg.gamma), _stream(dev))
    _build.check(rc, 'plr.score_fold')
    score_fold.launches += 1
    return (*out, staged_scores, staged_counts)


score_fold.launches = 0


def sample_weights(scores, staleness, unseen, cfg) -> torch.Tensor:
    """(S,) replay weights of the buffer; one launch."""
    S = scores.shape[0]
    dev = scores.device
    _on_card('scores', scores)
    for name, t in (('scores', scores), ('staleness', staleness),
                    ('unseen', unseen)):
        _build.check_tensor(name, t, torch.float32, (S,), dev)
    wargs = weight_args(cfg)
    lib = _build.library()
    w = torch.empty(S, dtype=torch.float32, device=dev)
    tmp = torch.empty(S, dtype=torch.float32, device=dev)
    pos = torch.empty(S, dtype=torch.int32, device=dev)
    rc = lib.dcd_plr_sample_weights(
        scores.data_ptr(), staleness.data_ptr(), unseen.data_ptr(),
        w.data_ptr(), tmp.data_ptr(), pos.data_ptr(), S, *wargs, _stream(dev))
    _build.check(rc, 'plr.sample_weights')
    sample_weights.launches += 1
    return w


sample_weights.launches = 0

# The buffer fields the promotion writes, in the C entry point's order.
PROMOTE_FIELDS = ('levels', 'scores', 'unseen', 'filled', 'solvable',
                  'staleness', 'grounded_values', 'num_edits', 'slot_ids',
                  'next_id', 'sample_count')


def promote(buf, cfg, staged_levels, staged_scores, staged_counts,
            staged_solvable, staged_num_edits) -> dict:
    """promote_staged → the new buffer fields (a dict), new tensors; two
    launches (hash, promotion), one with dedup off.  Levels are uint8
    (MultiGrid) or float32 (the walker's (9,) params and seed), hashed by
    value truncated toward zero, as ``level_hash`` does."""
    S, N = buf.capacity, staged_scores.shape[0]
    dev = buf.scores.device
    _on_card('scores', buf.scores)
    level_shape = tuple(buf.levels.shape[1:])
    ltype = buf.levels.dtype
    if ltype not in (torch.uint8, torch.float32):
        raise TypeError(f'levels: uint8 or float32, got {ltype}')
    for name, t, dtype, shape in (
            ('levels', buf.levels, ltype, (S, *level_shape)),
            ('scores', buf.scores, torch.float32, (S,)),
            ('unseen', buf.unseen, torch.float32, (S,)),
            ('filled', buf.filled, torch.bool, (S,)),
            ('solvable', buf.solvable, torch.bool, (S,)),
            ('staleness', buf.staleness, torch.float32, (S,)),
            ('grounded_values', buf.grounded_values, torch.float32, (S,)),
            ('num_edits', buf.num_edits, torch.int32, (S,)),
            ('slot_ids', buf.slot_ids, torch.int32, (S,)),
            ('next_id', buf.next_id, torch.int32, ()),
            ('sample_count', buf.sample_count, torch.float32, ()),
            ('staged_levels', staged_levels, ltype, (N, *level_shape)),
            ('staged_scores', staged_scores, torch.float32, (N,)),
            ('staged_counts', staged_counts, torch.float32, (N,)),
            ('staged_solvable', staged_solvable, torch.bool, (N,)),
            ('staged_num_edits', staged_num_edits, torch.int32, (N,))):
        _build.check_tensor(name, t, dtype, shape, dev)
    replay_support = cfg.seed_buffer_priority == 'replay_support'
    wargs = (weight_args(cfg) if replay_support
             else [0, ctypes.c_float(1.0), 0, 0, ctypes.c_float(1.0),
                   ctypes.c_float(0.0), ctypes.c_float(0.0),
                   ctypes.c_float(1.0)])
    lib = _build.library()
    out = {k: getattr(buf, k).clone() for k in PROMOTE_FIELDS}
    L = buf.levels[0].numel()
    sn = max(S, N)
    hash_ = torch.empty(2 * (S + N), dtype=torch.int32, device=dev)
    fws = torch.empty(S + 2 * sn, dtype=torch.float32, device=dev)
    iws = torch.empty(sn + 2 * S + 4 * N, dtype=torch.int32, device=dev)
    a = cfg.alpha
    rc = lib.dcd_plr_promote(
        *(out[k].data_ptr() for k in PROMOTE_FIELDS),
        staged_levels.data_ptr(), staged_scores.data_ptr(),
        staged_counts.data_ptr(), staged_solvable.data_ptr(),
        staged_num_edits.data_ptr(), hash_.data_ptr(), fws.data_ptr(),
        iws.data_ptr(), S, N, L, int(ltype == torch.float32), int(cfg.dedup),
        int(cfg.reject_unsolvable),
        int(replay_support), *wargs, ctypes.c_float(a),
        ctypes.c_float(1 - a), _stream(dev))
    _build.check(rc, 'plr.promote')
    promote.launches += 2 if cfg.dedup else 1
    return out


promote.launches = 0
