"""Prioritized Level Replay on the runner's device.

Port of ``dcd_isaac_tpu/level_replay/plr.py``: the level buffer is one
dataclass of tensors with ``capacity`` slots (slot index == seed; seeds at
or above the capacity are this cycle's staged levels), and the per-episode
scoring of the reference is a fold over the (T, N) rollout tensors.  The
semantics, formulas and documented deviations are the JAX package's:
staged levels are promoted once after the rollout with eviction priorities
computed once a cycle, staleness ages in one batch, and exact duplicate
levels fold into their slot by a two-lane 32-bit content hash.

Three functions are kernel B8 on the card (``kernels/plr.py``,
``csrc/plr.cu``) and their plain twins here on the CPU:
``update_with_rollout`` (the score fold), ``sample_weights`` (the rank and
power transforms with the staleness mix) and ``promote_staged``.  Each
takes its ``*_plain`` twin when the buffer lies on the CPU and launches the
kernel, or raises, when it lies on the card.  The twins sum in the
kernel's order (episode sums step by step, the EWA fold and the staged sums
episode by episode, the weights' normalisers in the kernel's block tree),
so the two agree to the last bit but for ``powf``.  On the card the kernel
takes the strategies in ``kernels.plr.FOLD_STRATEGIES`` and the transforms
in ``kernels.plr.TRANSFORMS``; the others (the ``log_dists`` strategies,
``tscl_window``, the ``max``/``eps_greedy``/``softmax``/``match`` family)
run on the CPU only and raise on the card.

Random draws come from a ``torch.Generator`` (``torch.multinomial`` where
JAX draws with ``jax.random.choice``, a different stream); the ``seeds``
and ``u`` arguments replace them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..kernels import plr as plr_kernels

NEG_INF = -1e9
# The kernel's block of threads; the plain twins sum in its tree.
_BLOCK = plr_kernels.BLOCK
# The content-hash lanes of the dedup (plr.py:566-577).
HASH_MULTS = (0x9E3779B1, 0x85EBCA77)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PLRConfig:
    """Copy of the JAX package's PLRConfig (same names and defaults)."""
    capacity: int
    num_actors: int
    full_distribution: bool = True
    strategy: str = 'value_l1'
    replay_schedule: str = 'proportionate'
    score_transform: str = 'rank'
    temperature: float = 1.0
    eps: float = 0.05
    rho: float = 1.0
    replay_prob: float = 0.95
    alpha: float = 1.0
    staleness_coef: float = 0.3
    staleness_transform: str = 'power'
    staleness_temperature: float = 1.0
    max_score_coef: float = 0.0
    seed_buffer_priority: str = 'replay_support'
    dedup: bool = True
    gamma: float = 0.999
    use_dense_rewards: bool = False
    reject_unsolvable: bool = False
    tscl_window_size: int = 10
    alt_gamma: float = 0.99


@dataclasses.dataclass(frozen=True)
class PLRBuffer:
    """The level buffer, every field a tensor on one device."""
    levels: torch.Tensor           # (S, *level_shape) uint8, or float32
    scores: torch.Tensor           # (S,) float32
    staleness: torch.Tensor        # (S,) float32
    unseen: torch.Tensor           # (S,) float32, 1.0 = never scored
    filled: torch.Tensor           # (S,) bool
    solvable: torch.Tensor         # (S,) bool
    grounded_values: torch.Tensor  # (S,) float32
    num_edits: torch.Tensor        # (S,) int32, ACCEL lineage depth
    slot_ids: torch.Tensor         # (S,) int32 insertion id, -1 = empty
    next_id: torch.Tensor          # () int32 insertion counter
    sample_count: torch.Tensor     # () float32 running sample counter
    tscl_returns: torch.Tensor     # (S, W) return window (tscl_window)
    tscl_stamps: torch.Tensor      # (S, W) sample-count stamps
    tscl_n: torch.Tensor           # (S,) int32 window fill counts

    @property
    def capacity(self) -> int:
        return self.scores.shape[0]

    def replace(self, **kw) -> 'PLRBuffer':
        return dataclasses.replace(self, **kw)


def init_plr(cfg: PLRConfig, level_shape, device,
             level_dtype=torch.uint8,
             levels: Optional[torch.Tensor] = None) -> PLRBuffer:
    """An empty buffer, or with ``levels`` a filled fixed seed set (every
    slot unseen)."""
    S = cfg.capacity
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    W = cfg.tscl_window_size
    common = dict(
        scores=torch.zeros(S, **f32), staleness=torch.zeros(S, **f32),
        unseen=torch.ones(S, **f32),
        solvable=torch.ones(S, dtype=torch.bool, device=device),
        grounded_values=torch.full((S,), NEG_INF, **f32),
        num_edits=torch.zeros(S, **i32),
        sample_count=torch.zeros((), **f32),
        tscl_returns=torch.zeros((S, W), **f32),
        tscl_stamps=torch.zeros((S, W), **f32),
        tscl_n=torch.zeros(S, **i32))
    if levels is not None:
        if levels.shape[0] != S:
            raise ValueError('prefill must cover every slot')
        return PLRBuffer(
            levels=levels.to(device=device, dtype=level_dtype).contiguous(),
            filled=torch.ones(S, dtype=torch.bool, device=device),
            slot_ids=torch.arange(S, **i32),
            next_id=torch.tensor(S, **i32), **common)
    return PLRBuffer(
        levels=torch.zeros((S, *level_shape), dtype=level_dtype,
                           device=device),
        filled=torch.zeros(S, dtype=torch.bool, device=device),
        slot_ids=torch.full((S,), -1, **i32),
        next_id=torch.zeros((), **i32), **common)


def proportion_filled(buf: PLRBuffer) -> torch.Tensor:
    return buf.filled.float().mean()


# ---------------------------------------------------------------------------
# Sample weights (plr.py:158-207)
# ---------------------------------------------------------------------------

def _ranks(x: torch.Tensor) -> torch.Tensor:
    """1 for the largest entry; ties by index (argsort(-x, stable))."""
    order = torch.argsort(-x, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(1, x.shape[0] + 1, device=x.device)
    return ranks.float()


def _score_transform(transform: str, temperature: float, scores, unseen,
                     eps: float, staleness_coef: float) -> torch.Tensor:
    S = scores.shape[0]
    p = 1.0 / temperature
    if transform == 'constant':
        return torch.ones_like(scores)
    if transform == 'max':
        masked = torch.where(unseen > 0, torch.full_like(scores, -math.inf),
                             scores)
        return (masked == masked.max()).float()
    if transform == 'eps_greedy':
        w = torch.zeros_like(scores)
        w[torch.argmax(scores)] = 1.0 - eps
        return w + eps / S
    if transform == 'rank':
        return 1.0 / _ranks(scores) ** p
    if transform == 'power':
        e = 0.0 if staleness_coef > 0 else 1e-3
        return (scores.clamp(min=0) + e) ** p
    if transform == 'softmax':
        return torch.exp(scores / temperature)
    if transform == 'match':
        return ((1 - scores) * scores) ** p
    if transform == 'match_rank':
        return 1.0 / _ranks((1 - scores) * scores) ** p
    raise ValueError(f'Unknown score transform {transform}')


def block_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D float tensor in kernel B8's order: each of the block's
    threads sums its strided entries in index order, then the threads'
    partial sums fold pairwise, halving."""
    n = x.shape[0]
    rows = -(-n // _BLOCK)
    pad = torch.zeros(rows * _BLOCK, dtype=x.dtype, device=x.device)
    pad[:n] = x
    pad = pad.view(rows, _BLOCK)
    acc = torch.zeros(_BLOCK, dtype=x.dtype, device=x.device)
    for r in range(rows):
        acc = acc + pad[r]
    s = _BLOCK // 2
    while s:
        acc = acc[:s] + acc[s:2 * s]
        s //= 2
    return acc[0]


def sample_weights_plain(buf: PLRBuffer, cfg: PLRConfig) -> torch.Tensor:
    """Replay distribution over the slots (plr.py:186-207)."""
    seen = 1.0 - buf.unseen
    uniform_seen = seen / block_sum(seen).clamp(min=1.0)
    w = _score_transform(cfg.score_transform, cfg.temperature, buf.scores,
                         buf.unseen, cfg.eps, cfg.staleness_coef) * seen
    z = block_sum(w)
    w = torch.where(z > 0, w / z.clamp(min=1e-12), uniform_seen)
    if cfg.staleness_coef > 0:
        sw = _score_transform(
            cfg.staleness_transform, cfg.staleness_temperature,
            buf.staleness, buf.unseen, cfg.eps, cfg.staleness_coef) * seen
        sz = block_sum(sw)
        sw = torch.where(sz > 0, sw / sz.clamp(min=1e-12), uniform_seen)
        w = (1 - cfg.staleness_coef) * w + cfg.staleness_coef * sw
    return w


def sample_weights(buf: PLRBuffer, cfg: PLRConfig) -> torch.Tensor:
    """Kernel B8 (b) on the card; :func:`sample_weights_plain` on the CPU."""
    if buf.scores.device.type == 'cpu':
        return sample_weights_plain(buf, cfg)
    return plr_kernels.sample_weights(buf.scores, buf.staleness, buf.unseen,
                                      cfg)


def sample_replay_decision(buf: PLRBuffer, cfg: PLRConfig, u
                           ) -> torch.Tensor:
    """Replay or not, from the uniform ``u`` (plr.py:210-227): the filled
    share gates replay, or with a fixed seed set the seen share."""
    u = torch.as_tensor(u, dtype=torch.float32, device=buf.scores.device)
    if not cfg.full_distribution:
        prop = 1.0 - buf.unseen.mean()
        if cfg.replay_schedule == 'fixed':
            return (prop >= cfg.rho) & ((u < cfg.replay_prob) | (prop >= 1.0))
        return (prop >= cfg.rho) & (u < prop)
    prop = proportion_filled(buf)
    if cfg.replay_schedule == 'fixed':
        return (prop >= cfg.rho) & (u < cfg.replay_prob)
    return (prop >= cfg.rho) & (u < prop.clamp(max=cfg.replay_prob))


def _draw(w, n, generator, seeds):
    if seeds is not None:
        return seeds.to(device=w.device, dtype=torch.int64)
    return torch.multinomial(w, n, replacement=True, generator=generator)


def _age(buf: PLRBuffer, cfg: PLRConfig, seeds, n) -> PLRBuffer:
    staleness = buf.staleness
    if cfg.staleness_coef > 0:
        staleness = (staleness + n).index_fill(0, seeds, 0.0)
    return buf.replace(staleness=staleness,
                       sample_count=buf.sample_count + n)


def sample_unseen_levels(buf: PLRBuffer, cfg: PLRConfig, n: int,
                         generator: torch.Generator = None,
                         seeds: Optional[torch.Tensor] = None):
    """Fixed seed set: n seeds drawn by the unseen weights (plr.py:230-249)
    → (seeds int32, levels, buffer)."""
    total = buf.unseen.sum()
    w = torch.where(total > 0, buf.unseen / total.clamp(min=1e-12),
                    torch.full_like(buf.unseen, 1.0 / buf.capacity))
    seeds = _draw(w, n, generator, seeds)
    return seeds.int(), buf.levels[seeds], _age(buf, cfg, seeds, n)


def sample_replay_levels(buf: PLRBuffer, cfg: PLRConfig, n: int,
                         generator: torch.Generator = None,
                         seeds: Optional[torch.Tensor] = None):
    """n replay seeds drawn with replacement by the current weights
    (plr.py:252-273) → (seeds int32, levels, buffer).  Everyone ages by n
    and the drawn seeds reset, in one batch."""
    seeds = _draw(sample_weights(buf, cfg), n, generator, seeds)
    return seeds.int(), buf.levels[seeds], _age(buf, cfg, seeds, n)


# ---------------------------------------------------------------------------
# Per-step strategy scores (plr.py:276-338)
# ---------------------------------------------------------------------------

def _episode_starts(dones: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(dones[:1])
    return torch.cat([first, dones[:-1]], 0)


def _step_scores(cfg: PLRConfig, rollout, returns, values,
                 grounded_per_step):
    """(T, N) per-step score, max-score and weight of the strategy."""
    strat = cfg.strategy
    ones = torch.ones_like(values)
    if strat in ('uniform', 'tscl_window', 'random', 'off', 'sequential'):
        return ones, ones, ones
    if strat == 'policy_entropy':
        logp = rollout.log_dists
        s = -(logp.exp() * logp).sum(-1) / math.log(logp.shape[-1])
        return s, s, ones
    if strat == 'least_confidence':
        s = 1.0 - rollout.log_dists.max(-1).values.exp()
        return s, s, ones
    if strat == 'min_margin':
        top2 = rollout.log_dists.topk(2, -1).values
        s = 1.0 - (top2[..., 0].exp() - top2[..., 1].exp())
        return s, s, ones
    if strat in ('gae', 'signed_value_loss'):
        s = returns - values
        return s, s, ones
    if strat in ('value_l1', 'alt_advantage_abs'):
        s = (returns - values).abs()
        return s, s, ones
    if strat == 'positive_value_loss':
        s = (returns - values).clamp(min=0)
        return s, s, ones
    if strat in ('grounded_signed_value_loss',
                 'grounded_positive_value_loss'):
        s = grounded_per_step - values
        if strat == 'grounded_positive_value_loss':
            s = s.clamp(min=0)
        w = (_episode_starts(rollout.dones).float() if cfg.use_dense_rewards
             else ones)
        return s, s, w
    if strat == 'one_step_td_error':
        v_next = torch.cat([values[1:], values[-1:]], 0)
        td = (rollout.rewards + cfg.gamma * v_next - values).abs()
        single = rollout.rewards - values
        is_single = _episode_starts(rollout.dones) & rollout.dones
        s = torch.where(is_single, single, td)
        w = torch.where(is_single, ones, 1.0 - rollout.dones.float())
        return s, s, w
    raise ValueError(f'Unsupported PLR strategy {cfg.strategy}')


# ---------------------------------------------------------------------------
# Rollout → score updates (plr.py:345-518)
# ---------------------------------------------------------------------------

def _ordered_sums(keys, values, size):
    """Per key in [0, size), the sum of ``values`` in their given order,
    from 0: the rank-th entries of every key are added together, rank by
    rank (no two share a key), as the kernel adds them one by one."""
    out = torch.zeros(size, dtype=values.dtype, device=values.device)
    if keys.numel() == 0:
        return out
    rank = _rank_in_group(keys)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        out[keys[sel]] += values[sel]
    return out


def _rank_in_group(keys):
    """0-based position of each entry among the earlier entries of its
    key."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    m = keys.shape[0]
    pos = torch.arange(m, device=keys.device)
    new = torch.ones(m, dtype=torch.bool, device=keys.device)
    new[1:] = sk[1:] != sk[:-1]
    start = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    return rank


def _episodes(cfg: PLRConfig, rollout, returns, values, grounded_values,
              S: int):
    """The (N, T + 1) episode table of a rollout, walked step by step as
    kernel B8 (a) walks it: each env's episodes in order, with their seed,
    total score, return, step weight and whether they completed."""
    rewards, dones = rollout.rewards, rollout.dones
    T, N = rewards.shape
    E = T + 1
    dev = rewards.device
    rows = torch.arange(N, device=dev)
    seg = torch.cat([torch.zeros((1, N), dtype=torch.long, device=dev),
                     torch.cumsum(dones.long(), 0)[:-1]], 0)
    ep_ret = torch.zeros((N, E), device=dev)
    for t in range(T):
        ep_ret[rows, seg[t]] += rewards[t]

    seeds = rollout.level_seeds
    g_seed = torch.where((seeds >= 0) & (seeds < S), seeds,
                         torch.zeros_like(seeds)).long()
    old = grounded_values[g_seed]
    ret_step = ep_ret[rows[None, :], seg]
    grounded = torch.where(old > NEG_INF / 2, torch.maximum(old, ret_step),
                           ret_step)
    s, m, w = _step_scores(cfg, rollout, returns, values, grounded)
    sw = s * w
    sums = torch.zeros((N, E), device=dev)
    counts = torch.zeros((N, E), device=dev)
    for t in range(T):
        sums[rows, seg[t]] += sw[t]
        counts[rows, seg[t]] += w[t]
    flat_seg = (rows[None, :] * E + seg).reshape(-1)
    neg = torch.full_like(m, -math.inf)
    maxes = torch.full((N * E,), -math.inf, device=dev).scatter_reduce(
        0, flat_seg, torch.where(w > 0, m, neg).reshape(-1), 'amax')
    maxes = maxes.view(N, E)
    ep_mean = sums / counts.clamp(min=1.0)
    ep_max = torch.where(torch.isfinite(maxes), maxes,
                         torch.zeros_like(maxes))
    total = (cfg.max_score_coef * ep_max
             + (1 - cfg.max_score_coef) * ep_mean)

    real = (dones & ~rollout.cliffhangers).long().reshape(-1)
    completed = torch.zeros(N * E, dtype=torch.long, device=dev
                            ).scatter_reduce(0, flat_seg, real, 'amax')
    has_steps = torch.zeros(N * E, dtype=torch.long, device=dev
                            ).scatter_add(0, flat_seg,
                                          torch.ones_like(flat_seg))
    completed = ((completed > 0) & (has_steps > 0)).view(N, E)
    t_ids = torch.arange(T, device=dev)[:, None].expand(T, N).reshape(-1)
    first = torch.full((N * E,), T - 1, dtype=torch.long, device=dev
                       ).scatter_reduce(0, flat_seg, t_ids, 'amin')
    ep_seed = seeds.T.gather(1, first.view(N, E))
    return ep_seed, total, ep_ret, counts, completed


def update_with_rollout_plain(buf: PLRBuffer, cfg: PLRConfig, rollout,
                              returns, values,
                              staging_base: Optional[int] = None
                              ) -> Tuple[PLRBuffer, torch.Tensor,
                                         torch.Tensor]:
    """Fold one student rollout into the seed scores (plr.py:345-518).

    Completed, non-cliffhanger episodes on working seeds (< capacity) fold
    into their seed's score by the EWA in (env, episode) order; episodes
    on seeds at or above ``staging_base`` (default: the capacity) are this
    cycle's staged levels, whose step-weighted mean scores and episode
    counts are returned: (buffer, staged_scores (N,), staged_counts (N,)).
    """
    S = buf.capacity
    base = S if staging_base is None else staging_base
    N = rollout.rewards.shape[1]
    ep_seed, total, ep_ret, counts, completed = _episodes(
        cfg, rollout, returns, values, buf.grounded_values, S)

    # EWA fold into the working seeds, in (env, episode) order
    working = (completed & (ep_seed >= 0) & (ep_seed < S)).reshape(-1)
    w_seed = ep_seed.reshape(-1)[working].long()
    w_total = total.reshape(-1)[working]
    w_ret = ep_ret.reshape(-1)[working]
    K = torch.bincount(w_seed, minlength=S).float()
    rank = _rank_in_group(w_seed).float()
    a = cfg.alpha
    w_e = a * (1 - a) ** (K[w_seed] - 1 - rank).clamp(min=0)
    contrib = _ordered_sums(w_seed, w_e * w_total, S)
    touched = K > 0
    scores = torch.where(touched, (1 - a) ** K * buf.scores + contrib,
                         buf.scores)
    unseen = torch.where(touched, torch.zeros_like(buf.unseen), buf.unseen)
    g_max = torch.full((S,), -math.inf, device=scores.device
                       ).scatter_reduce(0, w_seed, w_ret, 'amax')
    grounded = torch.maximum(buf.grounded_values, g_max)
    staleness = buf.staleness
    if cfg.staleness_coef > 0:
        staleness = torch.where(touched, torch.zeros_like(staleness),
                                staleness)

    if cfg.strategy == 'tscl_window':
        buf, scores, unseen = _tscl_update(buf, cfg, w_seed, w_ret, unseen)
    buf = buf.replace(scores=scores, unseen=unseen,
                      grounded_values=grounded, staleness=staleness)

    # staged levels: step-weighted mean score over their episodes
    staged = (completed & (ep_seed >= base)).reshape(-1)
    s_idx = (ep_seed - base).clamp(0, N - 1).reshape(-1)[staged].long()
    s_cnt = counts.reshape(-1)[staged]
    st_sums = _ordered_sums(s_idx, (total.reshape(-1)[staged] * s_cnt), N)
    st_counts = _ordered_sums(s_idx, s_cnt, N)
    st_epis = _ordered_sums(s_idx, torch.ones_like(s_cnt), N)
    return buf, st_sums / st_counts.clamp(min=1.0), st_epis


def _tscl_update(buf, cfg, w_seed, w_ret, unseen):
    """TSCL: this rollout's mean return per seed pushed into the seed's
    window; score = |slope| of the window (plr.py:435-478)."""
    S, W = buf.capacity, cfg.tscl_window_size
    r_sum = torch.zeros(S, device=w_ret.device).index_add(0, w_seed, w_ret)
    r_cnt = torch.bincount(w_seed, minlength=S).float()
    has = r_cnt > 0
    r_mean = r_sum / r_cnt.clamp(min=1.0)
    rows = torch.arange(S, device=w_ret.device)
    slot = (buf.tscl_n % W).long()
    t_returns, t_stamps = buf.tscl_returns.clone(), buf.tscl_stamps.clone()
    t_returns[rows[has], slot[has]] = r_mean[has]
    t_stamps[rows[has], slot[has]] = buf.sample_count
    t_n = buf.tscl_n + has.int()
    n_ = t_n.clamp(0, W)
    m = torch.arange(W, device=w_ret.device)[None, :] < n_[:, None]
    zero = torch.zeros_like(t_stamps)
    nf = n_.float().clamp(min=1.0)
    x_mean = torch.where(m, t_stamps, zero).sum(-1) / nf
    y_mean = torch.where(m, t_returns, zero).sum(-1) / nf
    dx = t_stamps - x_mean[:, None]
    cov = torch.where(m, dx * (t_returns - y_mean[:, None]), zero).sum(-1)
    var = torch.where(m, dx ** 2, zero).sum(-1)
    slope = (cov / var.clamp(min=1e-8)).abs()
    scores = torch.where(has & (t_n > 1), slope, buf.scores)
    unseen = torch.where(has, torch.zeros_like(unseen), unseen)
    buf = buf.replace(tscl_returns=t_returns, tscl_stamps=t_stamps,
                      tscl_n=t_n)
    return buf, scores, unseen


def update_with_rollout(buf: PLRBuffer, cfg: PLRConfig, rollout, returns,
                        values, staging_base: Optional[int] = None):
    """Kernel B8 (a) on the card; :func:`update_with_rollout_plain` on the
    CPU.  ``rollout`` needs ``rewards``, ``dones``, ``cliffhangers`` and
    ``level_seeds`` (and ``log_dists`` for the entropy strategies)."""
    if buf.scores.device.type == 'cpu':
        return update_with_rollout_plain(buf, cfg, rollout, returns, values,
                                         staging_base)
    S = buf.capacity
    scores, unseen, grounded, staleness, st_scores, st_counts = (
        plr_kernels.score_fold(
            rollout.rewards, values, returns, rollout.dones,
            rollout.cliffhangers, rollout.level_seeds, buf.scores,
            buf.unseen, buf.grounded_values, buf.staleness, cfg,
            S if staging_base is None else staging_base))
    return (buf.replace(scores=scores, unseen=unseen,
                        grounded_values=grounded, staleness=staleness),
            st_scores, st_counts)


# ---------------------------------------------------------------------------
# Staging → working promotion (plr.py:525-643)
# ---------------------------------------------------------------------------

def level_hash(levels: torch.Tensor, mult: int) -> torch.Tensor:
    """One 32-bit lane of the content hash of each level (plr.py:566-572):
    sum over its elements b_j of b_j * (j * mult + 1), modulo 2^32, in
    int64.  A float level's elements (the walker's) are truncated toward
    zero first, as JAX's ``astype(uint32)`` casts them by value."""
    flat = levels.reshape(levels.shape[0], -1).long()
    j = torch.arange(flat.shape[1], dtype=torch.long, device=flat.device)
    k = (j * mult + 1) & _U32
    return (flat * k).sum(1) & _U32


def _staged_defaults(n, staged_solvable, staged_num_edits, device):
    if staged_solvable is None:
        staged_solvable = torch.ones(n, dtype=torch.bool, device=device)
    if staged_num_edits is None:
        staged_num_edits = torch.zeros(n, dtype=torch.int32, device=device)
    elif torch.as_tensor(staged_num_edits).dim() == 0:
        staged_num_edits = torch.full((n,), int(staged_num_edits),
                                      dtype=torch.int32, device=device)
    return staged_solvable, staged_num_edits.int()


def promote_staged_plain(buf: PLRBuffer, cfg: PLRConfig, staged_levels,
                         staged_scores, staged_counts, staged_solvable=None,
                         staged_num_edits=None) -> PLRBuffer:
    """Insert this cycle's staged levels into the buffer (plr.py:525-643).

    Duplicates of filled slots fold into them (EWA score, seen, fresh);
    then empty slots are targets first, in index order, and filled slots
    in ascending sample weight (or score); the valid staged levels, by
    descending score, take the targets in turn, and are accepted if the
    slot is empty or unseen or its score is at most theirs.
    """
    N, S = staged_scores.shape[0], buf.capacity
    dev = staged_scores.device
    staged_solvable, staged_num_edits = _staged_defaults(
        N, staged_solvable, staged_num_edits, dev)
    valid = staged_counts > 0
    if cfg.reject_unsolvable:
        valid = valid & staged_solvable
    scores, unseen, staleness = buf.scores, buf.unseen, buf.staleness

    if cfg.dedup:
        eq = buf.filled[None, :].expand(N, S)
        for mult in HASH_MULTS:
            eq = eq & (level_hash(staged_levels, mult)[:, None]
                       == level_hash(buf.levels, mult)[None, :])
        is_dup = eq.any(1) & valid
        dup_slot = eq.int().argmax(1)
        a = cfg.alpha
        new_score = (1 - a) * scores[dup_slot] + a * staged_scores
        # duplicate targets: the highest staged index wins, as JAX's
        # scatter applies its updates in order
        i = torch.arange(N, device=dev)
        later = ((dup_slot[None, :] == dup_slot[:, None])
                 & (i[None, :] > i[:, None]) & is_dup[None, :]).any(1)
        win = is_dup & ~later
        scores = scores.clone()
        scores[dup_slot[win]] = new_score[win]
        unseen = unseen.index_fill(0, dup_slot[is_dup], 0.0)
        staleness = staleness.index_fill(0, dup_slot[is_dup], 0.0)
        buf = buf.replace(scores=scores, unseen=unseen, staleness=staleness)
        valid = valid & ~is_dup

    filled = buf.filled
    empty_order = torch.argsort(filled.int(), stable=True)
    n_empty = (~filled).sum()
    if cfg.seed_buffer_priority == 'replay_support':
        prio = sample_weights_plain(buf, cfg)
    else:
        prio = scores
    inf = torch.full_like(prio, math.inf)
    evict_order = torch.argsort(torch.where(filled, prio, inf), stable=True)
    staged_rank = torch.argsort(
        torch.where(valid, -staged_scores, torch.full_like(staged_scores,
                                                           math.inf)),
        stable=True)
    k = torch.empty_like(staged_rank)
    k[staged_rank] = torch.arange(N, device=dev)
    use_empty = k < n_empty
    idx = torch.where(use_empty, empty_order[k.clamp(0, S - 1)],
                      evict_order[(k - n_empty).clamp(0, S - 1)])
    accept = valid & (k < S) & (
        use_empty | (scores[idx] <= staged_scores) | (unseen[idx] > 0)
        | ~filled[idx])

    tgt = idx[accept]
    ids = buf.next_id + torch.cumsum(accept.int(), 0) - 1

    def put(x, v):
        x = x.clone()
        x[tgt] = v[accept] if torch.is_tensor(v) and v.dim() else v
        return x
    return buf.replace(
        levels=put(buf.levels, staged_levels),
        scores=put(scores, staged_scores),
        unseen=put(unseen, 0.0),
        filled=put(filled, True),
        solvable=put(buf.solvable, staged_solvable),
        staleness=put(staleness, 0.0),
        grounded_values=put(buf.grounded_values, NEG_INF),
        num_edits=put(buf.num_edits, staged_num_edits),
        slot_ids=put(buf.slot_ids, ids.int()),
        next_id=buf.next_id + accept.sum().int(),
        sample_count=buf.sample_count + N)


def promote_staged(buf: PLRBuffer, cfg: PLRConfig, staged_levels,
                   staged_scores, staged_counts, staged_solvable=None,
                   staged_num_edits=None) -> PLRBuffer:
    """Kernel B8 (c) on the card; :func:`promote_staged_plain` on the CPU."""
    if buf.scores.device.type == 'cpu':
        return promote_staged_plain(buf, cfg, staged_levels, staged_scores,
                                    staged_counts, staged_solvable,
                                    staged_num_edits)
    staged_solvable, staged_num_edits = _staged_defaults(
        staged_scores.shape[0], staged_solvable, staged_num_edits,
        staged_scores.device)
    fields = plr_kernels.promote(
        buf, cfg, staged_levels, staged_scores, staged_counts,
        staged_solvable, staged_num_edits)
    return buf.replace(**fields)


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

def plr_stats(buf: PLRBuffer, cfg: PLRConfig) -> dict:
    w = sample_weights(buf, cfg)
    return {
        'solvable_mass': (w * buf.solvable).sum(),
        'max_score': buf.scores.max(),
        'proportion_filled': proportion_filled(buf),
        'weighted_num_edits': (w * buf.num_edits).sum(),
    }
