"""The port's PLR buffer (``level_replay/plr.py``, kernel B8's plain twins)
against the JAX package's, on the CPU.

Both sides start from the same buffer (``convert.from_jax_plr``) and the
same rollout arrays, made with numpy from a seed: the score fold for every
strategy, the sample weights for every transform, the promotion with
duplicates and full or empty buffers, the replay decision and draws, and
the stats.  JAX draws with ``jax.random.choice`` and the port with
``torch.multinomial``, so the seeds JAX drew are injected into the port.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.level_replay import plr as jplr
from dcd_isaac_tpu_torch.convert import from_jax_plr
from dcd_isaac_tpu_torch.kernels import _build
from dcd_isaac_tpu_torch.kernels import plr as plr_kernels
from dcd_isaac_tpu_torch.level_replay import plr

T, N, S = 16, 8, 64
LEVEL = (15, 15, 3)
STRATEGIES = ['uniform', 'random', 'off', 'sequential', 'policy_entropy',
              'least_confidence', 'min_margin', 'gae', 'signed_value_loss',
              'value_l1', 'alt_advantage_abs', 'positive_value_loss',
              'grounded_signed_value_loss', 'grounded_positive_value_loss',
              'one_step_td_error', 'tscl_window']
TRANSFORMS = ['constant', 'max', 'eps_greedy', 'rank', 'power', 'softmax',
              'match', 'match_rank']


def configs(**kw):
    """The same settings as a JAX PLRConfig and the port's."""
    kw = dict(capacity=S, num_actors=N, **kw)
    return jplr.PLRConfig(**kw), plr.PLRConfig(**kw)


def random_levels(rng, n):
    levels = np.zeros((n, *LEVEL), np.uint8)
    levels[..., 0] = rng.choice([1, 2], (n, 15, 15), p=[0.7, 0.3])
    levels[..., 1] = np.where(levels[..., 0] == 2, 5, 0)
    levels[:, 3, 4] = (8, 1, 0)
    levels[:, 5, 6] = (10, 0, 1)
    return levels


def jax_buffer(rng, filled=0.7, tied=True):
    """A JAX buffer with filled and empty slots, scores with ties, seen and
    unseen slots, stale slots and known and unknown grounded values."""
    full = rng.random(S) < filled
    scores = rng.normal(size=S).astype(np.float32)
    if tied:
        scores = np.round(scores * 2) / 2
    scores[~full] = 0.0
    unseen = np.where(full & (rng.random(S) < 0.8), 0.0, 1.0)
    grounded = np.where(rng.random(S) < 0.5, rng.random(S),
                        jplr.NEG_INF).astype(np.float32)
    W = 10
    return jplr.PLRBuffer(
        levels=jnp.asarray(random_levels(rng, S) * full[:, None, None, None]),
        scores=jnp.asarray(scores, jnp.float32),
        staleness=jnp.asarray(rng.integers(0, 40, S), jnp.float32),
        unseen=jnp.asarray(unseen, jnp.float32),
        filled=jnp.asarray(full), solvable=jnp.asarray(rng.random(S) < 0.9),
        grounded_values=jnp.asarray(grounded),
        num_edits=jnp.asarray(rng.integers(0, 4, S), jnp.int32),
        slot_ids=jnp.asarray(np.where(full, np.arange(S), -1), jnp.int32),
        next_id=jnp.int32(S), sample_count=jnp.float32(123.0),
        tscl_returns=jnp.asarray(rng.random((S, W)), jnp.float32),
        tscl_stamps=jnp.asarray(rng.random((S, W)) * 100, jnp.float32),
        tscl_n=jnp.asarray(rng.integers(0, 12, S), jnp.int32))


def port_buffer(jbuf):
    return from_jax_plr(jax.tree.map(np.asarray, jbuf))


def random_rollout(rng, per_step_seeds=False, staging_base=S):
    """Rollout arrays: sparse rewards, episodes of 1-6 steps with a forced
    final done (a cliffhanger where it was not a real end), each episode
    on a working seed (with repeats), a staged seed or no seed."""
    dones = rng.random((T, N)) < 0.25
    cliff = np.zeros((T, N), bool)
    cliff[-1] = ~dones[-1]
    dones[-1] = True
    seeds = np.zeros((T, N), np.int32)
    for n in range(N):
        t0 = 0
        for t in range(T):
            if t == t0:
                kind = rng.random()
                seed = (rng.integers(0, 6) if kind < 0.5 else
                        staging_base + n if kind < 0.8 else -1)
            seeds[t, n] = seed
            if dones[t, n]:
                t0 = t + 1
    if per_step_seeds:
        seeds = rng.integers(-1, S + N, (T, N)).astype(np.int32)
    logits = rng.normal(size=(T, N, 7)).astype(np.float32)
    log_dists = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return dict(
        rewards=(rng.random((T, N)) * (rng.random((T, N)) < 0.3)
                 ).astype(np.float32),
        dones=dones, cliffhangers=cliff, level_seeds=seeds,
        log_dists=log_dists.astype(np.float32),
        values=rng.normal(size=(T, N)).astype(np.float32),
        returns=rng.normal(size=(T, N)).astype(np.float32))


def fold_both(jbuf, jcfg, cfg, ro, staging_base=None):
    jro = SimpleNamespace(**{k: jnp.asarray(v) for k, v in ro.items()})
    want = jplr.update_with_rollout(jbuf, jcfg, jro, jro.returns, jro.values,
                                    staging_base)
    pro = SimpleNamespace(**{k: torch.tensor(v) for k, v in ro.items()})
    got = plr.update_with_rollout(port_buffer(jbuf), cfg, pro, pro.returns,
                                  pro.values, staging_base)
    return got, want


def assert_buffers(got: plr.PLRBuffer, want, atol=1e-5, exact=()):
    for f in dataclasses.fields(plr.PLRBuffer):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if a.dtype.kind == 'f' and f.name not in exact:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


# -- update_with_rollout ---------------------------------------------------

@pytest.mark.parametrize('strategy', STRATEGIES)
def test_update_with_rollout_matches_jax(strategy):
    """Scores, staged sums and grounded values within 1e-5; unseen,
    staleness and the staged counts exact."""
    rng = np.random.default_rng(STRATEGIES.index(strategy))
    jcfg, cfg = configs(strategy=strategy)
    jbuf = jax_buffer(rng)
    for _ in range(2):      # a second rollout folds into the first's
        ro = random_rollout(rng)
        (buf, st, cnt), (jbuf, jst, jcnt) = fold_both(jbuf, jcfg, cfg, ro)
        assert_buffers(buf, jbuf, exact=('unseen', 'staleness'))
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert (np.asarray(jcnt) > 0).any()
    assert (np.asarray(jbuf.unseen) == 0).sum() > (0.7 * 0.8 - 0.2) * S


@pytest.mark.parametrize('case', ['dense_grounded', 'no_staleness',
                                  'alpha_half', 'max_score', 'any_seeds',
                                  'staging_base'])
def test_update_with_rollout_settings_match_jax(case):
    """The fold's other settings: dense rewards, staleness off, alpha 0.5
    (the EWA's weights below 1), the max-score mix, seeds that change
    inside an episode, a staging base below the capacity."""
    kw = {'dense_grounded': dict(strategy='grounded_signed_value_loss',
                                 use_dense_rewards=True),
          'no_staleness': dict(strategy='value_l1', staleness_coef=0.0),
          'alpha_half': dict(strategy='positive_value_loss', alpha=0.5),
          'max_score': dict(strategy='value_l1', max_score_coef=0.5),
          'any_seeds': dict(strategy='grounded_positive_value_loss'),
          'staging_base': dict(strategy='gae')}[case]
    rng = np.random.default_rng(7)
    jcfg, cfg = configs(**kw)
    base = 40 if case == 'staging_base' else None
    ro = random_rollout(rng, per_step_seeds=case == 'any_seeds',
                        staging_base=base or S)
    (buf, st, cnt), (jbuf, jst, jcnt) = fold_both(jax_buffer(rng), jcfg,
                                                  cfg, ro, base)
    assert_buffers(buf, jbuf, exact=('unseen', 'staleness'))
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


# -- sample_weights -------------------------------------------------------

@pytest.mark.parametrize('stale', ['power', 'rank', 'off'])
@pytest.mark.parametrize('transform', TRANSFORMS)
def test_sample_weights_match_jax(transform, stale):
    """Every transform with tied scores and, but for 'off', the staleness
    mix; 1e-6."""
    rng = np.random.default_rng(TRANSFORMS.index(transform))
    kw = dict(score_transform=transform, temperature=0.3)
    if stale == 'off':
        kw['staleness_coef'] = 0.0
    else:
        kw['staleness_transform'] = stale
    if transform in ('match', 'match_rank'):
        kw['temperature'] = 1.0
    jcfg, cfg = configs(**kw)
    jbuf = jax_buffer(rng)
    if transform in ('match', 'match_rank'):
        jbuf = jbuf.replace(scores=jnp.asarray(rng.random(S) * 0.9 + 0.05,
                                               jnp.float32))
    got = plr.sample_weights(port_buffer(jbuf), cfg)
    want = np.asarray(jplr.sample_weights(jbuf, jcfg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert abs(float(got.sum()) - 1) < 1e-5


def test_sample_weights_of_an_unscored_buffer_are_uniform_over_seen():
    jcfg, cfg = configs(score_transform='rank')
    jbuf = jax_buffer(np.random.default_rng(3))
    jbuf = jbuf.replace(scores=jnp.zeros(S), staleness=jnp.zeros(S))
    got = plr.sample_weights(port_buffer(jbuf), cfg).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jplr.sample_weights(jbuf, jcfg)), atol=1e-6, rtol=0)


def test_block_sum_is_the_kernels_tree():
    x = torch.rand(4000, generator=torch.Generator().manual_seed(0))
    partial = torch.zeros(1024)
    for i in range(4000):
        partial[i % 1024] += x[i]
    s = 512
    while s:
        partial = partial[:s] + partial[s:2 * s]
        s //= 2
    assert torch.equal(plr.block_sum(x), partial[0])


# -- promote_staged -------------------------------------------------------

def staged_from(rng, jbuf, n_dups, n_twins):
    """N staged levels: ``n_dups`` copies of filled slots, ``n_twins``
    pairs equal to each other, the rest new; scores with ties, some
    without a completed episode."""
    levels = random_levels(rng, N)
    filled = np.flatnonzero(np.asarray(jbuf.filled))
    buf_levels = np.asarray(jbuf.levels)
    for i in range(n_dups):
        levels[i] = buf_levels[filled[i % len(filled)]]
    for i in range(n_twins):
        levels[N - 1 - i] = levels[N - 2 - i] if i % 2 == 0 else levels[0]
    scores = np.round(rng.normal(size=N) * 2) / 2
    counts = np.where(rng.random(N) < 0.8, rng.integers(1, 4, N), 0)
    return (levels, scores.astype(np.float32), counts.astype(np.float32),
            rng.random(N) < 0.7, rng.integers(1, 5, N).astype(np.int32))


@pytest.mark.parametrize('case', ['mixed', 'empty', 'full', 'few_free',
                                  'score_priority', 'reject_unsolvable',
                                  'no_dedup'])
def test_promote_staged_matches_jax(case):
    """Levels, ids, masks and counters byte-exact, floats within 1e-6."""
    rng = np.random.default_rng(['mixed', 'empty', 'full', 'few_free',
                                 'score_priority', 'reject_unsolvable',
                                 'no_dedup'].index(case))
    kw = {'score_priority': dict(seed_buffer_priority='score'),
          'reject_unsolvable': dict(reject_unsolvable=True),
          'no_dedup': dict(dedup=False)}.get(case, {})
    jcfg, cfg = configs(score_transform='rank', temperature=0.1, **kw)
    filled = {'empty': 0.0, 'full': 1.0, 'few_free': 1 - 3 / S}.get(case, 0.6)
    jbuf = jax_buffer(rng, filled)
    if case == 'few_free':      # N > free slots
        full = np.ones(S, bool)
        full[[5, 17, 40]] = False
        jbuf = jbuf.replace(filled=jnp.asarray(full))
    n_dups = 0 if case == 'empty' else 3
    levels, scores, counts, solv, edits = staged_from(rng, jbuf, n_dups, 2)
    want = jplr.promote_staged(jbuf, jcfg, jnp.asarray(levels),
                               jnp.asarray(scores), jnp.asarray(counts),
                               jnp.asarray(solv), jnp.asarray(edits))
    got = plr.promote_staged(port_buffer(jbuf), cfg, torch.tensor(levels),
                             torch.tensor(scores), torch.tensor(counts),
                             torch.tensor(solv), torch.tensor(edits))
    assert_buffers(got, want, atol=1e-6)
    moved = (np.asarray(want.slot_ids) != np.asarray(jbuf.slot_ids)).sum()
    assert moved > 0 or case == 'full'


def test_promote_staged_folds_duplicates_into_their_slot():
    """Two staged copies of one filled slot: the slot keeps its level, its
    score is the EWA with the later copy's score (JAX's scatter order), it
    becomes seen and fresh, and nothing is inserted for them."""
    jcfg, cfg = configs(alpha=0.5)
    rng = np.random.default_rng(11)
    jbuf = jax_buffer(rng, filled=1.0)
    levels, scores, counts, solv, edits = staged_from(rng, jbuf, 0, 0)
    levels[2] = levels[5] = np.asarray(jbuf.levels)[9]
    counts[[2, 5]] = 1.0
    scores[[2, 5]] = [10.0, 20.0]
    args = (levels, scores, counts, solv, edits)
    want = jplr.promote_staged(jbuf, jcfg, *map(jnp.asarray, args))
    got = plr.promote_staged(port_buffer(jbuf), cfg,
                             *map(torch.tensor, args))
    assert_buffers(got, want, atol=1e-6)
    old = float(np.asarray(jbuf.scores)[9])
    assert float(got.scores[9]) == pytest.approx(0.5 * old + 0.5 * 20.0)
    assert float(got.unseen[9]) == 0.0 and float(got.staleness[9]) == 0.0


def test_level_hash_lanes_match_jax_uint32():
    """The two content-hash lanes, computed in int64 and masked, equal JAX's
    uint32 products and sums with wrap-around (plr.py:566-577)."""
    levels = random_levels(np.random.default_rng(0), 20)
    levels[3] = 255
    for mult in plr.HASH_MULTS:
        flat = jnp.asarray(levels.reshape(20, -1), jnp.uint32)
        k = (jnp.arange(flat.shape[1], dtype=jnp.uint32) * jnp.uint32(mult)
             + jnp.uint32(1))
        want = np.asarray((flat * k[None, :]).sum(-1))
        got = plr.level_hash(torch.tensor(levels), mult).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


# -- replay decision, replay and unseen draws, stats ----------------------

@pytest.mark.parametrize('schedule', ['proportionate', 'fixed'])
@pytest.mark.parametrize('full_distribution', [True, False])
def test_sample_replay_decision_matches_jax(schedule, full_distribution):
    jcfg, cfg = configs(replay_schedule=schedule, rho=0.5, replay_prob=0.6,
                        full_distribution=full_distribution)
    rng = np.random.default_rng(5)
    decisions = set()
    for i in range(40):
        jbuf = jax_buffer(rng, filled=rng.random())
        if i % 7 == 0:
            jbuf = jbuf.replace(unseen=jnp.zeros(S))
        key = jax.random.PRNGKey(i)
        want = bool(jplr.sample_replay_decision(jbuf, jcfg, key))
        u = float(jax.random.uniform(key))
        got = bool(plr.sample_replay_decision(port_buffer(jbuf), cfg, u))
        assert got == want, i
        decisions.add(got)
    assert decisions == {True, False}


@pytest.mark.parametrize('draw', ['replay', 'unseen'])
@pytest.mark.parametrize('staleness_coef', [0.3, 0.0])
def test_sample_levels_match_jax(draw, staleness_coef):
    """With the seeds JAX drew injected, the port's levels, staleness and
    sample count equal JAX's; the seeds JAX drew carry weight."""
    jcfg, cfg = configs(staleness_coef=staleness_coef)
    jbuf = jax_buffer(np.random.default_rng(8))
    jfn, fn = {'replay': (jplr.sample_replay_levels,
                          plr.sample_replay_levels),
               'unseen': (jplr.sample_unseen_levels,
                          plr.sample_unseen_levels)}[draw]
    seeds, levels, want = jfn(jbuf, jcfg, jax.random.PRNGKey(0), N)
    got_seeds, got_levels, got = fn(port_buffer(jbuf), cfg, N,
                                    seeds=torch.tensor(np.asarray(seeds)))
    np.testing.assert_array_equal(got_seeds.numpy(), np.asarray(seeds))
    np.testing.assert_array_equal(got_levels.numpy(), np.asarray(levels))
    assert_buffers(got, want, exact=('staleness', 'sample_count'))
    if draw == 'replay':
        w = np.asarray(jplr.sample_weights(jbuf, jcfg))
        assert (w[np.asarray(seeds)] > 0).all()
    # the port's own draw lands on weighted slots only
    gen = torch.Generator().manual_seed(0)
    own, _, _ = fn(port_buffer(jbuf), cfg, 500, gen)
    w = (plr.sample_weights(port_buffer(jbuf), cfg) if draw == 'replay'
         else port_buffer(jbuf).unseen)
    assert (w[own.long()] > 0).all()


def test_plr_stats_match_jax():
    jcfg, cfg = configs(score_transform='rank', temperature=0.1)
    jbuf = jax_buffer(np.random.default_rng(9))
    got = plr.plr_stats(port_buffer(jbuf), cfg)
    want = jplr.plr_stats(jbuf, jcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6,
                                   err_msg=k)


def test_init_plr_matches_jax():
    jcfg, cfg = configs()
    assert_buffers(plr.init_plr(cfg, LEVEL, 'cpu'), jplr.init_plr(jcfg,
                                                                   LEVEL))
    levels = random_levels(np.random.default_rng(0), S)
    assert_buffers(plr.init_plr(cfg, LEVEL, 'cpu', levels=torch.tensor(
        levels)), jplr.init_plr(jcfg, LEVEL, levels=jnp.asarray(levels)))


# -- the kernel wrappers: twins on the CPU, no fallback off it ------------

def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError('kernel build requested')
    monkeypatch.setattr(_build, 'build', refuse)
    monkeypatch.setattr(_build, 'library', refuse)


def _meta(buf):
    return plr.PLRBuffer(**{f.name: getattr(buf, f.name).to('meta')
                            for f in dataclasses.fields(plr.PLRBuffer)})


def test_plr_on_the_cpu_builds_nothing_and_counts_no_launch(monkeypatch):
    _no_build(monkeypatch)
    counts = (plr_kernels.score_fold.launches,
              plr_kernels.sample_weights.launches,
              plr_kernels.promote.launches)
    rng = np.random.default_rng(0)
    jcfg, cfg = configs(strategy='positive_value_loss')
    fold_both(jax_buffer(rng), jcfg, cfg, random_rollout(rng))
    buf = port_buffer(jax_buffer(rng))
    plr.plr_stats(buf, cfg)
    levels, scores, counts_, solv, edits = staged_from(rng, jax_buffer(rng),
                                                       2, 0)
    plr.promote_staged(buf, cfg, *map(torch.tensor, (levels, scores,
                                                     counts_, solv, edits)))
    assert counts == (plr_kernels.score_fold.launches,
                      plr_kernels.sample_weights.launches,
                      plr_kernels.promote.launches)


@pytest.mark.parametrize('entry', ['fold', 'weights', 'promote'])
def test_plr_off_the_cpu_never_falls_back_to_the_twin(monkeypatch, entry):
    _no_build(monkeypatch)
    rng = np.random.default_rng(1)
    cfg = configs(strategy='grounded_signed_value_loss')[1]
    buf = _meta(port_buffer(jax_buffer(rng)))
    with pytest.raises(RuntimeError, match='kernel build requested'):
        if entry == 'weights':
            plr.sample_weights(buf, cfg)
        elif entry == 'fold':
            ro = SimpleNamespace(**{k: torch.tensor(v).to('meta') for k, v
                                    in random_rollout(rng).items()})
            plr.update_with_rollout(buf, cfg, ro, ro.returns, ro.values)
        else:
            st = [torch.tensor(v).to('meta') for v in staged_from(
                rng, jax_buffer(rng), 0, 0)]
            plr.promote_staged(buf, cfg, *st)


@pytest.mark.parametrize('setting', [dict(strategy='policy_entropy'),
                                     dict(strategy='tscl_window'),
                                     dict(score_transform='softmax'),
                                     dict(staleness_transform='max')])
def test_settings_without_a_kernel_raise_on_the_card(monkeypatch, setting):
    """The strategies and transforms kernel B8 does not take raise off the
    CPU before anything is built, and run on the CPU."""
    _no_build(monkeypatch)
    rng = np.random.default_rng(2)
    cfg = configs(**setting)[1]
    buf = port_buffer(jax_buffer(rng))
    ro = SimpleNamespace(**{k: torch.tensor(v) for k, v
                            in random_rollout(rng).items()})
    plr.update_with_rollout(buf, cfg, ro, ro.returns, ro.values)
    plr.sample_weights(buf, cfg)
    meta = _meta(buf)
    mro = SimpleNamespace(**{k: v.to('meta') for k, v in vars(ro).items()})
    with pytest.raises(NotImplementedError, match='CPU only'):
        if 'strategy' in setting:
            plr.update_with_rollout(meta, cfg, mro, mro.returns, mro.values)
        else:
            plr.sample_weights(meta, cfg)
