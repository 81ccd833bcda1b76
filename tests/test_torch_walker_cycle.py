"""The walker's training path of the port against the JAX package, on the
CPU: the Gaussian distribution, the student at converted weights, kernel
B7's Gaussian branch, the flat PPO update, the VecNormalize rollout, the
PLR buffer with float levels, and whole walker PLR⊥ and ACCEL sequences.

Randomness is injected, never shared: numpy draws the data and the action
scripts, the JAX package draws the replay levels and PPO permutations and
both sides get them.  The JAX walker builds the port's terrains
(``test_torch_walker.FakeRandom`` with the port's seed hash inside the JAX
terrain and env modules) and its level edits read the port's uniforms; the
JAX env runs through ``no_fma`` (see ``test_torch_walker.py``).  The env
runs at ``max_steps`` 8, so 16-step rollouts end episodes by falls and by
the step limit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcd_isaac_tpu.envs.walker.env as jax_env
import dcd_isaac_tpu.envs.walker.terrain as jax_terrain
from dcd_isaac_tpu.algos import ppo as jax_ppo
from dcd_isaac_tpu.algos import rollout as jax_rollout
from dcd_isaac_tpu.algos.storage import Rollout as JaxRollout
from dcd_isaac_tpu.algos.storage import (
    batched_value_loss as jax_bvl, compute_gae as jax_compute_gae,
)
from dcd_isaac_tpu.envs.walker import AdversarialWalker as JaxWalker
from dcd_isaac_tpu.envs.walker import WalkerParams as JaxWalkerParams
from dcd_isaac_tpu.level_replay import plr as jplr
from dcd_isaac_tpu.models import distributions as jdist
from dcd_isaac_tpu.models.walker_models import (
    WalkerStudentPolicy as JaxStudent,
)
from dcd_isaac_tpu_torch import train
from dcd_isaac_tpu_torch.algos.ppo import (
    PPOConfig, init_agent_state, make_ppo_update,
)
from dcd_isaac_tpu_torch.algos.rollout import (
    RolloutConfig, initial_step_carry, make_student_rollout,
)
from dcd_isaac_tpu_torch.algos.storage import Rollout
from dcd_isaac_tpu_torch.arguments import parser
from dcd_isaac_tpu_torch.convert import from_flax_walker
from dcd_isaac_tpu_torch.envs import registry
from dcd_isaac_tpu_torch.envs.walker.adversarial import (
    AdversarialWalker, WalkerParams, mutate_draws,
)
from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
from dcd_isaac_tpu_torch.level_replay import plr
from dcd_isaac_tpu_torch.models import distributions as dist
from dcd_isaac_tpu_torch.models.walker_models import WalkerStudentPolicy
from dcd_isaac_tpu_torch.runner.adversarial_runner import AdversarialRunner
from test_torch_algos import rollout_keys
from test_torch_plr import assert_buffers
from test_torch_walker import (
    fake_jax, jnp_hash_uniform, no_fma, table_random,
)

T, N, S = 16, 4, 8
MAX_STEPS = 8
CLIP = 0.2
# bipedal_accel.json's student settings at the test's sizes
ACCEL_FLAGS = [
    '--env_name', 'BipedalWalker-Adversarial-Easy-v0',
    '--ued_algo', 'domain_randomization', '--num_processes', str(N),
    '--num_steps', str(T), '--ppo_epoch', '2', '--num_mini_batch', '2',
    '--normalize_returns', 'true', '--recurrent_agent', 'false',
    '--lr', '3e-4', '--max_grad_norm', '0.5', '--gamma', '0.99',
    '--gae_lambda', '0.9', '--value_loss_coef', '0.5',
    '--entropy_coef', '0.001', '--clip_value_loss', 'false',
    '--clip_param', '0.2', '--handle_timelimits', 'true',
    '--use_plr', 'true', '--level_replay_strategy', 'positive_value_loss',
    '--level_replay_score_transform', 'rank', '--level_replay_prob', '0.9',
    '--level_replay_rho', '0.5', '--level_replay_seed_buffer_size', str(S),
    '--staleness_coef', '0.5', '--no_exploratory_grad_updates', 'true',
    '--use_editor', 'true', '--level_editor_prob', '1.0',
    '--level_editor_method', 'random', '--num_edits', '3',
    '--base_levels', 'easy', '--log_replay_complexity', 'true', '--seed', '1']
ROBUST_PLR_FLAGS = ACCEL_FLAGS[:ACCEL_FLAGS.index('--use_editor')] + [
    '--log_replay_complexity', 'true', '--env_name',
    'BipedalWalker-Adversarial-v0', '--level_replay_prob', '0.5']


@pytest.fixture
def hashed(monkeypatch):
    fake = fake_jax(jnp_hash_uniform)
    monkeypatch.setattr(jax_terrain, 'jax', fake)
    monkeypatch.setattr(jax_env, 'jax', fake)


def t(x):
    return torch.tensor(np.asarray(x))


def student_pair(seed=0):
    jnet = JNET
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((N, 24)), (),
                       jnp.ones(N))
    net = WalkerStudentPolicy()
    net.load_state_dict(from_flax_walker(jax.tree.map(np.asarray, params)))
    return jnet, params, net


def assert_params_close(jax_params, net, atol):
    want = from_flax_walker(jax.tree.map(np.asarray, jax_params))
    for name, p in net.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


# -- the Gaussian and the student -------------------------------------------

def test_gaussian_log_prob_entropy_and_sample():
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(6, 4)).astype(np.float32)
    log_std = rng.normal(size=4).astype(np.float32) * 0.5
    a = rng.normal(size=(6, 4)).astype(np.float32) * 2
    ls = np.broadcast_to(log_std, mean.shape)
    np.testing.assert_allclose(
        dist.normal_log_prob(t(mean), t(log_std), t(a)).numpy(),
        np.asarray(jdist.normal_log_prob(mean, ls, a)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        dist.normal_entropy(t(log_std)).numpy(),
        np.asarray(jdist.normal_entropy(log_std)), atol=1e-6, rtol=0)
    g = torch.Generator().manual_seed(3)
    x = dist.normal_sample(t(mean[:1]).expand(200_000, 4), t(log_std), g)
    np.testing.assert_allclose(x.mean(0).numpy(), mean[0], atol=0.02)
    np.testing.assert_allclose(x.std(0).numpy(), np.exp(log_std), rtol=0.02)


def test_student_forward_matches_flax_at_converted_weights():
    jnet, params, net = student_pair(seed=2)
    obs = np.random.default_rng(1).normal(size=(T, N, 24)).astype(np.float32)
    out, value, _ = jnet.apply(params, obs, (), None)
    got, gv, carry = net({'obs': t(obs)})
    assert carry == () and net.initial_carry((N,)) == ()
    np.testing.assert_allclose(got['mean'].detach().numpy(),
                               np.asarray(out['mean']), atol=1e-5)
    np.testing.assert_allclose(gv.detach().numpy(), np.asarray(value),
                               atol=1e-5)
    np.testing.assert_array_equal(got['log_std'].detach().numpy(),
                                  np.asarray(out['log_std'])[0, 0])
    seq, sv, _ = net.sequence({'obs': t(obs)}, (), None)
    assert torch.equal(seq['mean'], got['mean']) and torch.equal(sv, gv)


# -- kernel B7's Gaussian branch ---------------------------------------------

def gauss_rows(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    R = 64
    mean, values = f(R, 4), f(R)
    log_std = f(4) * 0.3
    actions = mean + f(R, 4) * np.exp(log_std)
    lp = np.asarray(jdist.normal_log_prob(
        mean, np.broadcast_to(log_std, mean.shape), actions))
    old_lp = lp + f(R) * 0.3
    old_lp[:16] = lp[:16]                       # ratio exactly 1 (JAX side)
    old_v = values + f(R) * 0.3
    old_v[16:32] = values[16:32]                # value ties
    return dict(mean=mean, log_std=log_std, values=values, actions=actions,
                old_lp=old_lp.astype(np.float32), old_v=old_v,
                returns=values + f(R), advs=f(R))


def jax_gauss_loss(mean, log_std, values, actions, old_lp, old_v, returns,
                   advs, clip_value_loss, entropy_coef):
    """dcd_isaac_tpu/algos/ppo.py:loss_fn after the model (:99-114) with
    the walker student's log_prob_entropy."""
    ls = jnp.broadcast_to(log_std, mean.shape)
    new_lp = jdist.normal_log_prob(mean, ls, actions)
    entropy = jdist.normal_entropy(ls).mean()
    ratio = jnp.exp(new_lp - old_lp)
    surr1 = ratio * advs
    surr2 = jnp.clip(ratio, 1.0 - CLIP, 1.0 + CLIP) * advs
    action_loss = -jnp.minimum(surr1, surr2).mean()
    if clip_value_loss:
        clipped = old_v + jnp.clip(values - old_v, -CLIP, CLIP)
        vloss = 0.5 * jnp.maximum((values - returns) ** 2,
                                  (clipped - returns) ** 2).mean()
    else:
        vloss = jax_ppo.smooth_l1(values, returns).mean()
    loss = vloss * 0.5 + action_loss - entropy * entropy_coef
    return loss, (vloss, action_loss, entropy)


@pytest.mark.parametrize('clip_value_loss', [True, False])
@pytest.mark.parametrize('entropy_coef', [0.0, 0.001])
def test_ppo_loss_gaussian_matches_jax_grad(clip_value_loss, entropy_coef):
    """The loss and its four terms 1e-6 relative, and the gradients to the
    mean, the log-std and the values within 1e-5 of jax.grad's largest
    entry (a mean's gradient scales as 1/R) plus 1e-5 relative."""
    x = gauss_rows(0)
    (loss, aux), grads = jax.value_and_grad(
        jax_gauss_loss, argnums=(0, 1, 2), has_aux=True)(
        *x.values(), clip_value_loss, entropy_coef)
    mean, ls, values = (t(x[k]).requires_grad_() for k in
                        ('mean', 'log_std', 'values'))
    out = pl.ppo_loss_gaussian(
        mean, ls, values, t(x['actions']), t(x['old_lp']), t(x['old_v']),
        t(x['returns']), t(x['advs']), CLIP, clip_value_loss, 0.5,
        entropy_coef)
    for got, want in zip(out, (loss, *aux)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6,
                                   atol=1e-7)
    got_grads = torch.autograd.grad(out[0], (mean, ls, values))
    for g, w in zip(got_grads, grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert np.abs(np.asarray(grads[1])).max() > 0


def test_ppo_loss_gaussian_hand_backward_matches_autograd():
    """The kernel's backward in tensor ops against autograd through the
    plain forward, every output differentiated."""
    x = gauss_rows(1)
    mean, ls, values = (t(x[k]).requires_grad_() for k in
                        ('mean', 'log_std', 'values'))
    rest = [t(x[k]) for k in ('actions', 'old_lp', 'old_v', 'returns',
                              'advs')]
    rest = [rest[0], rest[1], rest[2], rest[3], rest[4]]
    out = pl.ppo_loss_gaussian_plain(mean, ls, values, *rest, CLIP, True,
                                     0.5, 0.01)
    g_out = torch.tensor([1.0, 0.3, -0.7, 0.2])
    want = torch.autograd.grad(out, (mean, ls, values), g_out.unbind())
    got = pl.ppo_loss_gaussian_plain_backward(
        g_out, mean.detach(), ls.detach(), values.detach(), *rest, CLIP,
        True, 0.5, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


# -- the flat PPO update ------------------------------------------------------

def test_flat_ppo_update_matches_jax():
    """One update (2 epochs × 2 minibatches of the T·N rows) from the same
    params with the JAX update's row permutations injected: params within
    1e-5, stats 1e-5."""
    jnet, params, net = student_pair(seed=3)
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(T, N, 24)).astype(np.float32)
    out, values, _ = jnet.apply(params, obs, (), None)
    actions = (np.asarray(out['mean'])
               + rng.normal(size=(T, N, 4)).astype(np.float32))
    lp = jdist.normal_log_prob(out['mean'], out['log_std'], actions)
    old_lp = np.asarray(lp) + rng.normal(scale=0.3, size=(T, N)
                                         ).astype(np.float32)
    returns = (np.asarray(values) + rng.normal(size=(T, N))
               ).astype(np.float32)
    masks = np.ones((T, N), np.float32)
    cfg_kw = dict(ppo_epoch=2, num_mini_batch=2, entropy_coef=0.001,
                  lr=3e-4, clip_value_loss=False)
    jcfg = jax_ppo.PPOConfig(**cfg_kw)
    jstate = jax_ppo.AgentTrainState(
        params=params, opt_state=jax_ppo.make_optimizer(jcfg).init(params))
    z = np.zeros((T, N), np.float32)
    jro = JaxRollout(**{k: jnp.asarray(v) for k, v in dict(
        obs=obs, actions=actions, log_probs=old_lp, log_dists=z,
        values=values, rewards=z, masks_pre=masks, dones=z.astype(bool),
        bad_masks=z + 1, cliffhangers=z.astype(bool), trunc_values=z,
        level_seeds=z.astype(np.int32)).items()})
    key = jax.random.PRNGKey(9)
    jnew, jstats = jax_ppo.make_ppo_update(jnet, jcfg, N)(
        jstate, jro, jnp.asarray(returns), (), key, False)
    perms = jax.vmap(lambda r: jax.random.permutation(r, T * N))(
        jax.random.split(key, jcfg.ppo_epoch))

    ro = Rollout(obs={'obs': t(obs)}, actions=t(actions),
                 log_probs=t(old_lp), values=t(values), rewards=t(z),
                 masks_pre=t(masks), dones=t(z).bool(), bad_masks=t(z + 1),
                 trunc_values=t(z))
    cfg = PPOConfig(**cfg_kw)
    stats = make_ppo_update(net, cfg, N)(
        init_agent_state(net, cfg), ro, t(returns), (), None, False,
        perms=t(perms))
    assert_params_close(jnew.params, net, atol=1e-5)
    for k in ('value_loss', 'action_loss', 'dist_entropy', 'grad_norm'):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


# -- the VecNormalize rollout ------------------------------------------------

class ScriptedJaxWalker:
    """The flax walker student whose action draw returns the script's
    action of step t, t found from the step's action key.  The script
    rides in the params (``{'net', 'keys', 'actions'}``) and comes out with
    the policy's output, so one compiled rollout serves every script."""
    dist_type = 'normal'
    is_recurrent = False

    def __init__(self, net):
        self.net = net

    def apply(self, params, *args, **kw):
        out, value, carry = self.net.apply(params['net'], *args, **kw)
        return ({**out, 'keys': params['keys'],
                 'actions': params['actions']}, value, carry)

    def initial_carry(self, batch_dims):
        return ()

    def sample_action(self, rng, out):
        t_ = jnp.argmax(jnp.all(out['keys'] == rng[None], axis=-1))
        a = out['actions'][t_]
        return a, jdist.normal_log_prob(out['mean'], out['log_std'], a)


_COMPILED = {}


def compiled(name, make):
    """One jitted, FMA-free JAX function per name for the whole module (the
    walker's rollout and resets take seconds to compile)."""
    if name not in _COMPILED:
        _COMPILED[name] = jax.jit(no_fma(make()))
    return _COMPILED[name]


def jax_rollout_fn(jenv, jnet):
    """The JAX student rollout (VecNormalize, time limits, same-level
    resets) of the scripted walker, compiled once."""
    return compiled('rollout', lambda: jax_rollout.make_student_rollout(
        jenv, ScriptedJaxWalker(jnet),
        jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True,
                                  normalize_returns_gamma=0.99)))


def scripted_params(params, act_keys, actions):
    return {'net': params, 'keys': act_keys,
            'actions': jnp.asarray(actions, jnp.float32)}


def action_script(rng, steps, n):
    return rng.normal(size=(steps, n, 4)).astype(np.float32)


def easy_levels(rng, n, seed0=100):
    """n easy-range levels with their seeds (numpy (n, 9))."""
    lv = np.zeros((n, 9), np.float32)
    lv[:, 0] = rng.uniform(0, 0.6, n)
    lv[:, 2] = 0.8
    lv[:, 4] = lv[:, 6] = 0.4
    lv[:, 7] = 1.0
    lv[:, 8] = seed0 + np.arange(n)
    return lv


JENV = JaxWalker(JaxWalkerParams(mode='easy', max_steps=MAX_STEPS))
JNET = JaxStudent()


def walker_envs():
    return JENV, AdversarialWalker(WalkerParams(mode='easy',
                                                max_steps=MAX_STEPS))


def jax_reset_to_level(levels):
    return compiled('reset_to_level', lambda: jax.vmap(JENV.reset_to_level))(
        levels)


def test_vecnormalize_rollout_matches_jax(hashed):
    """A 16-step rollout with VecNormalize (gamma 0.99) and time-limit
    bootstrapping from the same levels, weights, actions and statistics:
    obs, normalised rewards, dones, bad masks within 1e-5 (values and
    log-probs 1e-5), the running statistics carried out 1e-5 relative."""
    jenv, env = walker_envs()
    jnet, params, net = student_pair(seed=5)
    rng = np.random.default_rng(6)
    levels = easy_levels(rng, N)
    acts = action_script(rng, T, N)
    key = jax.random.PRNGKey(2)
    act_keys, _ = rollout_keys(key, T, N)
    jst, jobs = jax_reset_to_level(jnp.asarray(levels))
    rms0 = (jnp.asarray(rng.normal(size=N), jnp.float32), jnp.float32(0.3),
            jnp.float32(2.0), jnp.float32(40.0))
    carry = jax_rollout.initial_step_carry(jenv, jnet, jst, jobs, key,
                                           ret_rms=rms0)
    jfinal, jsteps, jnext, jstats = jax_rollout_fn(jenv, jnet)(
        scripted_params(params, act_keys, acts), carry)

    st, obs = env.reset_to_level(t(levels))
    c = initial_step_carry(net, st, obs, ret_rms=tuple(map(t, rms0)))
    final, steps, nv, stats = make_student_rollout(
        env, net, RolloutConfig(num_steps=T, handle_timelimits=True,
                                normalize_returns_gamma=0.99),
        sample_action_fn=lambda out, k: torch.tensor(acts[k]))(c)
    close = lambda a, b, tol=1e-5, name='': np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), atol=tol,
        rtol=tol, err_msg=name)
    close(steps.obs['obs'], jsteps.obs, name='obs')
    close(steps.rewards, jsteps.rewards, name='rewards')
    close(steps.values, jsteps.values, name='values')
    close(steps.log_probs, jsteps.log_probs, name='log_probs')
    close(steps.trunc_values, jsteps.trunc_values, name='trunc_values')
    for f in ('dones', 'bad_masks', 'cliffhangers'):
        np.testing.assert_array_equal(getattr(steps, f).numpy(),
                                      np.asarray(getattr(jsteps, f)), f)
    close(nv, jnext, name='next_value')
    for a, b in zip(final.ret_rms, (jfinal.ret_accum, jfinal.rms_mean,
                                    jfinal.rms_var, jfinal.rms_count)):
        close(a, b, name='ret_rms')
    for k in stats:
        close(stats[k], jstats[k], name=k)
    assert int(stats['episode_count'].sum()) >= N      # falls or the limit
    assert float(steps.bad_masks.min()) == 0.0          # a truncation


# -- PLR with float levels ----------------------------------------------------

def test_promote_float_levels_matches_jax():
    """Walker levels (9,) float32 through promote_staged: empty slots
    first, then evictions, with staged copies of levels already in the
    buffer (the value-cast hash finds them) and two staged twins."""
    rng = np.random.default_rng(11)
    jcfg = jplr.PLRConfig(capacity=S, num_actors=6, strategy='value_l1',
                          score_transform='rank', staleness_coef=0.5)
    cfg = plr.PLRConfig(capacity=S, num_actors=6, strategy='value_l1',
                        score_transform='rank', staleness_coef=0.5)
    jbuf = jplr.init_plr(jcfg, (9,), jnp.float32)
    buf = plr.init_plr(cfg, (9,), 'cpu', level_dtype=torch.float32)
    for r in range(3):
        lv = easy_levels(rng, 6, seed0=1000 * r + 7)
        lv[:, 8] += rng.integers(0, 1 << 23, 6)      # large seeds
        if r:
            filled = np.flatnonzero(np.asarray(jbuf.filled))
            lv[:2] = np.asarray(jbuf.levels)[filled[:2]]   # duplicates
            lv[2:4] += 0.25                    # same truncations as others
            lv[5] = lv[4]                                  # staged twins
        sc = rng.random(6).astype(np.float32)
        cnt = np.array([1, 1, 0, 2, 1, 1], np.float32)
        jbuf = jplr.promote_staged(jbuf, jcfg, jnp.asarray(lv),
                                   jnp.asarray(sc), jnp.asarray(cnt))
        buf = plr.promote_staged(buf, cfg, t(lv), t(sc), t(cnt))
        assert_buffers(buf, jbuf, exact=('levels',))
    assert bool(buf.filled.all())


# -- whole walker PLR⊥ and ACCEL sequences ----------------------------------

def plr_config(args):
    return jplr.PLRConfig(
        capacity=S, num_actors=N, strategy=args.level_replay_strategy,
        score_transform=args.level_replay_score_transform,
        temperature=args.level_replay_temperature,
        rho=args.level_replay_rho, replay_prob=args.level_replay_prob,
        staleness_coef=args.staleness_coef, gamma=args.gamma)


class JaxSequence:
    """The runner's walker cycles rebuilt from the JAX package's public
    functions: the student, a PLR buffer and VecNormalize's statistics
    carried across cycles."""

    def __init__(self, args, jenv, jnet, params):
        self.args, self.jenv, self.jnet = args, jenv, jnet
        self.cfg = jax_ppo.PPOConfig(
            clip_param=args.clip_param, ppo_epoch=args.ppo_epoch,
            num_mini_batch=args.num_mini_batch,
            value_loss_coef=args.value_loss_coef,
            entropy_coef=args.entropy_coef, lr=args.lr, eps=args.eps,
            max_grad_norm=args.max_grad_norm,
            clip_value_loss=args.clip_value_loss)
        self.state = jax_ppo.AgentTrainState(
            params=params,
            opt_state=jax_ppo.make_optimizer(self.cfg).init(params))
        self.plr_cfg = plr_config(args)
        self.buf = jplr.init_plr(self.plr_cfg, (9,), jnp.float32)
        self.ret_rms = (jnp.zeros(N), jnp.float32(0.0), jnp.float32(1.0),
                        jnp.float32(1e-4))

    def phase(self, env_states, seeds, actions, key, discard,
              reset_seeds=None):
        """Rollout, GAE, PLR fold, PPO update → (staged scores, counts,
        easy metric, the update's row permutations)."""
        args, jenv = self.args, self.jenv
        r_ro, r_upd = jax.random.split(key)
        act_keys, reset_keys = rollout_keys(r_ro, T, N)
        fn = jax_rollout_fn(jenv, self.jnet)
        if reset_seeds is not None:
            flat = jnp.asarray(reset_seeds.reshape(-1), jnp.int32)
            levels = self.buf.levels

            def reset_fn(rng, state, seed):
                s = flat[jnp.argmax(jnp.all(reset_keys == rng[None], -1))]
                state, obs = jenv.reset_to_level(levels[s])
                return state, obs, s
            fn = jax.jit(no_fma(jax_rollout.make_student_rollout(
                jenv, ScriptedJaxWalker(self.jnet),
                jax_rollout.RolloutConfig(num_steps=T, handle_timelimits=True,
                                          normalize_returns_gamma=0.99),
                reset_fn=reset_fn)))
        st, obs = compiled('reset_agent',
                           lambda: jax.vmap(jenv.reset_agent))(env_states)
        carry = jax_rollout.initial_step_carry(
            jenv, self.jnet, st, obs, r_ro, level_seeds=seeds,
            ret_rms=self.ret_rms)
        final, steps, next_value, ro = fn(
            scripted_params(self.state.params, act_keys, actions), carry)
        self.ret_rms = (final.ret_accum, final.rms_mean, final.rms_var,
                        final.rms_count)
        returns = jax_compute_gae(steps, next_value, args.gamma,
                                  args.gae_lambda,
                                  use_proper_time_limits=True)
        self.buf, st_s, st_c = jplr.update_with_rollout(
            self.buf, self.plr_cfg, steps, returns, steps.values)
        easy = ro['mean_return'] - jax_bvl(returns, steps.values)
        update = _COMPILED.setdefault(
            ('update', self.cfg), jax.jit(jax_ppo.make_ppo_update(
                self.jnet, self.cfg, N), static_argnums=()))
        self.state, _ = update(self.state, steps, returns, (), r_upd,
                               discard)
        perms = jax.vmap(lambda r: jax.random.permutation(r, T * N))(
            jax.random.split(r_upd, self.cfg.ppo_epoch))
        return st_s, st_c, easy, torch.tensor(np.asarray(perms))

    def promote(self, env_states, st_s, st_c, num_edits=None):
        levels = jax.vmap(self.jenv.get_level)(env_states)
        self.buf = jplr.promote_staged(
            self.buf, self.plr_cfg, levels, st_s, st_c,
            staged_num_edits=num_edits)


def assert_buffers_close(got, want):
    """Levels, ids and masks exact; scores, staleness and grounded values
    within 1e-5 + 1e-5 relative (the rewards are divided by VecNormalize's
    running std, so a value's float32 error scales with its size)."""
    for f in dataclasses.fields(plr.PLRBuffer):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if a.dtype.kind == 'f' and f.name != 'levels':
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def script(actions):
    return lambda out, k: torch.tensor(actions[k])


@pytest.mark.parametrize('method', ['robust_plr', 'accel'])
def test_walker_plr_sequence_matches_jax_reference(monkeypatch, hashed,
                                                   method):
    """PLR⊥: a generate cycle (gradients discarded, levels staged and
    promoted) then a replay cycle (levels drawn from the buffer, mid-rollout
    replay resets building terrains, scores folded, a gradient step), with
    VecNormalize's statistics carried through.  ACCEL adds an edit cycle:
    the 4 'easy' replayed levels mutated by 3 edits and a new seed,
    evaluated without a gradient step and promoted with one edit more.  The
    buffer within 1e-5 (levels exact), the params within 1e-4."""
    flags = ACCEL_FLAGS if method == 'accel' else ROBUST_PLR_FLAGS
    args = parser.parse_args(flags)
    jenv, env = walker_envs()
    jnet, jparams, net = student_pair(seed=7)
    ref = JaxSequence(args, jenv, jnet, jparams)
    rng = np.random.default_rng(40)
    acts = [action_script(rng, T, N) for _ in range(3)]
    k_gen, k_rep, k_draw, k_edit = jax.random.split(jax.random.PRNGKey(3), 4)

    levels0 = easy_levels(rng, N)
    gen_states, _ = jax_reset_to_level(jnp.asarray(levels0))
    st_s, st_c, _, perms_gen = ref.phase(
        gen_states, jnp.arange(N, dtype=jnp.int32) + S, acts[0], k_gen,
        discard=True)
    ref.promote(gen_states, st_s, st_c)
    assert int(np.asarray(ref.buf.filled).sum()) == N

    seeds, rep_levels, ref.buf = jplr.sample_replay_levels(
        ref.buf, ref.plr_cfg, k_draw, N)
    filled = np.flatnonzero(np.asarray(ref.buf.filled))
    reset_seeds = rng.choice(filled, (T, N)).astype(np.int32)
    rep_states, _ = jax_reset_to_level(rep_levels)
    _, _, easy, perms_rep = ref.phase(rep_states, seeds, acts[1], k_rep,
                                      discard=False,
                                      reset_seeds=reset_seeds)
    inject = dict(sample_action_fn=script(acts[1]), replay=True,
                  replay_seeds=t(seeds),
                  replay_reset_seeds=lambda k: t(reset_seeds[k]),
                  perms={'agent': perms_rep})
    if method == 'accel':
        parents = np.tile(np.asarray(seeds)[np.argsort(np.asarray(easy))[:4]],
                          N // 4)
        par_states, _ = jax_reset_to_level(ref.buf.levels[parents])
        draws = rng.random((N, mutate_draws(args.num_edits))
                           ).astype(np.float32)
        e = args.num_edits
        table_random(monkeypatch, draws,
                     lambda k: jnp.where(k[2] == 0, 3 * e,
                                         3 * k[1].astype(jnp.int32)
                                         + k[2].astype(jnp.int32) - 1))
        keys = jnp.stack([jnp.arange(N, dtype=jnp.uint32),
                          jnp.zeros(N, jnp.uint32),
                          jnp.zeros(N, jnp.uint32)], 1)
        par_states, _ = jax.jit(no_fma(jax.vmap(
            lambda s, k: jenv.mutate_level(s, k, e))))(par_states, keys)
        st_s, st_c, _, perms_edit = ref.phase(
            par_states, jnp.arange(N, dtype=jnp.int32) + S, acts[2], k_edit,
            discard=True)
        ref.promote(par_states, st_s, st_c, ref.buf.num_edits[parents] + 1)
        inject.update(edit_coin=0.5, edit_sample_fn=script(acts[2]),
                      mutation_draws=t(draws))
        inject['perms']['agent_edit'] = perms_edit

    runner = AdversarialRunner(args, env, {'agent': net}, 'cpu')
    before = {k: v.clone() for k, v in net.state_dict().items()}
    s_gen = runner.run(levels=t(levels0), replay=False,
                       sample_action_fn=script(acts[0]),
                       perms={'agent': perms_gen})
    assert all(torch.equal(v, before[k]) for k, v in
               net.state_dict().items())      # PLR⊥ discards this step
    s_rep = runner.run(**inject)

    assert_buffers_close(runner.plr_buffer, ref.buf)
    assert_params_close(ref.state.params, net, atol=1e-4)
    assert max(float((v - before[k]).abs().max())
               for k, v in net.state_dict().items()) > 1e-4
    for a, b in zip(runner.ret_rms, ref.ret_rms):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert (s_gen['level_replay'], s_rep['level_replay']) == (0, 1)
    edits = 1 if method == 'accel' else 0
    assert s_rep['total_num_edits'] == edits
    assert s_rep['steps'] == (2 + edits) * N * T
    # the walker's env stats: plain on the generate cycle, 'plr_' on replay
    assert 'ground_roughness' in s_gen and 'plr_ground_roughness' in s_rep
    np.testing.assert_allclose(s_gen['ground_roughness'],
                               levels0[:, 0].mean(), rtol=1e-6)
    if method == 'accel':
        assert int(np.asarray(ref.buf.num_edits).max()) >= 1


# -- the training entry point ------------------------------------------------

@pytest.fixture
def short_walkers(monkeypatch):
    """The registry's walkers with an 8-step limit, so 16-step rollouts end
    episodes and stage levels."""
    make = registry.make_walker_env

    def short(name):
        env = make(name)
        env.params = dataclasses.replace(env.params, max_steps=MAX_STEPS)
        return env
    monkeypatch.setattr(registry, 'make_walker_env', short)


@pytest.mark.parametrize('config', ['accel', 'robust_plr', 'dr', 'poet'])
def test_train_runs_walker_configs(short_walkers, capsys, config):
    """train.main at the four configurations' flags (bipedal_accel,
    bipedal_robust_plr, bipedal_dr, bipedal_accel_poet; checkpointing
    off), small: every stat finite, the walker env stats in every line."""
    flags = {'accel': ACCEL_FLAGS, 'robust_plr': ROBUST_PLR_FLAGS,
             'dr': ROBUST_PLR_FLAGS + ['--level_replay_prob', '0.0',
                                       '--no_exploratory_grad_updates',
                                       'false'],
             'poet': ACCEL_FLAGS + ['--env_name',
                                    'BipedalWalker-POET-Easy-v0']}[config]
    cycles = 2 if config == 'accel' else 1
    runner, history = train.main(flags + ['--no_cuda', 'true',
                                          '--num_env_steps',
                                          str(cycles * N * T)])
    assert len(history) == cycles
    for s in history:
        assert all(math.isfinite(float(v)) for v in s.values()), s
        assert any(k.endswith('ground_roughness') for k in s)
    assert runner.ret_rms is not None
    assert float(runner.ret_rms[3]) > 1.0          # T·N returns counted
    if config == 'poet':
        assert float(runner.plr_buffer.levels[:, 5:8].abs().max()) == 0.0
    if config == 'accel':
        assert history[-1]['proportion_filled'] > 0


@pytest.mark.parametrize('flags,err', [
    (['--env_name', 'BipedalWalker-v3'], NotImplementedError),
    (['--env_name', 'BipedalWalkerHardcore-v3'], NotImplementedError),
    (['--ued_algo', 'paired'], NotImplementedError),
    (['--use_popart', 'true'], NotImplementedError),
    (['--recurrent_agent', 'true', '--recurrent_arch', 'gru'],
     NotImplementedError),
])
def test_unported_walker_settings_are_refused(flags, err):
    with pytest.raises(err):
        train.main(ACCEL_FLAGS + ['--no_cuda', 'true', '--num_env_steps',
                                  '0'] + flags)
