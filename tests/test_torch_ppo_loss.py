"""Kernel B7's plain twins and ``PPOLoss`` against the JAX PPO loss.

R = 16 * 8 rows of A = 7 logits, fp32 on the CPU, inputs from a numpy
seed.  The JAX side is the arithmetic of ``dcd_isaac_tpu/algos/ppo.py``
``loss_fn`` after the model (:99-114), with the package's own
``categorical_log_prob``, ``categorical_entropy`` and ``smooth_l1``;
``jax.grad`` gives its gradient in the logits and values.  Both value-loss
branches, entropy coefficients 0 and 0.01, and rows whose ratio is exactly
1 and whose values equal the old values (ties of min and max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_isaac_tpu.algos import ppo as jax_ppo
from dcd_isaac_tpu.models.distributions import (
    categorical_entropy as jax_entropy,
    categorical_log_prob as jax_log_prob,
)
from dcd_isaac_tpu_torch.kernels import _build
from dcd_isaac_tpu_torch.kernels import ppo_loss as pl
from dcd_isaac_tpu_torch.models.distributions import categorical_log_prob

T, N, A = 16, 8, 7
CLIP = 0.2
VALUE_COEF = 0.5


def jax_loss(logits, values, actions, old_lp, old_v, returns, advs,
             clip_value_loss, entropy_coef):
    new_lp = jax_log_prob(logits, actions)
    entropy = jax_entropy(logits).mean()
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
    loss = vloss * VALUE_COEF + action_loss - entropy * entropy_coef
    return loss, (vloss, action_loss, entropy)


def make_rows(seed, actions=A):
    """(T, N) rows; a quarter of them with old log-probs equal to the new
    ones (ratio exactly 1, set per framework below) and old values equal
    to the values."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    logits, values = f(T, N, actions), f(T, N)
    x = dict(logits=logits, values=values,
             actions=rng.integers(0, actions, (T, N)).astype(np.int64),
             old_lp=f(T, N) * 0.3 - 2.0, old_v=values + f(T, N) * 0.3,
             returns=values + f(T, N), advs=f(T, N))
    tie = rng.random((T, N)) < 0.25
    x['old_v'] = np.where(tie, values, x['old_v'])
    x['tie'] = tie
    return x


def jax_case(x, clip_value_loss, entropy_coef):
    new_lp = np.asarray(jax_log_prob(x['logits'], x['actions']))
    old_lp = np.where(x['tie'], new_lp, x['old_lp'])
    grad_fn = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)
    (loss, aux), (g_logits, g_values) = grad_fn(
        x['logits'], x['values'], x['actions'], old_lp, x['old_v'],
        x['returns'], x['advs'], clip_value_loss, entropy_coef)
    return [np.asarray(v) for v in (loss, *aux)], np.asarray(g_logits), \
        np.asarray(g_values)


def torch_rows(x):
    t = {k: torch.tensor(v) for k, v in x.items() if k != 'tie'}
    new_lp = categorical_log_prob(t['logits'], t['actions'])
    t['old_lp'] = torch.where(torch.tensor(x['tie']), new_lp, t['old_lp'])
    return t


CASES = [(cv, ec, A) for cv in (True, False) for ec in (0.0, 0.01)]
# the teacher's 13 x 13 placements
TEACHER_CASE = (True, 0.0, 169)


@pytest.mark.parametrize('clip_value_loss,entropy_coef,actions',
                         CASES + [TEACHER_CASE])
def test_ppo_loss_matches_jax(clip_value_loss, entropy_coef, actions):
    x = make_rows(int(clip_value_loss) * 2 + int(entropy_coef > 0), actions)
    want, want_gl, want_gv = jax_case(x, clip_value_loss, entropy_coef)
    t = torch_rows(x)
    ratio = torch.exp(categorical_log_prob(t['logits'], t['actions'])
                      - t['old_lp'])
    assert int((ratio == 1.0).sum()) == int(x['tie'].sum()) > 0
    logits = t['logits'].requires_grad_()
    values = t['values'].requires_grad_()
    args = (logits, values, t['actions'], t['old_lp'], t['old_v'],
            t['returns'], t['advs'], CLIP, clip_value_loss, VALUE_COEF,
            entropy_coef)
    plain = pl.ppo_loss_plain(*args)
    out = pl.ppo_loss(*args)
    for k in range(4):
        np.testing.assert_allclose(plain[k].item(), want[k], atol=1e-6,
                                   rtol=0)
        assert out[k].item() == plain[k].item()
    g_logits, g_values = torch.autograd.grad(out[0], (logits, values))
    np.testing.assert_allclose(g_logits.numpy(), want_gl, atol=1e-7, rtol=1e-5)
    np.testing.assert_allclose(g_values.numpy(), want_gv, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize('clip_value_loss,entropy_coef,actions',
                         CASES + [TEACHER_CASE])
def test_hand_backward_matches_autograd_of_the_twin(clip_value_loss,
                                                    entropy_coef, actions):
    """All four outputs carry an upstream gradient, as when a caller
    differentiates the aux losses too; ties of min and max included."""
    x = make_rows(10, actions)
    t = torch_rows(x)
    upstream = torch.tensor([1.0, 0.3, -0.7, 2.0])
    grads = []
    for fn in (pl.ppo_loss, pl.ppo_loss_plain):
        logits = t['logits'].clone().requires_grad_()
        values = t['values'].clone().requires_grad_()
        out = fn(logits, values, t['actions'], t['old_lp'], t['old_v'],
                 t['returns'], t['advs'], CLIP, clip_value_loss, VALUE_COEF,
                 entropy_coef)
        grads.append(torch.autograd.grad(out, (logits, values),
                                         tuple(upstream)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)


def exact_ratio_old_log_probs(lp, ratio):
    """Old log-probs for which exp(lp - old) is exactly ``ratio`` in fp32,
    found by stepping ulps away from lp - log(ratio)."""
    old = lp - torch.log(ratio)
    for _ in range(64):
        got = torch.exp(lp - old)
        if torch.equal(got, ratio):
            return old
        old = torch.where(got > ratio, torch.nextafter(old, old + 1),
                          torch.where(got < ratio,
                                      torch.nextafter(old, old - 1), old))
    raise AssertionError('no exact ratio found')


def test_clip_bounds_pass_the_gradient():
    """A ratio exactly at 1 ± clip and a value change exactly at ±clip take
    clamp's gradient, as autograd gives it."""
    logits = torch.zeros((4, A))
    logits[:, 0] = 1.8      # p near 1/2: ulps of old log-probs fine enough
    actions = torch.zeros(4, dtype=torch.int64)
    lp = categorical_log_prob(logits, actions)
    ratio = torch.tensor([1.0 - CLIP, 1.0 + CLIP, 1.0 - CLIP, 1.0 + CLIP])
    old_lp = exact_ratio_old_log_probs(lp, ratio)
    old_v = torch.zeros(4)
    values = torch.tensor([CLIP, -CLIP, CLIP, -CLIP])
    assert torch.equal(values - old_v, values)
    returns = torch.tensor([2.0, -2.0, -1.0, 1.0])
    advs = torch.tensor([1.0, -1.0, -1.0, 1.0])
    grads = []
    for fn in (pl.ppo_loss, pl.ppo_loss_plain):
        lg = logits.clone().requires_grad_()
        v = values.clone().requires_grad_()
        out = fn(lg, v, actions, old_lp, old_v, returns, advs, CLIP, True,
                 VALUE_COEF, 0.0)
        grads.append(torch.autograd.grad(out[0], (lg, v)))
    assert bool((grads[1][0].abs() > 1e-3).any() and (grads[1][1] != 0).all())
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_normalize_advantages_matches_jax():
    rng = np.random.default_rng(7)
    returns = rng.normal(size=(T, N)).astype(np.float32) + 3.0
    values = rng.normal(size=(T, N)).astype(np.float32)
    adv = jnp.asarray(returns) - jnp.asarray(values)
    want = (adv - adv.mean()) / (adv.std() + 1e-5)
    got = pl.normalize_advantages(torch.tensor(returns), torch.tensor(values))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_cpu_takes_the_twins_without_building(monkeypatch):
    def refuse(*a, **k):
        raise RuntimeError('kernel build requested')
    monkeypatch.setattr(_build, 'build', refuse)
    monkeypatch.setattr(_build, 'library', refuse)
    t = torch_rows(make_rows(11))
    args = (t['logits'], t['values'], t['actions'], t['old_lp'], t['old_v'],
            t['returns'], t['advs'], CLIP, True, VALUE_COEF, 0.01)
    counts = (pl.ppo_loss.launches, pl.ppo_loss.backward_launches,
              pl.normalize_advantages.launches)
    assert all(torch.equal(a, b) for a, b in zip(pl.ppo_loss(*args),
                                                 pl.ppo_loss_plain(*args)))
    pl.normalize_advantages(t['returns'], t['values'])
    assert counts == (pl.ppo_loss.launches, pl.ppo_loss.backward_launches,
                      pl.normalize_advantages.launches)
    meta = [a.to('meta') if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match='kernel build requested'):
        pl.ppo_loss(*meta)
    with pytest.raises(RuntimeError, match='kernel build requested'):
        pl.normalize_advantages(meta[5], meta[1])
    with pytest.raises(TypeError):
        pl.ppo_loss(args[0], args[1], args[2].int(), *args[3:])
    with pytest.raises(ValueError):
        pl.normalize_advantages(t['returns'], t['values'][:, :3])
