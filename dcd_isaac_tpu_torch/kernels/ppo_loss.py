"""Kernel B7: the PPO loss with its gradient, and the advantage
normalisation.

Replaces ``dcd_isaac_tpu/algos/ppo.py:loss_fn`` (:82-114) after the
model's forward: the categorical log-prob and entropy of the logits, the
clipped surrogate, the clipped (or smooth-L1) value loss and their
weighted sum; and the normalisation of the advantages (:142-144) with the
population std.  The CUDA source is ``csrc/ppo_loss.cu``: one thread a row,
block sums in double and a second, fixed-order pass for the means (no
atomics, so two runs give the same bits), and a one-pass backward.  It is
bound by bytes: at R = 2 097 152 rows and 7 actions about 117 MB forward
(35 us on an H100) and 185 MB backward (55 us).

:class:`PPOLoss` returns (loss, vloss, aloss, entropy) of rows (R, A)
logits and (R,) values and takes dlogits and dvalues in its backward with
autograd's rules for ``torch.minimum``, ``torch.maximum`` and ``clamp`` (a
tie sends half the gradient to each side; ``clamp`` passes its bounds).
CPU tensors take the plain twins (:func:`ppo_loss_plain`, autograd's
arithmetic, and :func:`ppo_loss_plain_backward`, the kernel's backward in
tensor ops); CUDA tensors launch the kernels or raise.

:class:`PPOLossBeta` (:func:`ppo_loss_beta`) is the loss of CarRacing's
Beta policy: (R, 3) alphas and betas and the actions unscaled to [0, 1],
the log-density and entropy through lgamma, digamma and trigamma (in
double on the card: at the clip edges a log-density reaches ~100, whose
float32 rounding puts the means more than 1e-6 relative off the exact
ones), gradients to the alphas, the betas and the values.  Its twins
are :func:`ppo_loss_beta_plain` and :func:`ppo_loss_beta_plain_backward`
(``torch.lgamma``, ``torch.digamma``, ``torch.polygamma(1, ·)``).

:class:`PPOLossGaussian` (:func:`ppo_loss_gaussian`) is the same loss for
the walker's diagonal Gaussian (``is_discrete`` false in JAX's loss_fn):
the log-prob of (R, A) actions from an (R, A) mean and one (A,) log-std,
the entropy from the log-std, and gradients to the mean, the log-std (a
sum over the rows, folded in a fixed order) and the values.  Its twins are
:func:`ppo_loss_gaussian_plain` and :func:`ppo_loss_gaussian_plain_backward`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..models.distributions import (
    BETA_HI, BETA_LO, beta_entropy, beta_log_prob, categorical_entropy,
    categorical_log_prob, normal_entropy, normal_log_prob,
)
from . import _build


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)


def ppo_loss_plain(logits, values, actions, old_log_probs, old_values,
                   returns, advs, clip_param: float, clip_value_loss: bool,
                   value_loss_coef: float, entropy_coef: float):
    """(loss, vloss, aloss, entropy) as ``algos/ppo.py:loss_fn`` computes
    them after the model (JAX ppo.py:99-114)."""
    return _ppo_terms(categorical_log_prob(logits, actions),
                      categorical_entropy(logits).mean(), values,
                      old_log_probs, old_values, returns, advs, clip_param,
                      clip_value_loss, value_loss_coef, entropy_coef)


def ratio_bounds(clip_param: float):
    """The ratio's clip bounds 1 -/+ clip rounded once to float32, as JAX
    and PyTorch round a scalar bound of a float32 clamp: a float64 twin
    clamps at the same bounds as the float32 one and the kernels."""
    return (float(np.float32(1.0 - clip_param)),
            float(np.float32(1.0 + clip_param)))


def _ppo_terms(new_log_probs, entropy, values, old_log_probs, old_values,
               returns, advs, clip_param, clip_value_loss, value_loss_coef,
               entropy_coef):
    ratio = torch.exp(new_log_probs - old_log_probs)
    surr1 = ratio * advs
    surr2 = ratio.clamp(*ratio_bounds(clip_param)) * advs
    action_loss = -torch.minimum(surr1, surr2).mean()

    if clip_value_loss:
        clipped = old_values + (values - old_values).clamp(
            -clip_param, clip_param)
        vloss = 0.5 * torch.maximum((values - returns) ** 2,
                                    (clipped - returns) ** 2).mean()
    else:
        vloss = smooth_l1(values, returns).mean()

    loss = vloss * value_loss_coef + action_loss - entropy * entropy_coef
    return loss, vloss, action_loss, entropy


def ppo_loss_gaussian_plain(mean, log_std, values, actions, old_log_probs,
                            old_values, returns, advs, clip_param: float,
                            clip_value_loss: bool, value_loss_coef: float,
                            entropy_coef: float):
    """(loss, vloss, aloss, entropy) of the diagonal Gaussian (JAX
    ppo.py:99-114 with the walker's ``log_prob_entropy``)."""
    ls = log_std.expand_as(mean)
    return _ppo_terms(normal_log_prob(mean, ls, actions),
                      normal_entropy(ls).mean(), values, old_log_probs,
                      old_values, returns, advs, clip_param,
                      clip_value_loss, value_loss_coef, entropy_coef)


def _tie_weight(a, b):
    """d min(a, b) / da: 1 where a < b, 0 where a > b, 1/2 at a tie."""
    return torch.where(a < b, 1.0, torch.where(a > b, 0.0, 0.5))


def _g_log_prob(grad_out, new_log_probs, old_log_probs, advs, clip_param):
    """d loss / d new_log_probs of the clipped surrogate (autograd's tie and
    clamp-bound rules)."""
    R = advs.shape[0]
    c_a = grad_out[0] + grad_out[2]
    ratio = torch.exp(new_log_probs - old_log_probs)
    lo, hi = ratio_bounds(clip_param)
    surr1 = ratio * advs
    surr2 = ratio.clamp(lo, hi) * advs
    w1 = _tie_weight(surr1, surr2)
    in_clip = ((ratio >= lo) & (ratio <= hi)).float()
    return (-c_a / R) * (w1 * advs + (1.0 - w1) * in_clip * advs) * ratio


def _d_values(grad_out, values, old_values, returns, clip_param,
              clip_value_loss, value_loss_coef):
    R = values.shape[0]
    c_v = grad_out[0] * value_loss_coef + grad_out[1]
    if clip_value_loss:
        d = values - old_values
        clipped = old_values + d.clamp(-clip_param, clip_param)
        d1, d2 = values - returns, clipped - returns
        w = 1.0 - _tie_weight(d1 * d1, d2 * d2)     # d max / d first
        passed = ((d >= -clip_param) & (d <= clip_param)).float()
        return (c_v * 0.5 / R) * (w * 2.0 * d1
                                  + (1.0 - w) * 2.0 * d2 * passed)
    d1 = values - returns
    return (c_v / R) * d1.abs().clamp(max=1.0) * d1.sign()


def ppo_loss_plain_backward(grad_out, logits, values, actions, old_log_probs,
                            old_values, returns, advs, clip_param: float,
                            clip_value_loss: bool, value_loss_coef: float,
                            entropy_coef: float):
    """The kernel's backward in tensor ops: the upstream gradients
    ``grad_out`` (4,) of (loss, vloss, aloss, entropy) → (dlogits, dvalues)."""
    R = values.shape[0]
    c_e = grad_out[3] - grad_out[0] * entropy_coef
    logp = torch.log_softmax(logits, -1)
    p = logp.exp()
    entropy = -(p * logp).sum(-1)
    onehot = torch.nn.functional.one_hot(actions.long(), logits.shape[-1])
    g_lp = _g_log_prob(grad_out,
                       logp.gather(-1, actions.long()[:, None])[:, 0],
                       old_log_probs, advs, clip_param)
    dlogits = (g_lp[:, None] * (onehot - p)
               - (c_e / R) * (p * (logp + entropy[:, None])))
    return dlogits, _d_values(grad_out, values, old_values, returns,
                              clip_param, clip_value_loss, value_loss_coef)


def ppo_loss_gaussian_plain_backward(grad_out, mean, log_std, values,
                                     actions, old_log_probs, old_values,
                                     returns, advs, clip_param: float,
                                     clip_value_loss: bool,
                                     value_loss_coef: float,
                                     entropy_coef: float):
    """The Gaussian kernel's backward in tensor ops: ``grad_out`` (4,) →
    (dmean (R, A), dlog_std (A,), dvalues (R,))."""
    var = torch.exp(2 * log_std)
    d = actions - mean
    lp = normal_log_prob(mean, log_std.expand_as(mean), actions)
    g_lp = _g_log_prob(grad_out, lp, old_log_probs, advs, clip_param)
    dmean = g_lp[:, None] * d / var
    c_e = grad_out[3] - grad_out[0] * entropy_coef
    dlog_std = (g_lp[:, None] * (d * d / var - 1.0)).double().sum(0) + c_e
    return dmean, dlog_std.float(), _d_values(
        grad_out, values, old_values, returns, clip_param, clip_value_loss,
        value_loss_coef)


def _flags(clip_param, clip_value_loss, value_loss_coef, entropy_coef):
    lo, hi = ratio_bounds(clip_param)
    return (ctypes.c_float(clip_param), ctypes.c_float(lo), ctypes.c_float(hi),
            int(clip_value_loss), ctypes.c_float(value_loss_coef),
            ctypes.c_float(entropy_coef))


def _beta_flags(clip_param, clip_value_loss, value_loss_coef, entropy_coef):
    # the Beta rows run in double, clamped at the float32 bounds
    lo, hi = ratio_bounds(clip_param)
    return (ctypes.c_float(clip_param), ctypes.c_double(lo),
            ctypes.c_double(hi), int(clip_value_loss),
            ctypes.c_float(value_loss_coef), ctypes.c_float(entropy_coef))


def _launch_forward(logits, values, actions, old_log_probs, old_values,
                    returns, advs, *cfg):
    R, A = logits.shape
    lib = _build.library()
    partials = torch.empty(lib.dcd_ppo_loss_workspace(R), dtype=torch.float64,
                           device=logits.device)
    out = torch.empty(4, dtype=torch.float32, device=logits.device)
    rc = lib.dcd_ppo_loss_forward(
        logits.data_ptr(), values.data_ptr(), actions.data_ptr(),
        old_log_probs.data_ptr(), old_values.data_ptr(), returns.data_ptr(),
        advs.data_ptr(), partials.data_ptr(), out.data_ptr(), R, A,
        *_flags(*cfg), torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(rc, 'ppo_loss forward')
    ppo_loss.launches += 2          # the rows, then the fixed-order fold
    return out.unbind()


def _launch_backward(grad_out, logits, values, actions, old_log_probs,
                     old_values, returns, advs, *cfg):
    R, A = logits.shape
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    rc = _build.library().dcd_ppo_loss_backward(
        logits.data_ptr(), values.data_ptr(), actions.data_ptr(),
        old_log_probs.data_ptr(), old_values.data_ptr(), returns.data_ptr(),
        advs.data_ptr(), grad_out.data_ptr(), dlogits.data_ptr(),
        dvalues.data_ptr(), R, A, *_flags(*cfg),
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(rc, 'ppo_loss backward')
    ppo_loss.launches += 1
    ppo_loss.backward_launches += 1
    return dlogits, dvalues


class PPOLoss(torch.autograd.Function):
    """``apply(logits (R, A), values, actions, old_log_probs, old_values,
    returns, advs (R,), clip_param, clip_value_loss, value_loss_coef,
    entropy_coef)`` → (loss, vloss, aloss, entropy)."""

    @staticmethod
    def forward(ctx, logits, values, actions, old_log_probs, old_values,
                returns, advs, *cfg):
        rows = (logits, values, actions, old_log_probs, old_values, returns,
                advs)
        ctx.save_for_backward(*rows)
        ctx.cfg = cfg
        if logits.device.type == 'cpu':
            return ppo_loss_plain(*rows, *cfg)
        return _launch_forward(*rows, *cfg)

    @staticmethod
    def backward(ctx, g_loss, g_v, g_a, g_e):
        grad_out = torch.stack([g_loss, g_v, g_a, g_e]).float().contiguous()
        rows = ctx.saved_tensors
        if grad_out.device.type == 'cpu':
            dlogits, dvalues = ppo_loss_plain_backward(grad_out, *rows,
                                                       *ctx.cfg)
        else:
            dlogits, dvalues = _launch_backward(grad_out, *rows, *ctx.cfg)
        return (dlogits, dvalues) + (None,) * (5 + len(ctx.cfg))


def ppo_loss(logits, values, actions, old_log_probs, old_values, returns,
             advs, clip_param: float, clip_value_loss: bool,
             value_loss_coef: float, entropy_coef: float):
    """(loss, vloss, aloss, entropy) of logits (..., A), int64 actions and
    float32 values, old log-probs, old values, returns and advantages of
    the same leading shape; differentiable in logits and values.

    CPU tensors take the twins inside :class:`PPOLoss`; CUDA tensors launch
    the kernels or raise.  ``ppo_loss.launches`` counts every kernel
    launched, two a forward pass (the rows, then the fold) and one a
    backward pass; ``ppo_loss.backward_launches`` counts the backward's
    alone.
    """
    A = logits.shape[-1]
    R = logits.numel() // A
    dev = logits.device
    rows = [logits.reshape(R, A)] + [
        t.reshape(R) for t in (values, actions, old_log_probs, old_values,
                               returns, advs)]
    names = ('logits', 'values', 'actions', 'old_log_probs', 'old_values',
             'returns', 'advs')
    for name, t in zip(names, rows):
        dtype = torch.int64 if name == 'actions' else torch.float32
        _build.check_tensor(name, t, dtype, (R, A) if t.dim() == 2 else (R,),
                            dev)
    return PPOLoss.apply(*rows, clip_param, clip_value_loss, value_loss_coef,
                         entropy_coef)


ppo_loss.launches = 0
ppo_loss.backward_launches = 0


# log(2 pi) / 2 and log(2 pi e) / 2 as float32 (the twins' constants)
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2 * math.pi * math.e)


class PPOLossGaussian(torch.autograd.Function):
    """``apply(mean (R, A), log_std (A,), values, actions (R, A),
    old_log_probs, old_values, returns, advs (R,), clip_param,
    clip_value_loss, value_loss_coef, entropy_coef)`` → (loss, vloss,
    aloss, entropy)."""

    @staticmethod
    def forward(ctx, mean, log_std, values, actions, old_log_probs,
                old_values, returns, advs, *cfg):
        rows = (mean, log_std, values, actions, old_log_probs, old_values,
                returns, advs)
        ctx.save_for_backward(*rows)
        ctx.cfg = cfg
        if mean.device.type == 'cpu':
            return ppo_loss_gaussian_plain(*rows, *cfg)
        R, A = mean.shape
        lib = _build.library()
        partials = torch.empty(lib.dcd_ppo_gauss_workspace(R),
                               dtype=torch.float64, device=mean.device)
        out = torch.empty(4, dtype=torch.float32, device=mean.device)
        rc = lib.dcd_ppo_gauss_forward(
            *(t.data_ptr() for t in rows), partials.data_ptr(),
            out.data_ptr(), R, A, *_flags(*cfg),
            ctypes.c_float(_HALF_LOG_2PI), ctypes.c_float(_HALF_LOG_2PIE),
            torch.cuda.current_stream(mean.device).cuda_stream)
        _build.check(rc, 'ppo_loss_gaussian forward')
        ppo_loss_gaussian.launches += 2     # the rows, then the fold
        return out.unbind()

    @staticmethod
    def backward(ctx, g_loss, g_v, g_a, g_e):
        grad_out = torch.stack([g_loss, g_v, g_a, g_e]).float().contiguous()
        rows = ctx.saved_tensors
        mean = rows[0]
        if mean.device.type == 'cpu':
            dmean, dls, dvalues = ppo_loss_gaussian_plain_backward(
                grad_out, *rows, *ctx.cfg)
        else:
            R, A = mean.shape
            lib = _build.library()
            partials = torch.empty(lib.dcd_ppo_gauss_workspace(R),
                                   dtype=torch.float64, device=mean.device)
            dmean = torch.empty_like(mean)
            dls = torch.empty_like(rows[1])
            dvalues = torch.empty_like(rows[2])
            rc = lib.dcd_ppo_gauss_backward(
                *(t.data_ptr() for t in rows), grad_out.data_ptr(),
                dmean.data_ptr(), dls.data_ptr(), dvalues.data_ptr(),
                partials.data_ptr(), R, A, *_flags(*ctx.cfg),
                ctypes.c_float(_HALF_LOG_2PI),
                torch.cuda.current_stream(mean.device).cuda_stream)
            _build.check(rc, 'ppo_loss_gaussian backward')
            ppo_loss_gaussian.launches += 2     # the rows, then the fold
            ppo_loss_gaussian.backward_launches += 2
        return (dmean, dls, dvalues) + (None,) * (5 + len(ctx.cfg))


def ppo_loss_gaussian(mean, log_std, values, actions, old_log_probs,
                      old_values, returns, advs, clip_param: float,
                      clip_value_loss: bool, value_loss_coef: float,
                      entropy_coef: float):
    """(loss, vloss, aloss, entropy) of a mean (..., A), a log-std (A,),
    float32 actions (..., A) and values, old log-probs, old values, returns
    and advantages of the leading shape; differentiable in the mean, the
    log-std and the values.  CPU tensors take the twins, CUDA tensors
    launch the kernels (``ppo_loss_gaussian.launches``: 2 a forward pass,
    2 a backward pass) or raise; A is at most 8."""
    A = mean.shape[-1]
    R = mean.numel() // A
    dev = mean.device
    if A > 8:
        raise ValueError(f'ppo_loss_gaussian: at most 8 actions, got {A}')
    rows = [mean.reshape(R, A), log_std, values.reshape(R),
            actions.reshape(R, A)] + [
        t.reshape(R) for t in (old_log_probs, old_values, returns, advs)]
    shapes = ((R, A), (A,), (R,), (R, A), (R,), (R,), (R,), (R,))
    names = ('mean', 'log_std', 'values', 'actions', 'old_log_probs',
             'old_values', 'returns', 'advs')
    for name, t, shape in zip(names, rows, shapes):
        _build.check_tensor(name, t, torch.float32, shape, dev)
    return PPOLossGaussian.apply(*rows, clip_param, clip_value_loss,
                                 value_loss_coef, entropy_coef)


ppo_loss_gaussian.launches = 0
ppo_loss_gaussian.backward_launches = 0


def normalize_advantages_plain(returns, values):
    """(A - mean) / (population std + 1e-5) of A = returns - values
    (JAX ppo.py:142-144)."""
    advantages = returns - values
    return (advantages - advantages.mean()) / (
        advantages.std(correction=0) + 1e-5)


def normalize_advantages(returns, values):
    """:func:`normalize_advantages_plain` of float32 tensors of one shape;
    CPU tensors take the twin, CUDA tensors launch the kernels (both
    counted in ``normalize_advantages.launches``) or raise."""
    dev = returns.device
    _build.check_tensor('returns', returns, torch.float32, returns.shape, dev)
    _build.check_tensor('values', values, torch.float32, returns.shape, dev)
    if dev.type == 'cpu':
        return normalize_advantages_plain(returns, values)
    R = returns.numel()
    lib = _build.library()
    partials = torch.empty(lib.dcd_normalize_advantages_workspace(R),
                           dtype=torch.float64, device=dev)
    out = torch.empty_like(returns)
    rc = lib.dcd_normalize_advantages(
        returns.data_ptr(), values.data_ptr(), partials.data_ptr(),
        out.data_ptr(), R, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'normalize_advantages')
    normalize_advantages.launches += 2  # the moments, then the normalisation
    return out


normalize_advantages.launches = 0


# ---- the Beta branch (CarRacing) -------------------------------------------

def ppo_loss_beta_plain(alpha, beta, values, u, old_log_probs, old_values,
                        returns, advs, clip_param: float,
                        clip_value_loss: bool, value_loss_coef: float,
                        entropy_coef: float):
    """(loss, vloss, aloss, entropy) of the Beta policy (JAX
    ppo.py:99-114 with CarRacingNetwork.log_prob_entropy) of unscaled
    actions ``u`` (R, A)."""
    return _ppo_terms(beta_log_prob(alpha, beta, u),
                      beta_entropy(alpha, beta).mean(), values,
                      old_log_probs, old_values, returns, advs, clip_param,
                      clip_value_loss, value_loss_coef, entropy_coef)


def ppo_loss_beta_plain_backward(grad_out, alpha, beta, values, u,
                                 old_log_probs, old_values, returns, advs,
                                 clip_param: float, clip_value_loss: bool,
                                 value_loss_coef: float,
                                 entropy_coef: float):
    """The Beta kernel's backward in tensor ops: ``grad_out`` (4,) →
    (dalpha (R, A), dbeta (R, A), dvalues (R,))."""
    R = values.shape[0]
    x = u.clamp(BETA_LO, BETA_HI)
    lp = beta_log_prob(alpha, beta, u)
    g_lp = _g_log_prob(grad_out, lp, old_log_probs, advs, clip_param)[:, None]
    g_ent = (grad_out[3] - grad_out[0] * entropy_coef) / R
    psi_ab = torch.digamma(alpha + beta)
    s = (alpha + beta - 2) * torch.polygamma(1, alpha + beta)
    dalpha = (g_lp * (torch.log(x) - torch.digamma(alpha) + psi_ab)
              + g_ent * (s - (alpha - 1) * torch.polygamma(1, alpha)))
    dbeta = (g_lp * (torch.log1p(-x) - torch.digamma(beta) + psi_ab)
             + g_ent * (s - (beta - 1) * torch.polygamma(1, beta)))
    return dalpha, dbeta, _d_values(grad_out, values, old_values, returns,
                                    clip_param, clip_value_loss,
                                    value_loss_coef)


class PPOLossBeta(torch.autograd.Function):
    """``apply(alpha, beta (R, 3), values, u (R, 3), old_log_probs,
    old_values, returns, advs (R,), clip_param, clip_value_loss,
    value_loss_coef, entropy_coef)`` → (loss, vloss, aloss, entropy)."""

    @staticmethod
    def forward(ctx, alpha, beta, values, u, old_log_probs, old_values,
                returns, advs, *cfg):
        rows = (alpha, beta, values, u, old_log_probs, old_values, returns,
                advs)
        ctx.save_for_backward(*rows)
        ctx.cfg = cfg
        if alpha.device.type == 'cpu':
            return ppo_loss_beta_plain(*rows, *cfg)
        R = alpha.shape[0]
        lib = _build.library()
        partials = torch.empty(lib.dcd_ppo_beta_workspace(R),
                               dtype=torch.float64, device=alpha.device)
        out = torch.empty(4, dtype=torch.float32, device=alpha.device)
        rc = lib.dcd_ppo_beta_forward(
            *(t.data_ptr() for t in rows), partials.data_ptr(),
            out.data_ptr(), R, *_beta_flags(*cfg),
            torch.cuda.current_stream(alpha.device).cuda_stream)
        _build.check(rc, 'ppo_loss_beta forward')
        ppo_loss_beta.launches += 2         # the rows, then the fold
        return out.unbind()

    @staticmethod
    def backward(ctx, g_loss, g_v, g_a, g_e):
        grad_out = torch.stack([g_loss, g_v, g_a, g_e]).float().contiguous()
        rows = ctx.saved_tensors
        alpha = rows[0]
        if alpha.device.type == 'cpu':
            da, db, dv = ppo_loss_beta_plain_backward(grad_out, *rows,
                                                      *ctx.cfg)
        else:
            da, db = torch.empty_like(alpha), torch.empty_like(rows[1])
            dv = torch.empty_like(rows[2])
            rc = _build.library().dcd_ppo_beta_backward(
                *(t.data_ptr() for t in rows), grad_out.data_ptr(),
                da.data_ptr(), db.data_ptr(), dv.data_ptr(),
                alpha.shape[0], *_beta_flags(*ctx.cfg),
                torch.cuda.current_stream(alpha.device).cuda_stream)
            _build.check(rc, 'ppo_loss_beta backward')
            ppo_loss_beta.launches += 1
            ppo_loss_beta.backward_launches += 1
        return (da, db, dv) + (None,) * (5 + len(ctx.cfg))


def ppo_loss_beta(alpha, beta, values, u, old_log_probs, old_values,
                  returns, advs, clip_param: float, clip_value_loss: bool,
                  value_loss_coef: float, entropy_coef: float):
    """(loss, vloss, aloss, entropy) of alphas and betas (..., 3), the
    actions unscaled to [0, 1] (..., 3) and values, old log-probs, old
    values, returns and advantages of the leading shape; differentiable in
    the alphas, the betas and the values.  CPU tensors take the twins,
    CUDA tensors launch the kernels (``ppo_loss_beta.launches``: 2 a
    forward pass, 1 a backward pass) or raise."""
    A = alpha.shape[-1]
    R = alpha.numel() // A
    dev = alpha.device
    if A != 3:
        raise ValueError(f'ppo_loss_beta: 3 actions, got {A}')
    rows = [alpha.reshape(R, A), beta.reshape(R, A), values.reshape(R),
            u.reshape(R, A)] + [
        t.reshape(R) for t in (old_log_probs, old_values, returns, advs)]
    shapes = ((R, A), (R, A), (R,), (R, A), (R,), (R,), (R,), (R,))
    names = ('alpha', 'beta', 'values', 'u', 'old_log_probs', 'old_values',
             'returns', 'advs')
    for name, t, shape in zip(names, rows, shapes):
        _build.check_tensor(name, t, torch.float32, shape, dev)
    return PPOLossBeta.apply(*rows, clip_param, clip_value_loss,
                             value_loss_coef, entropy_coef)


ppo_loss_beta.launches = 0
ppo_loss_beta.backward_launches = 0
