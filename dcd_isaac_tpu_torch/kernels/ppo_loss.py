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
"""

from __future__ import annotations

import ctypes

import torch

from ..models.distributions import categorical_entropy, categorical_log_prob
from . import _build


def smooth_l1(pred, target):
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)


def ppo_loss_plain(logits, values, actions, old_log_probs, old_values,
                   returns, advs, clip_param: float, clip_value_loss: bool,
                   value_loss_coef: float, entropy_coef: float):
    """(loss, vloss, aloss, entropy) as ``algos/ppo.py:loss_fn`` computes
    them after the model (JAX ppo.py:99-114)."""
    new_log_probs = categorical_log_prob(logits, actions)
    entropy = categorical_entropy(logits).mean()

    ratio = torch.exp(new_log_probs - old_log_probs)
    surr1 = ratio * advs
    surr2 = ratio.clamp(1.0 - clip_param, 1.0 + clip_param) * advs
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


def _tie_weight(a, b):
    """d min(a, b) / da: 1 where a < b, 0 where a > b, 1/2 at a tie."""
    return torch.where(a < b, 1.0, torch.where(a > b, 0.0, 0.5))


def ppo_loss_plain_backward(grad_out, logits, values, actions, old_log_probs,
                            old_values, returns, advs, clip_param: float,
                            clip_value_loss: bool, value_loss_coef: float,
                            entropy_coef: float):
    """The kernel's backward in tensor ops: the upstream gradients
    ``grad_out`` (4,) of (loss, vloss, aloss, entropy) → (dlogits, dvalues)."""
    R = values.shape[0]
    g_loss, g_v, g_a, g_e = grad_out.unbind()
    c_v = g_loss * value_loss_coef + g_v
    c_a = g_loss + g_a
    c_e = g_e - g_loss * entropy_coef
    logp = torch.log_softmax(logits, -1)
    p = logp.exp()
    entropy = -(p * logp).sum(-1)
    onehot = torch.nn.functional.one_hot(actions.long(), logits.shape[-1])
    ratio = torch.exp(logp.gather(-1, actions.long()[:, None])[:, 0]
                      - old_log_probs)
    lo, hi = 1.0 - clip_param, 1.0 + clip_param
    surr1 = ratio * advs
    surr2 = ratio.clamp(lo, hi) * advs
    w1 = _tie_weight(surr1, surr2)
    in_clip = ((ratio >= lo) & (ratio <= hi)).float()
    g_lp = (-c_a / R) * (w1 * advs + (1.0 - w1) * in_clip * advs) * ratio
    dlogits = (g_lp[:, None] * (onehot - p)
               - (c_e / R) * (p * (logp + entropy[:, None])))
    if clip_value_loss:
        d = values - old_values
        clipped = old_values + d.clamp(-clip_param, clip_param)
        d1, d2 = values - returns, clipped - returns
        w = 1.0 - _tie_weight(d1 * d1, d2 * d2)     # d max / d first
        passed = ((d >= -clip_param) & (d <= clip_param)).float()
        dvalues = (c_v * 0.5 / R) * (w * 2.0 * d1
                                     + (1.0 - w) * 2.0 * d2 * passed)
    else:
        d1 = values - returns
        dvalues = (c_v / R) * d1.abs().clamp(max=1.0) * d1.sign()
    return dlogits, dvalues


def _flags(clip_param, clip_value_loss, value_loss_coef, entropy_coef):
    # the ratio's bounds rounded once to fp32, as PyTorch rounds clamp's
    return (ctypes.c_float(clip_param), ctypes.c_float(1.0 - clip_param),
            ctypes.c_float(1.0 + clip_param), int(clip_value_loss),
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
