"""Kernel B2: the MultiGrid student's fused policy step.

Replaces ``dcd_isaac_tpu/models/multigrid_models.py:98-103`` ``__call__``
(with ``_embed`` :75-89, ``common.py``'s LSTM cell and ``_heads`` :91-96)
and ``models/distributions.py:17-25`` (``categorical_sample``,
``categorical_log_prob``) for one rollout step of a batch of students.
Per row: the (V, V, 3) uint8 view / 10, a 3x3 VALID conv with 16 filters
and ReLU flattened (h, w, c), the one-hot direction through the 4 -> 5
embed, the mask reset of (c, h), the LSTM cell (``w_i`` (4H, F), ``w_h``
(4H, H) + bias, gate order i, f, g, o), the 32-32 tanh actor and critic
trunks, the logits and the value; then, by mode:

* ``'forward'``: logits, value and the new carry (the model's one step);
* ``'sample'``: also an action, the inverse CDF of softmax(logits) at the
  row's uniform ``u`` (``distributions.categorical_inverse_cdf``), and
  its log-prob;
* ``'action'``: the log-prob of the given ``action`` (injected actions);
* ``'value'``: the value alone, no carry written (the truncation and
  bootstrap values of a rollout).

The CUDA source is ``csrc/multigrid_policy.cu``: one CTA of H threads per
tile of rows, the embed and h in shared memory, each thread owning four
gate columns of ``w_i``/``w_h`` stored [k][4H] and read coalesced from L2.
Its weights (about 1.7 MB at H = 256) do not fit in shared memory.  At
B = 32 it is bound by the weights' bytes (0.5 us), at B = 8192 by
operations (about 7 GFLOP, 0.11 ms at the fp32 peak).

:func:`policy_step` takes the plain twin (:func:`policy_step_plain`, the
model's forward written on the weights) for CPU tensors, and launches the
kernel or raises for CUDA tensors.  The kernel has no backward: the PPO
update's BPTT runs the model's ``sequence`` (kernel B3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.distributions import categorical_inverse_cdf
from . import _build

MODES = ('forward', 'sample', 'action', 'value')
# The kernel's shape rules (csrc/multigrid_policy.cu): 16 conv filters of
# 3x3 over a V x V view, a 4 -> 5 scalar embed, trunks of 32 and 32, at
# most 32 actions, H a multiple of 32 up to 256 (one thread a unit).
CONV_FILTERS, SCALAR_DIM, SCALAR_FC, TRUNK = 16, 4, 5, 32
MAX_ACTIONS, MAX_HIDDEN, MIN_VIEW, MAX_VIEW = 32, 256, 3, 9


@dataclasses.dataclass(frozen=True)
class PolicyWeights:
    """The student's weights in PyTorch's layouts (``Linear`` (out, in)),
    and, for CUDA tensors, ``packed``: the kernel's layouts, each 2-D
    weight transposed to (in, out), made once by :func:`make_weights`."""
    conv_w: torch.Tensor     # (16, 3, 3, 3)
    conv_b: torch.Tensor     # (16,)
    emb_w: torch.Tensor      # (5, 4)
    emb_b: torch.Tensor      # (5,)
    w_i: torch.Tensor        # (4H, F), F = (V - 2)^2 * 16 + 5
    w_h: torch.Tensor        # (4H, H)
    b_h: torch.Tensor        # (4H,)
    # actor: w0 (32, H), b0, w1 (32, 32), b1, head (A, 32), head bias;
    # critic: the same with a (1, 32) head
    actor: tuple
    critic: tuple
    packed: Optional[tuple] = None


def make_weights(conv_w, conv_b, emb_w, emb_b, w_i, w_h, b_h, actor,
                 critic) -> PolicyWeights:
    """The weights of one policy; on the card also their kernel layouts
    (a copy of about 1.7 MB at H = 256: make them once a rollout)."""
    w = PolicyWeights(conv_w, conv_b, emb_w, emb_b, w_i, w_h, b_h,
                      tuple(actor), tuple(critic))
    if conv_w.device.type == 'cpu':
        return w
    t = lambda x: x.detach().T.contiguous()
    c = lambda x: x.detach().contiguous()
    trunk = lambda p: (t(p[0]), c(p[1]), t(p[2]), c(p[3]), t(p[4]), c(p[5]))
    packed = (c(conv_w), c(conv_b), c(emb_w), c(emb_b), t(w_i), t(w_h),
              c(b_h), *trunk(w.actor), *trunk(w.critic))
    return dataclasses.replace(w, packed=packed)


class PolicyOut(NamedTuple):
    """A step's outputs; the fields a mode does not compute are None."""
    action: Optional[torch.Tensor]      # (B,) int64
    log_prob: Optional[torch.Tensor]    # (B,)
    logits: Optional[torch.Tensor]      # (B, A)
    value: torch.Tensor                 # (B,)
    carry: Optional[tuple]              # (c, h) (B, H) each


def _trunk(x, p):
    w0, b0, w1, b1, wh, bh = p
    x = torch.tanh(F.linear(x, w0, b0))
    x = torch.tanh(F.linear(x, w1, b1))
    return F.linear(x, wh, bh)


def policy_step_plain(image, direction, c, h, mask, w: PolicyWeights,
                      mode: str = 'forward', u=None, action=None
                      ) -> PolicyOut:
    """The step in plain PyTorch, the arithmetic of the model's forward
    (``MultigridNetwork._embed``, ``RNNCore._cell``, ``_heads``)."""
    x = image.float() / 10.0
    x = F.conv2d(x.permute(0, 3, 1, 2), w.conv_w, w.conv_b)
    x = F.relu(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
    onehot = F.one_hot(direction.long(), SCALAR_DIM).float()
    x = torch.cat([x, F.linear(onehot, w.emb_w, w.emb_b)], -1)
    m = mask[..., None]
    c, h = c * m, h * m
    z = F.linear(h, w.w_h, w.b_h) + F.linear(x, w.w_i)
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    c2 = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
    h2 = torch.sigmoid(zo) * torch.tanh(c2)
    value = _trunk(h2, w.critic).squeeze(-1)
    if mode == 'value':
        return PolicyOut(None, None, None, value, None)
    logits = _trunk(h2, w.actor)
    if mode == 'forward':
        return PolicyOut(None, None, logits, value, (c2, h2))
    if mode == 'sample':
        action = categorical_inverse_cdf(logits, u)
    logp = F.log_softmax(logits, -1).gather(
        -1, action.long()[..., None]).squeeze(-1)
    return PolicyOut(action.long(), logp, logits, value, (c2, h2))


def _check(image, direction, c, h, mask, w: PolicyWeights, mode, u, action):
    if mode not in MODES:
        raise ValueError(f'mode {mode!r}: expected one of {MODES}')
    if image.dim() != 4 or image.shape[-1] != 3:
        raise ValueError(f'image: expected (B, V, V, 3), got '
                         f'{tuple(image.shape)}')
    B, V = image.shape[0], image.shape[1]
    H = w.w_h.shape[1]
    dev = image.device
    _build.check_tensor('image', image, torch.uint8, (B, V, V, 3), dev)
    _build.check_tensor('direction', direction, torch.int32, (B,), dev)
    for name, t, shape in (('c', c, (B, H)), ('h', h, (B, H)),
                           ('mask', mask, (B,))):
        _build.check_tensor(name, t, torch.float32, shape, dev)
    if mode == 'sample':
        if u is None:
            raise ValueError("mode 'sample' needs the uniforms u")
        _build.check_tensor('u', u, torch.float32, (B,), dev)
    if mode == 'action':
        if action is None:
            raise ValueError("mode 'action' needs the actions")
        _build.check_tensor('action', action, torch.int64, (B,), dev)


def _launch(image, direction, c, h, mask, w: PolicyWeights, mode, u,
            action) -> PolicyOut:
    B, V = image.shape[0], image.shape[1]
    H = w.w_h.shape[1]
    A = w.actor[4].shape[0]
    conv = (V - 2) * (V - 2) * CONV_FILTERS
    shapes = ((CONV_FILTERS, 3, 3, 3), (CONV_FILTERS,),
              (SCALAR_FC, SCALAR_DIM), (SCALAR_FC,), (conv + SCALAR_FC, 4 * H),
              (H, 4 * H), (4 * H,),
              (H, TRUNK), (TRUNK,), (TRUNK, TRUNK), (TRUNK,), (TRUNK, A), (A,),
              (H, TRUNK), (TRUNK,), (TRUNK, TRUNK), (TRUNK,), (TRUNK, 1), (1,))
    if w.packed is None or len(w.packed) != len(shapes):
        raise ValueError('policy_step: the weights were not packed for the '
                         'card (make_weights on CUDA tensors)')
    for i, (t, shape) in enumerate(zip(w.packed, shapes)):
        _build.check_tensor(f'packed weight {i}', t, torch.float32, shape,
                            image.device)
    if not (MIN_VIEW <= V <= MAX_VIEW and H % 32 == 0 and H <= MAX_HIDDEN
            and A <= MAX_ACTIONS):
        raise ValueError(f'policy_step: no kernel for V = {V}, H = {H}, '
                         f'A = {A}')
    dev = image.device
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    value = f32(B)
    logits = c_out = h_out = logp = act = None
    if mode != 'value':
        logits, c_out, h_out = f32(B, A), f32(B, H), f32(B, H)
    if mode in ('sample', 'action'):
        logp = f32(B)
        act = (torch.empty(B, dtype=torch.int64, device=dev)
               if mode == 'sample' else action)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.library().dcd_policy_step(
        image.data_ptr(), direction.data_ptr(), c.data_ptr(), h.data_ptr(),
        mask.data_ptr(), *(t.data_ptr() for t in w.packed),
        ptr(u if mode == 'sample' else None),
        ptr(action if mode == 'action' else None),
        ptr(logits), value.data_ptr(), ptr(c_out), ptr(h_out),
        ptr(act if mode == 'sample' else None), ptr(logp),
        B, V, H, A, MODES.index(mode),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'policy_step')
    policy_step.launches += 1
    carry = None if mode == 'value' else (c_out, h_out)
    return PolicyOut(act, logp, logits, value, carry)


def policy_step(image, direction, c, h, mask, w: PolicyWeights,
                mode: str = 'forward', u=None, action=None) -> PolicyOut:
    """One policy step of B students: image (B, V, V, 3) uint8, direction
    (B,) int32, carry (c, h) (B, H) and mask (B,) float32, the weights of
    :func:`make_weights`; ``u`` (B,) uniforms for ``'sample'``, ``action``
    (B,) int64 for ``'action'``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel
    (counted in ``policy_step.launches``) or raise.  The kernel computes no
    gradient, so on the card it refuses weights that require one while
    autograd records.
    """
    _check(image, direction, c, h, mask, w, mode, u, action)
    if image.device.type == 'cpu':
        return policy_step_plain(image, direction, c, h, mask, w, mode, u,
                                 action)
    if torch.is_grad_enabled() and w.w_i.requires_grad:
        raise RuntimeError('policy_step: kernel B2 has no backward; call it '
                           'under torch.no_grad()')
    return _launch(image, direction, c, h, mask, w, mode, u, action)


policy_step.launches = 0
