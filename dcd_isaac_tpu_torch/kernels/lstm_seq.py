"""Kernel B3: the LSTM recurrence of BPTT, forward and backward.

Replaces ``dcd_isaac_tpu/models/common.py:RNNCore.sequence_zx`` (:125-154)
and the students' remat scan (``models/multigrid_models.py:154-165``) with
their VJP.  Per step, with the carry masked first (0 at episode starts):
``z = (m·h) @ W_h^T + b + zx_t``, gates i, f, g, o (flax's order, the bias
on the hidden side only), ``c' = σ(f)·(m·c) + σ(i)·tanh(g)``,
``h' = σ(o)·tanh(c')``.

:class:`LSTMSeq` keeps what a remat scan keeps: its forward saves the
per-step carries (c, h) (T, N, H) ×2, ``W_h``, ``b`` and the masks, and
``zx`` by reference (the caller's input, which the recompute reads); its
backward recomputes z step by step in reverse, so no per-step autograd
graph exists.  It returns dzx (= dz), dW_h, db and d(c0, h0).  dW_h and db
are float64 products and a float64 sum over the stored tensors after the
reverse loop (:func:`weight_grads`); the
recurrent products and the cell stay in the kernels.

The CUDA source is ``csrc/lstm_seq.cu``: one persistent launch a pass.  A
cluster of H / 16 CTAs owns a block of BM rows for all T steps; each CTA
keeps its 64 gate columns of ``W_h``, split once into TF32 hi and lo
planes, in shared memory, the products run as three TF32 products on the
tensor cores (fp32 accuracy), and h (forward) or the partial sums of
dz @ W_h (backward) move between the cluster's CTAs through distributed
shared memory, counted by mbarriers.  The backward's launch also gives
d(h0).  At N = 8192, T = 256, H = 256 the forward's 1.10e12 operations take
at least 16.4 ms on an H100's CUDA cores in fp32 and about 6.7 ms as
3xTF32 on its tensor cores, the backward's twice that; at N = 32 the 256
dependent steps set the pace.  :func:`plan` reports the launch's BM,
cluster size and how many such clusters the card holds at once.  CPU
tensors take the plain twins (:func:`lstm_seq_plain_forward`,
:func:`lstm_seq_plain_backward`); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# The kernels take H a multiple of 32 up to 256: a cluster of H / 16 CTAs
# of 16 hidden units each, at most 16 (kMaxH in csrc/lstm_seq.cu).
UNIT_TILE = 32
MAX_HIDDEN = 256


def _step(zx_t, m, w_h, b, c, h):
    """One masked cell step → (c', h', (i, f, g, o) activations, m·c)."""
    m = m[:, None]
    cp, hp = c * m, h * m
    z = F.linear(hp, w_h, b) + zx_t
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    i, f, g, o = (torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg),
                  torch.sigmoid(zo))
    c2 = f * cp + i * g
    return c2, o * torch.tanh(c2), (i, f, g, o), cp


def lstm_seq_plain_forward(zx, masks, w_h, b, c0, h0):
    """(T, N, 4H) zx, (T, N) masks → (h_all, c_all (T, N, H), (c_T, h_T))."""
    c, h = c0, h0
    cs, hs = [], []
    for t in range(zx.shape[0]):
        c, h, _, _ = _step(zx[t], masks[t], w_h, b, c, h)
        cs.append(c)
        hs.append(h)
    return torch.stack(hs), torch.stack(cs), (c, h)


# Rows of one float64 product in weight_grads: 256 MB of dz at 4H = 1024.
WEIGHT_GRAD_ROWS = 32768


def weight_grads(dzx, masks, h0, h_all):
    """dW_h = Σ_t dz_t^T (m_t·h_{t-1}) and db = Σ_t dz_t, both accumulated
    in float64 and rounded once.

    One float64 product and sum over as many whole steps as fit in
    ``WEIGHT_GRAD_ROWS`` rows at a time (all T at N = 32, 4 at N = 8192),
    so that the float64 copies stay small.  One fp32 product over all T·N
    rows is off the exact sum by ~1.6e-3 at T = 256, N = 8192, ten times
    the 1e-4 + 1e-4·|dW| that the kernels are held to, so that two fp32
    products of nearly equal dz disagree by more than the dz do; in float64
    the product adds nothing to the dz's own error.
    """
    T, N, four_h = dzx.shape
    chunk = max(1, WEIGHT_GRAD_ROWS // max(N, 1))
    dw = torch.zeros((four_h, h0.shape[-1]), dtype=torch.float64,
                     device=dzx.device)
    db = torch.zeros(four_h, dtype=torch.float64, device=dzx.device)
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        hp = (h_all[t0 - 1:t1 - 1] if t0
              else torch.cat([h0[None], h_all[:t1 - 1]]))
        hp = (hp * masks[t0:t1, :, None]).double().flatten(0, 1)
        dz = dzx[t0:t1].flatten(0, 1).double()
        dw.addmm_(dz.T, hp)
        db += dz.sum(0)
    return dw.float(), db.float()


def lstm_seq_plain_backward(dh_all, dc_last, zx, masks, w_h, b, c0, h0,
                            h_all, c_all):
    """The recompute backward in tensor ops: the gradients of h_all
    (T, N, H) and c_T (N, H) → (dzx, dW_h, db, dc0, dh0)."""
    T = zx.shape[0]
    dzx = torch.empty_like(zx)
    dc = dc_last
    dh_rec = torch.zeros_like(h0)   # m_{t+1} · (dz_{t+1} @ W_h)
    for t in reversed(range(T)):
        c_prev = c_all[t - 1] if t else c0
        h_prev = h_all[t - 1] if t else h0
        c2, _, (i, f, g, o), cp = _step(zx[t], masks[t], w_h, b, c_prev,
                                        h_prev)
        tc = torch.tanh(c2)
        dh = dh_all[t] + dh_rec
        dct = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], -1)
        dzx[t] = dz
        m = masks[t][:, None]
        dc = m * (dct * f)
        dh_rec = m * (dz @ w_h)
    dw, db = weight_grads(dzx, masks, h0, h_all)
    return dzx, dw, db, dc, dh_rec


def _check(zx, masks, w_h, b, c0, h0):
    if zx.dim() != 3:
        raise ValueError(f'zx: expected (T, N, 4H), got {tuple(zx.shape)}')
    T, N, four_h = zx.shape
    H = four_h // 4
    dev = zx.device
    for name, t, shape in (('zx', zx, (T, N, 4 * H)), ('masks', masks, (T, N)),
                           ('w_h', w_h, (4 * H, H)), ('b', b, (4 * H,)),
                           ('c0', c0, (N, H)), ('h0', h0, (N, H))):
        _build.check_tensor(name, t, torch.float32, shape, dev)
    if T == 0:
        raise ValueError('zx: the sequence is empty')
    if dev.type != 'cpu' and (H % UNIT_TILE or H > MAX_HIDDEN):
        raise ValueError(f'hidden size {H}: the kernel takes a multiple of '
                         f'{UNIT_TILE} up to {MAX_HIDDEN}')


def plan(N, H, backward=False):
    """The kernel's launch plan at (N, H) on the current card: ``bm`` rows
    a cluster, ``cluster`` CTAs a cluster, ``max_active_clusters`` (what
    ``cudaOccupancyMaxActiveClusters`` reports for that kernel) and its
    ``smem_bytes`` a CTA."""
    import ctypes
    out = (ctypes.c_int * 4)()
    rc = _build.library().dcd_lstm_seq_plan(N, H, int(backward),
                                             ctypes.addressof(out))
    _build.check(rc, 'lstm_seq plan')
    return dict(zip(('bm', 'cluster', 'max_active_clusters', 'smem_bytes'),
                    out))


def _launch_forward(zx, masks, w_h, b, c0, h0):
    T, N, _ = zx.shape
    H = h0.shape[-1]
    c_all = torch.empty((T, N, H), dtype=torch.float32, device=zx.device)
    h_all = torch.empty_like(c_all)
    rc = _build.library().dcd_lstm_seq_forward(
        zx.data_ptr(), masks.data_ptr(), w_h.data_ptr(),
        b.data_ptr(), c0.data_ptr(), h0.data_ptr(), c_all.data_ptr(),
        h_all.data_ptr(), T, N, H,
        torch.cuda.current_stream(zx.device).cuda_stream)
    _build.check(rc, 'lstm_seq forward')
    lstm_seq.launches += 1
    return h_all, c_all


def _backward_kernel(dh_all, dc_last, zx, masks, w_h, b, c0, h0, h_all,
                     c_all):
    """The backward's launch alone → (dzx, d(c0), d(h0))."""
    T, N, _ = zx.shape
    H = h0.shape[-1]
    dzx = torch.empty_like(zx)
    dh0 = torch.empty_like(h0)
    dc = dc_last.clone()          # d(c_T) in, d(c0) out
    rc = _build.library().dcd_lstm_seq_backward(
        zx.data_ptr(), masks.data_ptr(), w_h.data_ptr(), b.data_ptr(),
        c0.data_ptr(), h0.data_ptr(), c_all.data_ptr(), h_all.data_ptr(),
        dh_all.data_ptr(), dc.data_ptr(), dzx.data_ptr(), dh0.data_ptr(),
        T, N, H, torch.cuda.current_stream(zx.device).cuda_stream)
    _build.check(rc, 'lstm_seq backward')
    lstm_seq.launches += 1
    lstm_seq.backward_launches += 1
    return dzx, dc, dh0


def _launch_backward(dh_all, dc_last, zx, masks, w_h, b, c0, h0, h_all,
                     c_all):
    dzx, dc, dh0 = _backward_kernel(dh_all, dc_last, zx, masks, w_h, b, c0,
                                    h0, h_all, c_all)
    dw, db = weight_grads(dzx, masks, h0, h_all)
    return dzx, dw, db, dc, dh0


class LSTMSeq(torch.autograd.Function):
    """``apply(zx, masks, w_h, b, c0, h0)`` → (h_all (T, N, H), c_T)."""

    @staticmethod
    def forward(ctx, zx, masks, w_h, b, c0, h0):
        if zx.device.type == 'cpu':
            h_all, c_all, _ = lstm_seq_plain_forward(zx, masks, w_h, b, c0, h0)
        else:
            h_all, c_all = _launch_forward(zx, masks, w_h, b, c0, h0)
        ctx.save_for_backward(zx, masks, w_h, b, c0, h0, h_all, c_all)
        return h_all, c_all[-1].clone()

    @staticmethod
    def backward(ctx, dh_all, dc_last):
        saved = ctx.saved_tensors
        dh_all, dc_last = dh_all.contiguous(), dc_last.contiguous()
        if dh_all.device.type == 'cpu':
            dzx, dw, db, dc0, dh0 = lstm_seq_plain_backward(
                dh_all, dc_last, *saved)
        else:
            dzx, dw, db, dc0, dh0 = _launch_backward(dh_all, dc_last, *saved)
        need = ctx.needs_input_grad
        return (dzx if need[0] else None, None, dw if need[2] else None,
                db if need[3] else None, dc0 if need[4] else None,
                dh0 if need[5] else None)


def lstm_seq(zx, masks, w_h, b, c0, h0):
    """The masked LSTM over input projections ``zx`` (T, N, 4H) and masks
    (T, N), from the carry (c0, h0) → (h_all (T, N, H), (c_T, h_T)).

    ``w_h`` (4H, H) and ``b`` (4H,) are the hidden-side Linear's weight and
    bias.  CPU tensors run the plain twins inside :class:`LSTMSeq`; CUDA
    tensors launch the kernels or raise.  ``lstm_seq.launches`` counts every
    kernel launched, one a forward pass and one a backward pass;
    ``lstm_seq.backward_launches`` counts the backward's alone.
    """
    _check(zx, masks, w_h, b, c0, h0)
    h_all, c_last = LSTMSeq.apply(zx, masks, w_h, b, c0, h0)
    return h_all, (c_last, h_all[-1])


lstm_seq.launches = 0
lstm_seq.backward_launches = 0
