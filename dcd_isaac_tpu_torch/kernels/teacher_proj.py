"""Kernel B4: the teacher's conv-128 embed fused into its input projection.

Replaces the forward of ``dcd_isaac_tpu/models/multigrid_models.py``
``_core_sequence.zx_chunk`` (:120-152) with ``_embed`` (:75-89):
``zx = [relu(conv3x3(img / 10) + b) flattened (h, w, c) || e] @ W_i^T``,
with ``e`` (B, E) the scalar embed and ``random_z`` computed by the caller.
The CUDA source is ``csrc/teacher_proj.cu``.  Its products run on the
tensor cores at fp32 accuracy (3xTF32 on ``mma.sync``): each fp32 operand
is split into a TF32 high and low part (:func:`tf32_split` is that
rounding in plain PyTorch, for tests), each product is taken as three
TF32 products accumulated in fp32, and each accumulator is folded into a
second one every 128 terms with a rounded add.  The forward computes
each K-tile of conv features from the images' patches as it is consumed,
so the (B, 21 692) activation never reaches device memory (the point of
JAX's chunked hoist), split over K so that a construction step's B = 32
fills the card.  It is bound by W_i's bytes at B = 32 and by operations
at the update's B = 27 * 32: the products and, on the CUDA cores, the
conv and the operand splits.

The backward is two more kernels of the same file (:func:`_launch_backward`):
dW = g^T A with A's conv tiles recomputed from the images (shared by the
cluster of CTAs of one K-tile through distributed shared memory), and dA =
g W_i, whose conv columns times ReLU' reduce straight into the conv weight
and bias gradients and whose last E columns are ``g_e``.  Every operand is
read by the tensor cores in the layout it is staged in, so neither needs a
transposed copy.  Split partials (the forward's K splits, dW's row
splits, each pixel's share of the conv gradients) are summed in a fixed
order: two runs give the same bits.  Neither pass writes the (B, K)
embed, so the teacher update's memory stays bounded at ``bench.py``'s B =
52 * 8192; the workspace holds the images' patches (32 bytes a row and
pixel) and the split partials.  The plain twin of the backward,
:func:`teacher_proj_backward_plain`, recomputes the embed in row chunks of
about 0.5 GB, as JAX's checkpointed chunks do, with two ``torch.matmul``
and the conv's autograd per chunk.  :func:`teacher_proj` takes the plain
twins for CPU tensors (:func:`teacher_proj_plain`, autograd throughout),
and launches the kernels or raises for CUDA tensors.  The kernels take N
= 1024 (the recurrent teacher's LSTM input) and N = 64 (the non-recurrent
teacher's stacked first trunk layers).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# The kernels' shape rules (csrc/teacher_proj.cu, which checks them again
# in dcd_teacher_proj_workspace): the conv filters a multiple of the
# forward's 32-channel K-step up to kMaxC, K a multiple of 4 for 16-byte
# copies of W_i, and N a multiple of 8.  The backward's K-tile is one
# pixel's 128 channels (C = 128, the teacher's).
BK = 32
MAX_FILTERS = 128
# Rows of the embed the backward rebuilds at once: about 0.5 GB of fp32
# in each (rows, K) transient, JAX's zx_chunk budget
# (dcd_isaac_tpu/models/multigrid_models.py:127-135).
CHUNK_BYTES = 5e8


def embed_plain(img, conv_w, conv_b, e) -> torch.Tensor:
    """(B, K) = [relu(conv(img / 10)) flattened (h, w, c) || e]."""
    x = img.float() / 10.0
    x = F.conv2d(x.permute(0, 3, 1, 2), conv_w, conv_b).permute(0, 2, 3, 1)
    return torch.cat([F.relu(x.reshape(x.shape[0], -1)), e], -1)


def teacher_proj_plain(img, conv_w, conv_b, e, w_i) -> torch.Tensor:
    """(B, N) = embed_plain(...) @ W_i^T, in plain PyTorch."""
    return embed_plain(img, conv_w, conv_b, e) @ w_i.T


def tf32_split(x: torch.Tensor) -> tuple:
    """(hi, lo) float32 of float32 ``x``: hi = x rounded to TF32, lo = the
    TF32 rounding of x - hi (exact in float32), as the kernels split their
    operands with ``cvt.rna.tf32.f32``: to nearest, ties away from zero, 10
    mantissa bits; a value past the largest TF32 rounds to infinity, and
    infinities and NaNs are kept.  For tests: the kernels split on the
    card, and nothing on the main path calls this."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # half an ulp of TF32 added to the magnitude bits, then truncated
        rounded = (bits + 0x1000) & -0x2000
        return torch.where(torch.isfinite(v), rounded, bits).view(
            torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _launch(img, conv_w, conv_b, e, w_i) -> torch.Tensor:
    """The forward kernel (counted in ``teacher_proj.launches``)."""
    B, X, Y, _ = img.shape
    C = conv_w.shape[0]
    N, K = w_i.shape
    E = e.shape[1]
    lib = _build.library()
    ws_floats = lib.dcd_teacher_proj_workspace(B, N, K, C, E)
    if ws_floats < 0:
        raise ValueError(f'teacher_proj: no kernel plan for C={C}, K={K}')
    out = torch.empty((B, N), dtype=torch.float32, device=img.device)
    ws = torch.empty(max(ws_floats, 4), dtype=torch.float32,
                     device=img.device)
    rc = lib.dcd_teacher_proj(
        img.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), e.data_ptr(),
        w_i.data_ptr(), out.data_ptr(), ws.data_ptr(), B, X, Y, C, E, N,
        torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(rc, 'teacher_proj')
    teacher_proj.launches += 1
    return out


def teacher_proj_backward_plain(img, conv_w, conv_b, e, w_i, grad):
    """The gradients (conv_w, conv_b, e, w_i) of the projection given
    ``grad`` (B, N), the embed rebuilt ``rows`` at a time."""
    rows = max(1, int(CHUNK_BYTES // (4 * w_i.shape[1])))
    g_w = torch.zeros_like(w_i)
    g_conv_w, g_conv_b = torch.zeros_like(conv_w), torch.zeros_like(conv_b)
    g_e = torch.empty_like(e)
    for r in range(0, img.shape[0], rows):
        g = grad[r:r + rows]
        with torch.enable_grad():
            leaves = [conv_w.detach().requires_grad_(),
                      conv_b.detach().requires_grad_(),
                      e[r:r + rows].detach().requires_grad_()]
            a = embed_plain(img[r:r + rows], *leaves)
        g_w.addmm_(g.T, a.detach())
        gw, gb, g_e[r:r + rows] = torch.autograd.grad(a, leaves, g @ w_i)
        g_conv_w += gw
        g_conv_b += gb
    return g_conv_w, g_conv_b, g_e, g_w


def _launch_backward(img, conv_w, conv_b, e, w_i, grad, parts: int = 3):
    """The backward kernels: ``parts`` 1 dW, 2 dA (the conv gradients and
    g_e), 3 both (the autograd path; counted in
    ``teacher_proj.backward_launches``)."""
    B, X, Y, _ = img.shape
    C = conv_w.shape[0]
    N, K = w_i.shape
    E = e.shape[1]
    lib = _build.library()
    ws_floats = lib.dcd_teacher_proj_backward_workspace(B, N, K, C, E)
    if ws_floats < 0:
        raise ValueError(f'teacher_proj backward: no kernel plan for C={C}, '
                         f'K={K}, N={N}')
    dev = img.device
    g_w = torch.empty_like(w_i)
    g_conv_w, g_conv_b = torch.empty_like(conv_w), torch.empty_like(conv_b)
    g_e = torch.empty_like(e)
    ws = torch.empty(max(ws_floats, 4), dtype=torch.float32, device=dev)
    rc = lib.dcd_teacher_proj_backward(
        img.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), e.data_ptr(),
        w_i.data_ptr(), grad.data_ptr(), g_w.data_ptr(), g_conv_w.data_ptr(),
        g_conv_b.data_ptr(), g_e.data_ptr(), ws.data_ptr(), B, X, Y, C, E, N,
        parts, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, 'teacher_proj backward')
    teacher_proj.backward_launches += (parts & 1) + (parts >> 1)
    return g_conv_w, g_conv_b, g_e, g_w


class TeacherProj(torch.autograd.Function):
    """The projection and its gradients, by the kernels on the card and by
    the plain twins on the CPU.

    ``apply(img, conv_w, conv_b, e, w_i)``; the backward returns the
    gradients of conv_w, conv_b, e and w_i.
    """

    @staticmethod
    def forward(ctx, img, conv_w, conv_b, e, w_i):
        ctx.save_for_backward(img, conv_w, conv_b, e, w_i)
        if img.device.type == 'cpu':
            return teacher_proj_plain(img, conv_w, conv_b, e, w_i)
        return _launch(img, conv_w, conv_b, e, w_i)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        grad = grad.contiguous()
        if grad.device.type == 'cpu':
            grads = teacher_proj_backward_plain(*saved, grad)
        else:
            grads = _launch_backward(*saved, grad)
        return (None, *(g if need else None for g, need in zip(
            grads, ctx.needs_input_grad[1:])))


def teacher_proj(img, conv_w, conv_b, e, w_i) -> torch.Tensor:
    """zx (B, N) of images (B, X, Y, 3) uint8; see :func:`teacher_proj_plain`.

    CPU tensors take the plain twin (autograd throughout); CUDA tensors
    launch the kernel, and in the backward its two gradient kernels, or
    raise.  ``teacher_proj.launches`` counts the forward's launches,
    ``teacher_proj.backward_launches`` the backward's two kernels.
    """
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f'img: expected (B, X, Y, 3), got {tuple(img.shape)}')
    B, X, Y, _ = img.shape
    dev = img.device
    C = conv_w.shape[0]
    E = e.shape[-1]
    K = (X - 2) * (Y - 2) * C + E
    _build.check_tensor('img', img, torch.uint8, (B, X, Y, 3), dev)
    _build.check_tensor('conv_w', conv_w, torch.float32, (C, 3, 3, 3), dev)
    _build.check_tensor('conv_b', conv_b, torch.float32, (C,), dev)
    _build.check_tensor('e', e, torch.float32, (B, E), dev)
    _build.check_tensor('w_i', w_i, torch.float32, (w_i.shape[0], K), dev)
    if dev.type == 'cpu':
        return teacher_proj_plain(img, conv_w, conv_b, e, w_i)
    if C % BK or C > MAX_FILTERS:
        raise ValueError(f'conv filters {C}: the kernel takes a multiple of '
                         f'{BK} up to {MAX_FILTERS}')
    if K % 4:
        raise ValueError(f'K = {K}: the kernel takes a multiple of 4')
    if w_i.shape[0] % 8:
        raise ValueError(f'N = {w_i.shape[0]}: the kernels take a multiple '
                         f'of 8')
    return TeacherProj.apply(img, conv_w, conv_b, e, w_i)


teacher_proj.launches = 0
teacher_proj.backward_launches = 0
