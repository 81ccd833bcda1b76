"""The precision scheme of kernel B4 (``csrc/teacher_proj.cu``) on the CPU:
each fp32 operand split into a TF32 high and low part (``tf32_split``,
the rounding of ``cvt.rna.tf32.f32``) and each product taken as three TF32
products, hi hi + hi lo + lo hi, accumulated in fp32.  The card runs the
kernels themselves (``test_torch_cuda_kernels.py``, ``chip_smoke.py``);
these tests hold the scheme, computed exactly in float64 from the split
parts, to the smoke's tolerances on real conv embeds, with no card.
"""

import numpy as np
import torch

from dcd_isaac_tpu_torch.kernels.teacher_proj import embed_plain, tf32_split


def as_float(bits):
    return torch.tensor(np.array(bits, np.uint32).view(np.int32)).view(
        torch.float32)


def test_split_reproduces_fp32():
    """hi and lo are TF32 (13 low bits zero) and hi + lo is x to 2^-21 of
    |x|, or to half the smallest TF32 step below the normal range
    (subnormals carry fewer bits); zeros keep their sign, and values past
    the largest TF32 round to infinity as cvt.rna does."""
    rng = np.random.default_rng(0)
    mags = np.exp(rng.uniform(-80.0, 80.0, 20000)).astype(np.float32)
    signs = np.where(rng.random(20000) < 0.5, -1.0, 1.0).astype(np.float32)
    edges = as_float([
        0x00000000, 0x80000000,                  # +0, -0
        0x00000001, 0x80000001, 0x00001000,      # subnormals
        0x00001fff, 0x007fffff, 0x807fe000,
        0x00800000, 0x00801000, 0x00800fff,      # smallest normals
        0x3f800000, 0x3f801000, 0x3f800fff,      # 1 and its ties
        0xbf801000, 0x3f802000,
        0x7f7fe000, 0x7f7fefff, 0xff7fefff,      # largest split finitely
    ])
    x = torch.cat([torch.from_numpy(mags * signs), edges])
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1fff).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs() + 2.0 ** -137).all()
    # ties go away from zero; zeros keep their sign
    assert float(tf32_split(as_float([0x3f801000]))[0]) == float(
        as_float([0x3f802000]))
    assert float(tf32_split(as_float([0xbf801000]))[0]) == float(
        as_float([0xbf802000]))
    assert torch.equal(tf32_split(edges[:2])[0].view(torch.int32),
                       edges[:2].view(torch.int32))
    # the largest finite float32 values round past the largest TF32
    top = as_float([0x7f7ff000, 0x7f7fffff, 0xff7fffff])
    assert torch.equal(tf32_split(top)[0],
                       torch.tensor([np.inf, np.inf, -np.inf]))


def three_tf32(a, b):
    """a @ b.T in 3xTF32 (hi hi + hi lo + lo hi), each product exact in
    float64, and the one-product TF32 a_hi @ b_hi.T."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return ah @ bh.T + ah @ bl.T + al @ bh.T, ah @ bh.T


def test_three_products_hold_the_smoke_tolerances():
    """On real conv embeds (B = 64 rows of K = 21 692, N = 64): the
    forward's 3xTF32 product within the smoke's rtol = atol = 1e-4 of the
    float64 product (and far inside it), dW = g^T A within 1e-5 of the
    largest entry plus 1e-5 relative; one TF32 product misses the
    forward's tolerance, which is why the kernels take three."""
    rng = np.random.default_rng(11)
    B, N, E = 64, 64, 60
    img = torch.from_numpy(rng.integers(0, 11, (B, 15, 15, 3),
                                        dtype=np.uint8))
    conv_w = torch.from_numpy(
        (rng.standard_normal((128, 3, 3, 3)) * 0.15).astype(np.float32))
    conv_b = torch.from_numpy(
        (rng.standard_normal(128) * 0.05).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal((B, E)).astype(np.float32))
    a = embed_plain(img, conv_w, conv_b, e)
    assert a.shape == (B, 13 * 13 * 128 + E)
    w = torch.from_numpy(
        (rng.standard_normal((N, a.shape[1])) * 0.007).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32))

    want = a.double() @ w.double().T
    got, one = three_tf32(a, w)
    err = (got - want).abs()
    assert (err <= 1e-4 + 1e-4 * want.abs()).all()
    assert float(err.max()) < 1e-6 * float(want.abs().max())
    assert not (one - want).abs().le(1e-4 + 1e-4 * want.abs()).all()

    want = g.double().T @ a.double()
    got, _ = three_tf32(g.T.contiguous(), a.T.contiguous())
    err = (got - want).abs()
    top = float(want.abs().max())
    assert (err <= 1e-5 * top + 1e-5 * want.abs()).all()
