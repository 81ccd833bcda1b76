// The teacher's conv-128 embed fused into its LSTM input projection,
// forward and backward, with the products on the tensor cores at fp32
// accuracy (3xTF32).
//
// Replaces the forward of dcd_isaac_tpu/models/multigrid_models.py
// _core_sequence.zx_chunk (:120-152) with _embed (:75-89), and the same
// projection of the one-step forward:
//   zx[b, :] = [relu(conv3x3(img[b] / 10) + bias) flattened (h, w, c)
//               || e[b]] @ W_i^T
// img (B, X, Y, 3) uint8 (NHWC, the JAX layout), conv weight (C, 3, 3, 3)
// OIHW, bias (C,), e (B, E) the scalar embed and random_z, W_i (N, K)
// row-major with K = (X-2)(Y-2)C + E, zx (B, N) float32.  The backward,
// given g = d zx (B, N), is dW = g^T A (N, K) and dA = g W_i (B, K), whose
// conv columns times ReLU' of the pre-activation reduce straight into the
// conv weight and bias gradients and whose last E columns are g_e (B, E).
// The (B, K) embed A is never written on either pass: each kernel
// recomputes the conv tile it needs from the images, whose 3x3x3 patches a
// first kernel (patches_kernel) lays out as 32 bytes a (row, pixel), so
// that a step's patches arrive by 16-byte cp.async copies.
//
// What bounds them on the H100.  At B = 32 (a construction step) the
// forward reads W_i's 88.9 MB once (26.5 us at 3.35 TB/s); at the teacher
// update's B = 864 and bench.py's B = 52 * 8192 every kernel is bound by
// operations: the products (2 B N K each, as three TF32 products) and, on
// the CUDA cores, the conv (27 FMAs an embed entry, each reading a
// weight from shared memory, for each column tile that needs the entry)
// and the operand splits below.
//
// Products: 3xTF32 on mma.sync.m16n8k8.  Each fp32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna.tf32.f32: to
// nearest, ties away from zero; x - hi is exact), and each product is
// accumulated as lo_a hi_b + hi_a lo_b + hi_a hi_b in fp32 registers: an
// error of about 2^-21 of the product's scale, against 2^-11 for one TF32
// product (too coarse for the 1e-4 check).  The tensor cores need not
// round a product sum into the accumulator to nearest, so each
// accumulator collects the products of 4 reduction steps (128 terms) and
// is then added to a second fp32 accumulator with a rounded add
// ("promotion"), which keeps long reductions (425 984 rows in dW) as
// accurate as the fp32 FMA chains they replace.  The split is done once
// for each operand value a CTA stages into shared memory, which holds a hi
// and a lo plane of every tile.  A warp's tile is 64 x 32 outputs (4 x 4
// mma tiles), and its three products of a tile are 16 mma apart.
//
// Why mma.sync and not wgmma: wgmma's TF32 form reads both operands from
// shared memory K-major only (its transpose bits are for 16-bit types),
// while dW = g^T A reduces over the rows, so both of its operands (g and
// the conv tile) are stored row by row, and dA = g W_i reads W_i across
// its rows; each would need a transposed staging pass.  mma.sync's
// fragments are loaded by each thread with 32-bit shared loads, so every
// operand is read in the layout it is produced or stored in: K-contiguous
// tiles with a row stride of 4 mod 32 floats, K-outer tiles with a stride
// of 8 mod 32, both free of bank conflicts.  For the forward, whose
// operands are both K-major, a wgmma version (both operands in the
// 128-byte swizzle, the next step staged while the products run) was
// built and measured slower on the H100 than this one: a step is bound by
// the CUDA-core staging (the conv's weight reads from shared memory, the
// splits), which wgmma's products then also contend with for shared
// memory, and by the proxy fence and barrier each step needs.
//
// Pipelines.  Every kernel is one CTA of 256 threads (8 warps) a tile,
// one CTA an SM, with two shared-memory stages: while the warps multiply
// the tiles of step s, the operands of a later step are in flight into
// registers and the patches by cp.async, and each thread stages step
// s + 1 (the split of its W_i or g values, the conv of its embed entries):
// one barrier a step.  dW's column tiles of one K-tile form a cluster of
// up to 8 CTAs that share the conv tile through distributed shared
// memory, each computing 1/8 of it (ablate_teacher_proj: no_cluster).
//
// The conv stays on the CUDA cores in one order, conv_pre: the bias, then
// fmaf over the 27 patch values (ci, di, dj) in order, with each byte / 10
// rounded once; chip_smoke.kernel_conv_grads replays that order to decide
// ReLU'.  Determinism: no float atomics; split partial sums (the split-K
// parts of the forward, the row splits of dW, each pixel's share of the
// conv gradients) go to a workspace and are summed in a fixed order (the
// conv gradients' in double), so two runs give the same bits.
//
// The entry points own the tiling rules: dcd_teacher_proj_workspace and
// dcd_teacher_proj_backward_workspace say whether a shape is supported and
// how much workspace it needs (the patches, then the split parts), and the
// launches use the same plans.

#include <algorithm>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 32;        // reduction depth of one pipeline step
constexpr int kPromote = 4;      // steps an mma accumulator collects
constexpr int kPatch = 27;       // 3 input channels x 3 x 3
constexpr int kMaxC = 128;       // conv filters held in shared memory
constexpr int kTK = 128;         // the backward's K-tile: one pixel's C
constexpr int kMaxSplits = 64;
constexpr int kPatchBytes = 32;  // a pixel's 27 patch bytes, padded
constexpr int kLut = 256;        // byte / 10 for every byte

// ---------------------------------------------------------------------------
// Tensor-core helpers.

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// d += a b for one 16 x 8 x 8 TF32 tile (fragments as in the PTX ISA:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g),
// b1 (t + 4, g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, ...), for lane
// 4 g + t).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Every thread of every CTA of the cluster arrives and waits; shared
// memory written before (by any CTA of the cluster) is visible after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v into the shared memory of the cluster's CTA `rank`, at the offset of
// p in this CTA's.
__device__ __forceinline__ void st_cluster(float* p, int rank, float4 v) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// ---------------------------------------------------------------------------

// v's TF32 parts, lane by lane: h = rna_tf32(v), l = rna_tf32(v - h).
__device__ __forceinline__ void split4(float4 v, float4& h, float4& l) {
  h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  l = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                  tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
}

// Four values' hi parts at hi[0..3] and lo parts at hi[lo..lo+3].
__device__ __forceinline__ void store_split(float* hi, int lo, float4 v) {
  float4 h, l;
  split4(v, h, l);
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(hi + lo) = l;
}

// store_split into the same place of each of the cl CTAs of the cluster
// (this one alone when cl is 1).
__device__ __forceinline__ void store_split_all(float* hi, int lo, float4 v,
                                                int cl) {
  if (cl == 1) {
    store_split(hi, lo, v);
    return;
  }
  float4 h, l;
  split4(v, h, l);
  for (int r = 0; r < cl; ++r) {
    st_cluster(hi, r, h);
    st_cluster(hi + lo, r, l);
  }
}

// The barrier of a pipeline step: the cluster's, or the CTA's alone.
__device__ __forceinline__ void step_sync(int cl) {
  if (cl > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// One warp's MT x NT tiles of 16 x 8 outputs over one step (kStep deep):
// acc += A B in 3xTF32, A(m, k) at a[m * AM + k * AK] and B(k, n) at
// b[k * BK + n * BN] (floats), each with its lo plane `a_lo` / `b_lo`
// floats further on; a and b point at the warp's tile.  between(i) runs
// after the products of the i-th 8 of the step's depth: the CUDA-core
// work placed there overlaps those products.
template <int MT, int NT, int AM, int AK, int BK, int BN, typename Between>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* a, int a_lo,
                                         const float* b, int b_lo,
                                         Between&& between) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < kStep; ks += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float* p = a + (i * 16 + g) * AM + (ks + t) * AK;
      ah[i][0] = bits(p[0]);
      ah[i][1] = bits(p[8 * AM]);
      ah[i][2] = bits(p[4 * AK]);
      ah[i][3] = bits(p[8 * AM + 4 * AK]);
      al[i][0] = bits(p[a_lo]);
      al[i][1] = bits(p[a_lo + 8 * AM]);
      al[i][2] = bits(p[a_lo + 4 * AK]);
      al[i][3] = bits(p[a_lo + 8 * AM + 4 * AK]);
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* q = b + (ks + t) * BK + (j * 8 + g) * BN;
      bh[j][0] = bits(q[0]);
      bh[j][1] = bits(q[4 * BK]);
      bl[j][0] = bits(q[b_lo]);
      bl[j][1] = bits(q[b_lo + 4 * BK]);
    }
    // The three products of a tile are MT * NT mma apart, so that an
    // accumulator's next product does not wait on its last.
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bh[j]);
    between(ks / 8);
  }
}

struct Nothing {
  __device__ __forceinline__ void operator()(int) const {}
};

// acc += part (rounded adds), part = 0.
template <int MT, int NT>
__device__ __forceinline__ void promote(float (&acc)[MT][NT][4],
                                        float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);
        part[i][j][r] = 0.0f;
      }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Conv weights [q][c] (c < kMaxC), the bias and the byte / 10 table into
// shared memory.
__device__ __forceinline__ void load_conv(const float* __restrict__ conv_w,
                                          const float* __restrict__ conv_b,
                                          int C, float* cw, float* cb,
                                          float* lut) {
  for (int i = threadIdx.x; i < C * kPatch; i += blockDim.x) {
    cw[(i % kPatch) * kMaxC + i / kPatch] = conv_w[i];
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) cb[i] = conv_b[i];
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) {
    lut[i] = (float)i / 10.0f;
  }
}

// Rows [r0, r0 + rows) of pixel p's patches (32 bytes each) into dst by
// cp.async, 16 bytes a copy, by threads tid of n; rows at or past r_end
// are left as they are (any byte gives a finite conv, and those rows are
// never stored or are multiplied by a zero g).
__device__ __forceinline__ void copy_patches(
    const uint8_t* __restrict__ patches, uint8_t* dst, int r0, int rows,
    int r_end, int P, int p, int tid, int n) {
  for (int i = tid; i < 2 * rows; i += n) {
    const int r = i / 2, row = r0 + r;
    if (row < r_end) {
      __pipeline_memcpy_async(
          dst + r * kPatchBytes + (i % 2) * 16,
          patches + ((size_t)row * P + p) * kPatchBytes + (i % 2) * 16, 16);
    }
  }
}

// One row's 27 patch values, each byte / 10, from its 32 bytes in shared
// memory.
__device__ __forceinline__ void patch_values(const uint8_t* pb,
                                             const float* lut,
                                             float (&x)[kPatch]) {
  const uint4 u0 = *reinterpret_cast<const uint4*>(pb);
  const uint4 u1 = *reinterpret_cast<const uint4*>(pb + 16);
  const uint32_t wd[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int q = 0; q < kPatch; ++q) {
    x[q] = lut[(wd[q / 4] >> (8 * (q % 4))) & 0xffu];
  }
}

// The conv pre-activations of channels c..c+3 for one patch, in conv_pre's
// order: the bias, then fmaf over q.
__device__ __forceinline__ float4 conv4(const float* cw, const float* cb,
                                        const float (&x)[kPatch], int c) {
  float4 v = *reinterpret_cast<const float4*>(cb + c);
#pragma unroll
  for (int q = 0; q < kPatch; ++q) {
    const float4 w4 = *reinterpret_cast<const float4*>(cw + q * kMaxC + c);
    v.x = fmaf(w4.x, x[q], v.x);
    v.y = fmaf(w4.y, x[q], v.y);
    v.z = fmaf(w4.z, x[q], v.z);
    v.w = fmaf(w4.w, x[q], v.w);
  }
  return v;
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                     fmaxf(v.w, 0.f));
}

// ---------------------------------------------------------------------------
// The forward: a BM x BN tile of zx (rows x n) over a K range, in steps of
// 32 k: the A tile (the conv features of 32 channels of one pixel, or e
// columns) is computed by the CTA, the W_i tile read from device memory.
// The K range is split over gridDim.z (split-K) when the tiles alone do
// not fill the card.  Shared tiles [m][k] and [n][k], row stride 36.

template <int BM, int BN, int WGM, int WGN>
struct Fwd {
  static constexpr int MT = BM / WGM / 16, NT = BN / WGN / 8;
  static constexpr int kLd = kStep + 4;
  static constexpr int kA = BM * kLd, kB = BN * kLd;    // floats a plane
  static constexpr int kStage = 2 * (kA + kB);          // A hi, lo; B hi, lo
  static constexpr int kPbuf = BM * kPatchBytes / 4;    // floats a patch tile
  static constexpr int kSmem = (2 * kStage + kPatch * kMaxC + kMaxC + kLut +
                                2 * kPbuf) * (int)sizeof(float);
  static constexpr int kH = kThreads / BM;              // threads a row
  static constexpr int kWVec = BN * kStep / 4 / kThreads;
  static_assert(WGM * WGN * 32 == kThreads && MT >= 1 && NT >= 1 &&
                    kThreads % BM == 0 && kWVec >= 1,
                "forward tiling");
};

template <int BM, int BN, int WGM, int WGN>
__global__ void __launch_bounds__(kThreads, 1) teacher_proj_kernel(
    const uint8_t* __restrict__ patches, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ e,
    const float* __restrict__ w, float* __restrict__ out, int B, int P,
    int C, int E, int N, int k_chunk) {
  using F = Fwd<BM, BN, WGM, WGN>;
  extern __shared__ __align__(16) float smem[];
  float* cw = smem + 2 * F::kStage;
  float* cb = cw + kPatch * kMaxC;
  float* lut = cb + kMaxC;
  uint8_t* pbuf = reinterpret_cast<uint8_t*>(lut + kLut);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WGN, wn = warp % WGN;
  const int n0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int conv_dim = P * C;
  const int K = conv_dim + E;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int steps = (k_end - k_begin + kStep - 1) / kStep;
  load_conv(conv_w, conv_b, C, cw, cb, lut);

  // Step s's patches (a conv step: one pixel's, for the CTA's rows) into
  // patch buffer s % 2, one commit group a step (empty past the end).
  auto copy = [&](int s) {
    const int k0 = k_begin + s * kStep;
    if (s < steps && k0 < conv_dim) {
      copy_patches(patches, pbuf + (s % 2) * BM * kPatchBytes, row0, BM, B,
                   P, k0 / C, tid, kThreads);
    }
    __pipeline_commit();
  };
  // This thread's W_i values of a step: 16-byte chunks, 8 threads a row of
  // 32 k; zeros past N or k_end (k_end is a multiple of 4).
  float4 wreg[F::kWVec];
  auto fetch = [&](int s) {
    const int k0 = k_begin + s * kStep;
#pragma unroll
    for (int v = 0; v < F::kWVec; ++v) {
      const int id = tid + v * kThreads;
      const int n = n0 + id / 8, k = k0 + (id % 8) * 4;
      wreg[v] = (n < N && k < k_end) ? ldg4(w + (size_t)n * K + k)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // Step s's tiles into stage s % 2: the W_i values fetched, and this
  // thread's A entries: row tid % BM, channels 4 h + 4 kH j of the step's
  // 32 (h = tid / BM), so that a warp's 32 rows read one chunk's conv
  // weights (a broadcast) and a quarter-warp's stores fall on 32 banks.
  auto stage = [&](int s) {
    float* st = smem + (s % 2) * F::kStage;
#pragma unroll
    for (int v = 0; v < F::kWVec; ++v) {
      const int id = tid + v * kThreads;
      store_split(st + 2 * F::kA + (id / 8) * F::kLd + (id % 8) * 4, F::kB,
                  wreg[v]);
    }
    const int k0 = k_begin + s * kStep;
    const int r = tid % BM, h = tid / BM, row = row0 + r;
    float* a = st + r * F::kLd;
    if (k0 < conv_dim) {
      float x[kPatch];
      patch_values(pbuf + ((s % 2) * BM + r) * kPatchBytes, lut, x);
#pragma unroll
      for (int j = 0; j < 8 / F::kH; ++j) {
        const int c = 4 * h + 4 * F::kH * j;
        store_split(a + c, F::kA, relu4(conv4(cw, cb, x, k0 % C + c)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8 / F::kH; ++j) {
        const int c = 4 * h + 4 * F::kH * j;
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + c + u;
          v[u] = (row < B && k < k_end)
                     ? e[(size_t)row * E + (k - conv_dim)] : 0.0f;
        }
        store_split(a + c, F::kA, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  };

  float acc[F::MT][F::NT][4], part[F::MT][F::NT][4];
  zero(acc);
  zero(part);
  // Patches two steps ahead by cp.async, W_i values two steps ahead in
  // registers, the stage of step s + 1 after step s's product: each step's
  // patches have landed (own copies) and are visible (barrier) before the
  // step is staged.
  copy(0);
  copy(1);
  fetch(0);
  __pipeline_wait_prior(1);
  __syncthreads();   // the conv weights, the table, step 0's patches
  stage(0);
  if (steps > 1) fetch(1);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    copy(s + 2);
    const float* st = smem + (s % 2) * F::kStage;
    warp_mma<F::MT, F::NT, F::kLd, 1, 1, F::kLd>(
        part, st + wm * F::MT * 16 * F::kLd, F::kA,
        st + 2 * F::kA + wn * F::NT * 8 * F::kLd, F::kB, Nothing());
    if ((s + 1) % kPromote == 0 || s + 1 == steps) promote(acc, part);
    if (s + 1 < steps) stage(s + 1);
    if (s + 2 < steps) fetch(s + 2);
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  float* o = out + (size_t)blockIdx.z * B * N;
#pragma unroll
  for (int i = 0; i < F::MT; ++i) {
#pragma unroll
    for (int j = 0; j < F::NT; ++j) {
      const int n = n0 + (wn * F::NT + j) * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + (wm * F::MT + i) * 16 + g + 8 * hh;
        if (row < B && n < N) {
          *reinterpret_cast<float2*>(o + (size_t)row * N + n) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

// patches[b][p] = the 27 bytes of image b's 3x3x3 patch at output pixel p
// in conv_pre's order q = (ci, di, dj), and 5 zero bytes: read by the
// kernels as 16-byte copies.
__global__ void patches_kernel(const uint8_t* __restrict__ img,
                               uint8_t* __restrict__ patches, int X, int Y) {
  extern __shared__ uint8_t im[];
  const int n = X * Y * 3, OY = Y - 2, P = (X - 2) * OY;
  const uint8_t* src = img + (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) im[i] = src[i];
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int pi = p / OY, pj = p % OY;
    uint32_t wd[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < kPatch; ++q) {
      const int ci = q / 9, di = (q / 3) % 3, dj = q % 3;
      wd[q / 4] |= (uint32_t)im[((pi + di) * Y + pj + dj) * 3 + ci]
                   << (8 * (q % 4));
    }
    uint4* dst = reinterpret_cast<uint4*>(
        patches + ((size_t)blockIdx.x * P + p) * kPatchBytes);
    dst[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    dst[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
  }
}

// Bytes of the patches tensor of a batch of B images, in floats.
long long patch_floats(int B, int P) {
  return (long long)B * P * kPatchBytes / 4;
}

void make_patches(const void* img, uint8_t* patches, int B, int X, int Y,
                  cudaStream_t s) {
  patches_kernel<<<B, 192, X * Y * 3, s>>>((const uint8_t*)img, patches, X,
                                           Y);
}

// out[i] = sum over s of ws[s][i], in order of s.
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, long long count,
                                  int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = ws[i];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, ws[(size_t)k * count + i]);
  out[i] = s;
}

void sum_splits(const float* ws, float* out, long long count, int splits,
                cudaStream_t s) {
  sum_splits_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(ws, out, count, splits);
}

// A launch of kern on a grid of clusters of cluster CTAs.
template <typename Kern, typename... Args>
void launch_clusters(Kern kern, dim3 grid, dim3 cluster, int smem,
                     cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, args...);
}

// CTAs sharing a conv tile: the most of 8, 4, 2 that divides the tiles.
int cluster_size(int tiles) {
  for (int c = 8; c > 1; c /= 2) {
    if (tiles % c == 0) return c;
  }
  return 1;
}

// CTAs of a kernel with this shared memory that fit on the card at once.
template <typename Kern>
int occupancy_slots(Kern fn, int smem, int threads) {
  int per_sm = 0, dev = 0, sms = 1;
  cudaFuncSetAttribute((const void*)fn,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn,
                                                threads, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Splits of `steps` steps over `tiles` CTAs that minimise waves x steps per
// CTA (preferring fewer), at most max_splits.
int choose_splits(long long tiles, int steps, long long slot,
                  int max_splits) {
  long long best = -1;
  int splits = 1;
  for (int sp = 1; sp <= max_splits && sp <= steps; ++sp) {
    const long long waves = (tiles * sp + slot - 1) / slot;
    const long long cost = waves * ((steps + sp - 1) / sp);
    if (best < 0 || cost * 100 < best * 97) {
      best = cost;
      splits = sp;
    }
  }
  return splits;
}

// The forward's tiles: a construction step's B <= 32 rows, a teacher
// without a core's N = 64, and the rest.
enum FwdCfg { kFwdSmall, kFwdNarrow, kFwdWide };
using FwdSmall = Fwd<32, 128, 1, 8>;
using FwdNarrow = Fwd<128, 64, 4, 2>;
using FwdWide = Fwd<128, 128, 2, 4>;

struct Plan {
  FwdCfg cfg;
  int bm, bn, splits, k_chunk;
};

int fwd_slots(FwdCfg cfg) {
  static int s[3] = {0, 0, 0};
  if (s[cfg] == 0) {
    s[cfg] = cfg == kFwdSmall
                 ? occupancy_slots(teacher_proj_kernel<32, 128, 1, 8>,
                                   FwdSmall::kSmem, kThreads)
             : cfg == kFwdNarrow
                 ? occupancy_slots(teacher_proj_kernel<128, 64, 4, 2>,
                                   FwdNarrow::kSmem, kThreads)
                 : occupancy_slots(teacher_proj_kernel<128, 128, 2, 4>,
                                   FwdWide::kSmem, kThreads);
  }
  return s[cfg];
}

Plan plan(int B, int N, int K) {
  Plan p;
  p.cfg = B <= 32 ? kFwdSmall : N <= 64 ? kFwdNarrow : kFwdWide;
  p.bm = p.cfg == kFwdSmall ? 32 : 128;
  p.bn = p.cfg == kFwdNarrow ? 64 : 128;
  const long long ctas =
      (long long)((N + p.bn - 1) / p.bn) * ((B + p.bm - 1) / p.bm);
  const int tiles = (K + kStep - 1) / kStep;
  const int splits = choose_splits(ctas, tiles, fwd_slots(p.cfg), kMaxSplits);
  p.k_chunk = ((tiles + splits - 1) / splits) * kStep;
  p.splits = (K + p.k_chunk - 1) / p.k_chunk;
  return p;
}

template <int BM, int BN, int WGM, int WGN>
void launch(const Plan& p, const uint8_t* patches, const void* conv_w,
            const void* conv_b, const void* e, const void* w, float* dst,
            int B, int P, int C, int E, int N, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM, p.splits);
  teacher_proj_kernel<BM, BN, WGM, WGN>
      <<<grid, kThreads, Fwd<BM, BN, WGM, WGN>::kSmem, s>>>(
          patches, (const float*)conv_w, (const float*)conv_b,
          (const float*)e, (const float*)w, dst, B, P, C, E, N, p.k_chunk);
}

}  // namespace

// Floats of workspace dcd_teacher_proj needs for this shape (the patches,
// then the split-K parts), or -1 if the kernel does not take it: C a
// multiple of 32 up to 128, K = (X-2)(Y-2)C + E a multiple of 4 (16-byte
// rows of W_i) and N a multiple of 8.
extern "C" int dcd_teacher_proj_workspace(int B, int N, int K, int C,
                                          int E) {
  if (C <= 0 || C % 32 != 0 || C > kMaxC || K % 4 != 0 || N % 8 != 0 ||
      E < 0 || K - E <= 0 || (K - E) % C != 0) {
    return -1;
  }
  if (B <= 0 || N <= 0) return 0;
  const Plan p = plan(B, N, K);
  return (int)(patch_floats(B, (K - E) / C) +
               (p.splits > 1 ? (long long)p.splits * B * N : 0));
}

// ws holds dcd_teacher_proj_workspace(B, N, K, C, E) floats.
extern "C" int dcd_teacher_proj(const void* img, const void* conv_w,
                                const void* conv_b, const void* e,
                                const void* w, void* out, void* ws, int B,
                                int X, int Y, int C, int E, int N,
                                void* stream) {
  const int P = (X - 2) * (Y - 2);
  const int K = P * C + E;
  if (dcd_teacher_proj_workspace(B, N, K, C, E) < 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)ws % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const Plan p = plan(B, N, K);
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* patches = (uint8_t*)ws;
  float* parts = (float*)ws + patch_floats(B, P);
  float* dst = p.splits > 1 ? parts : (float*)out;
  make_patches(img, patches, B, X, Y, s);
  if (p.cfg == kFwdSmall) {
    launch<32, 128, 1, 8>(p, patches, conv_w, conv_b, e, w, dst, B, P, C, E,
                          N, s);
  } else if (p.cfg == kFwdNarrow) {
    launch<128, 64, 4, 2>(p, patches, conv_w, conv_b, e, w, dst, B, P, C, E,
                          N, s);
  } else {
    launch<128, 128, 2, 4>(p, patches, conv_w, conv_b, e, w, dst, B, P, C,
                           E, N, s);
  }
  if (p.splits > 1) {
    sum_splits(parts, (float*)out, (long long)B * N, p.splits, s);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward.  Both kernels tile K by one output pixel's 128 channels
// (C = 128, the teacher's), so a K-tile's A columns come from one 3x3
// patch a row.

namespace {

constexpr int kCq = kPatch + 1;  // a channel's conv gradient: 27 weights, bias
constexpr long long kMaxWsFloats = 1LL << 28;   // 1 GiB of split partials

// dW: a BNN (n) x 128 (k) tile of dW, summed over the rows of split z in
// steps of 32 rows.  The mma's A operand is g^T, read from the g tile
// [row][n] (stride BNN + 8), its B operand the conv tile [row][k] (stride
// 136), both in the layout they are staged in.  As in the forward, the cl
// CTAs of a column of n tiles form a cluster that shares the conv tile,
// and step s + 1 is staged in four pieces during step s's product.
template <int BNN>
struct Dw {
  static constexpr int WGM = 2, WGN = 4;
  static constexpr int MT = BNN / WGM / 16, NT = kTK / WGN / 8;
  static constexpr int kLdG = BNN + 8, kLdE = kTK + 8;
  static constexpr int kG = kStep * kLdG, kE = kStep * kLdE;
  static constexpr int kStage = 2 * (kG + kE);
  static constexpr int kPbuf = kStep * kPatchBytes / 4;
  static constexpr int kSmem = (2 * kStage + kPatch * kMaxC + kMaxC + kLut +
                                2 * kPbuf) * (int)sizeof(float);
  static constexpr int kEVec = kStep * kTK / 4;         // float4s of A a step
  static constexpr int kGVec = kStep * BNN / 4 / kThreads;
  static_assert(MT >= 1 && kGVec >= 1 && kEVec == 4 * kThreads, "dW tiling");
};

template <int BNN>
__global__ void __launch_bounds__(kThreads, 1) teacher_proj_dw_kernel(
    const uint8_t* __restrict__ patches, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ e,
    const float* __restrict__ g, float* __restrict__ out, int B, int P,
    int E, int N, int rows_chunk, int cl) {
  using D = Dw<BNN>;
  extern __shared__ __align__(16) float smem[];
  float* cw = smem + 2 * D::kStage;
  float* cb = cw + kPatch * kMaxC;
  float* lut = cb + kMaxC;
  uint8_t* pbuf = reinterpret_cast<uint8_t*>(lut + kLut);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / D::WGN, wn = warp % D::WGN;
  const int conv_dim = P * kTK;
  const int K = conv_dim + E;
  const int k0 = blockIdx.x * kTK;
  const int n0 = blockIdx.y * BNN;
  const int r_begin = blockIdx.z * rows_chunk;
  const int r_end = min(B, r_begin + rows_chunk);
  const int steps = max(0, (r_end - r_begin + kStep - 1) / kStep);
  const bool conv = k0 < conv_dim;
  // This CTA's share of each conv tile: rows [rank * rows, + rows).
  const int rank = blockIdx.y % cl, mine = D::kEVec / cl, rows = kStep / cl;
  load_conv(conv_w, conv_b, kTK, cw, cb, lut);

  // Step s's patches (this CTA's rows of the step, this pixel) into patch
  // buffer s % 2.
  auto copy = [&](int s) {
    if (conv && s < steps) {
      copy_patches(patches, pbuf + (s % 2) * rows * kPatchBytes,
                   r_begin + s * kStep + rank * rows, rows, r_end, P,
                   k0 / kTK, tid, kThreads);
    }
    __pipeline_commit();
  };
  // This thread's g values of a step: 16-byte chunks along n; zeros for
  // rows past r_end or n past N.
  float4 greg[D::kGVec];
  auto fetch = [&](int s) {
    const int r0 = r_begin + s * kStep;
#pragma unroll
    for (int v = 0; v < D::kGVec; ++v) {
      const int id = tid + v * kThreads;
      const int row = r0 + id / (BNN / 4), n = n0 + (id % (BNN / 4)) * 4;
      greg[v] = (row < r_end && n < N) ? ldg4(g + (size_t)row * N + n)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // Piece q (of 4) of step s's staging into stage s % 2: the g values v =
  // q (mod 4), and float4 f = tid + 256 q of this CTA's share of the conv
  // tile: row f % rows, chunk f / rows, so that a warp's lanes share few
  // chunks' conv weights.
  auto stage = [&](int s, int q) {
    float* st = smem + (s % 2) * D::kStage;
#pragma unroll
    for (int v = q; v < D::kGVec; v += 4) {
      const int id = tid + v * kThreads;
      store_split(st + (id / (BNN / 4)) * D::kLdG + (id % (BNN / 4)) * 4,
                  D::kG, greg[v]);
    }
    const int f = tid + q * kThreads;
    if (f >= mine) return;
    const int r = rank * rows + f % rows, c = (f / rows) * 4;
    const int row = r_begin + s * kStep + r;
    float4 v;
    if (conv) {
      float x[kPatch];
      patch_values(
          pbuf + ((s % 2) * rows + r - rank * rows) * kPatchBytes, lut, x);
      v = relu4(conv4(cw, cb, x, c));
    } else {
      float u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + c + i;
        u[i] = (row < r_end && k < K) ? e[(size_t)row * E + (k - conv_dim)]
                                      : 0.0f;
      }
      v = make_float4(u[0], u[1], u[2], u[3]);
    }
    store_split_all(st + 2 * D::kG + r * D::kLdE + c, D::kE, v, cl);
  };

  float acc[D::MT][D::NT][4], part[D::MT][D::NT][4];
  zero(acc);
  zero(part);
  // g values a step ahead, loaded after the barrier, whose fence would
  // wait for them.
  if (steps > 0) {
    copy(0);
    copy(1);
    fetch(0);
    __pipeline_wait_prior(1);
    step_sync(cl);   // the conv weights, the table, step 0's patches
#pragma unroll
    for (int q = 0; q < 4; ++q) stage(0, q);
    __pipeline_wait_prior(0);
    step_sync(cl);
  }
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) fetch(s + 1);
    copy(s + 2);
    const float* st = smem + (s % 2) * D::kStage;
    const bool next = s + 1 < steps;
    warp_mma<D::MT, D::NT, 1, D::kLdG, D::kLdE, 1>(
        part, st + wm * D::MT * 16, D::kG,
        st + 2 * D::kG + wn * D::NT * 8, D::kE, [&](int q) {
          if (next) stage(s + 1, q);
        });
    if ((s + 1) % kPromote == 0 || s + 1 == steps) promote(acc, part);
    __pipeline_wait_prior(0);
    step_sync(cl);
  }

  const int lane = tid % 32, gq = lane / 4, t = lane % 4;
  float* o = out + (size_t)blockIdx.z * N * K;
#pragma unroll
  for (int i = 0; i < D::MT; ++i) {
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
      const int k = k0 + (wn * D::NT + j) * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = n0 + (wm * D::MT + i) * 16 + gq + 8 * hh;
        if (n < N && k < K) {
          *reinterpret_cast<float2*>(o + (size_t)n * K + k) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
  }
}

// dA: 128 rows x 128 k for each row tile of split z, the sum over n in
// steps of 32.  The mma's A operand is the g tile [row][n] (stride 36),
// its B operand the W_i tile [n][k] (stride 136).  After a row tile's
// product, a conv K-tile writes dA to shared memory, masks it by ReLU' of
// the pre-activation (conv_pre's order) and adds its rows' dA (x) patch
// into its 128 channels' conv gradients, which go to conv_ws[pixel][z]
// at the end; the e tile writes g_e.  The row tile's patches arrive by
// cp.async during its product.
struct Da {
  static constexpr int BM = 128, WGM = 2, WGN = 4;
  static constexpr int MT = BM / WGM / 16, NT = kTK / WGN / 8;
  static constexpr int kLdG = kStep + 4, kLdW = kTK + 8, kLdD = kTK + 8;
  static constexpr int kG = BM * kLdG, kW = kStep * kLdW;
  static constexpr int kStage = 2 * (kG + kW);
  static constexpr int kPatchLd = kCq;          // 27 patch values and a 1
  static constexpr int kPbuf = BM * kPatchBytes / 4;
  static constexpr int kSmem = (2 * kStage + kPbuf + kPatch * kMaxC + kMaxC +
                                kLut) * (int)sizeof(float);
  static_assert(BM * (kLdD + kPatchLd) <= 2 * kStage && kThreads == 2 * BM &&
                    kThreads == 2 * kTK,
                "dA tiling");
};

__global__ void __launch_bounds__(kThreads, 1) teacher_proj_da_kernel(
    const uint8_t* __restrict__ patches, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ g,
    const float* __restrict__ w, float* __restrict__ g_e,
    float* __restrict__ conv_ws, int B, int P, int E, int N,
    int rows_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* dpre = smem;                          // aliases the stages
  float* patch = smem + Da::BM * Da::kLdD;     // so does this
  uint8_t* pbuf = reinterpret_cast<uint8_t*>(smem + 2 * Da::kStage);
  float* cw = smem + 2 * Da::kStage + Da::kPbuf;
  float* cb = cw + kPatch * kMaxC;
  float* lut = cb + kMaxC;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / Da::WGN, wn = warp % Da::WGN;
  const int lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int conv_dim = P * kTK;
  const int K = conv_dim + E;
  const int k0 = blockIdx.x * kTK;
  const int r_begin = blockIdx.z * rows_chunk;
  const int r_end = min(B, r_begin + rows_chunk);
  const bool conv = k0 < conv_dim;
  const int steps = (N + kStep - 1) / kStep;
  load_conv(conv_w, conv_b, kTK, cw, cb, lut);
  // conv gradients: channel cc, q in [cq * 14, cq * 14 + 14) (27: bias)
  const int cc = tid % kTK, cq = tid / kTK;
  float cacc[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) cacc[j] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += Da::BM) {
    // This thread's g and W_i values of step s: 16-byte chunks, g along n
    // (8 threads a row), W_i along k (32 threads a row of 128 k).
    float4 greg[4], wreg[4];
    auto fetch = [&](int s) {
      const int nb = s * kStep;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int id = tid + v * kThreads;
        const int row = r0 + id / 8, n = nb + (id % 8) * 4;
        greg[v] = (row < r_end && n < N) ? ldg4(g + (size_t)row * N + n)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        const int nw = nb + id / 32, k = k0 + (id % 32) * 4;
        wreg[v] = (nw < N && k < K) ? ldg4(w + (size_t)nw * K + k)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto stage = [&](int s) {
      float* st = smem + (s % 2) * Da::kStage;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int id = tid + v * kThreads;
        store_split(st + (id / 8) * Da::kLdG + (id % 8) * 4, Da::kG,
                    greg[v]);
        store_split(st + 2 * Da::kG + (id / 32) * Da::kLdW + (id % 32) * 4,
                    Da::kW, wreg[v]);
      }
    };

    float acc[Da::MT][Da::NT][4], part[Da::MT][Da::NT][4];
    zero(acc);
    zero(part);
    fetch(0);
    __syncthreads();   // the conv weights; the last row tile's epilogue
    if (conv) {
      copy_patches(patches, pbuf, r0, Da::BM, r_end, P, k0 / kTK, tid,
                   kThreads);
    }
    __pipeline_commit();
    stage(0);
    if (steps > 1) fetch(1);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float* st = smem + (s % 2) * Da::kStage;
      warp_mma<Da::MT, Da::NT, Da::kLdG, 1, Da::kLdW, 1>(
          part, st + wm * Da::MT * 16 * Da::kLdG, Da::kG,
          st + 2 * Da::kG + wn * Da::NT * 8, Da::kW, Nothing());
      if ((s + 1) % kPromote == 0 || s + 1 == steps) promote(acc, part);
      if (s + 1 < steps) stage(s + 1);
      if (s + 2 < steps) fetch(s + 2);
      __syncthreads();
    }

    if (!conv) {
#pragma unroll
      for (int i = 0; i < Da::MT; ++i) {
#pragma unroll
        for (int j = 0; j < Da::NT; ++j) {
          const int k = k0 + (wn * Da::NT + j) * 8 + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + (wm * Da::MT + i) * 16 + gq + 8 * hh;
            if (row < r_end && k < K) {
              *reinterpret_cast<float2*>(
                  g_e + (size_t)row * E + (k - conv_dim)) =
                  make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
            }
          }
        }
      }
      continue;
    }
    // dA [row][c] into shared memory (the stages are free: every warp is
    // past the loop's last barrier); the patches have landed.
#pragma unroll
    for (int i = 0; i < Da::MT; ++i) {
#pragma unroll
      for (int j = 0; j < Da::NT; ++j) {
        const int c = (wn * Da::NT + j) * 8 + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = (wm * Da::MT + i) * 16 + gq + 8 * hh;
          *reinterpret_cast<float2*>(dpre + r * Da::kLdD + c) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    {
      // ReLU': row tid % 128, channels 4 h + 8 j (h = tid / 128); the
      // h = 0 threads also write the row's patch values and a 1 (the
      // bias's column) for the reduction.
      const int r = tid % Da::BM, h = tid / Da::BM;
      float x[kPatch];
      patch_values(pbuf + r * kPatchBytes, lut, x);
      if (h == 0) {
#pragma unroll
        for (int q = 0; q < kPatch; ++q) patch[r * Da::kPatchLd + q] = x[q];
        patch[r * Da::kPatchLd + kPatch] = 1.0f;
      }
      float* d = dpre + r * Da::kLdD;
#pragma unroll 4
      for (int j = 0; j < kTK / 8; ++j) {
        const int c = 4 * h + 8 * j;
        const float4 v = conv4(cw, cb, x, c);
        float4 dv = *reinterpret_cast<float4*>(d + c);
        dv.x = v.x > 0.0f ? dv.x : 0.0f;
        dv.y = v.y > 0.0f ? dv.y : 0.0f;
        dv.z = v.z > 0.0f ? dv.z : 0.0f;
        dv.w = v.w > 0.0f ? dv.w : 0.0f;
        *reinterpret_cast<float4*>(d + c) = dv;
      }
    }
    __syncthreads();
    for (int r = 0; r < Da::BM; ++r) {
      const float d = dpre[r * Da::kLdD + cc];
      const float* pr = patch + r * Da::kPatchLd + cq * 14;
#pragma unroll
      for (int j = 0; j < 14; ++j) cacc[j] = fmaf(d, pr[j], cacc[j]);
    }
    // the next row tile's first barrier frees dpre, patch and pbuf
  }
  if (conv) {
    float* dst = conv_ws +
                 ((size_t)blockIdx.x * gridDim.z + blockIdx.z) * kTK * kCq;
#pragma unroll
    for (int j = 0; j < 14; ++j) dst[cc * kCq + cq * 14 + j] = cacc[j];
  }
}

// d conv_w[c][q] and d conv_b[c]: the sum over the pixels' K-tiles and
// the splits, in that order, in double, rounded once: the P * splits
// partials largely cancel, and an fp32 running sum would add errors of
// the partials' size to small gradients.
__global__ void conv_grad_sum_kernel(const float* __restrict__ ws,
                                     float* __restrict__ dconv_w,
                                     float* __restrict__ dconv_b, int P,
                                     int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTK * kCq) return;
  const int c = i / kCq, q = i % kCq;
  double s = 0.0;
  for (int p = 0; p < P; ++p) {
    for (int sp = 0; sp < splits; ++sp) {
      s += (double)ws[((size_t)p * splits + sp) * kTK * kCq + i];
    }
  }
  if (q < kPatch) {
    dconv_w[c * kPatch + q] = (float)s;
  } else {
    dconv_b[c] = (float)s;
  }
}

int dw_slots(int bnn) {
  static int s64 = 0, s128 = 0;
  int& s = bnn == 64 ? s64 : s128;
  if (s == 0) {
    s = bnn == 64 ? occupancy_slots(teacher_proj_dw_kernel<64>,
                                    Dw<64>::kSmem, kThreads)
                  : occupancy_slots(teacher_proj_dw_kernel<128>,
                                    Dw<128>::kSmem, kThreads);
  }
  return s;
}

int da_slots() {
  static int s = 0;
  if (s == 0) {
    s = occupancy_slots(teacher_proj_da_kernel, Da::kSmem, kThreads);
  }
  return s;
}

struct BwdPlan {
  int bnn, dw_splits, dw_rows, da_splits, da_rows;
  long long patch_ws, dw_ws, conv_ws;   // floats of workspace
};

BwdPlan bwd_plan(int B, int N, int K, int conv_dim) {
  BwdPlan p;
  p.bnn = N <= 64 ? 64 : 128;
  const int k_tiles = (K + kTK - 1) / kTK;
  const long long dw_tiles = (long long)k_tiles * ((N + p.bnn - 1) / p.bnn);
  const int dw_steps = (B + kStep - 1) / kStep;
  const long long split_floats = (long long)N * K;
  const int dw_max = (int)std::min<long long>(
      kMaxSplits, std::max<long long>(1, kMaxWsFloats / split_floats));
  int sp = choose_splits(dw_tiles, dw_steps, dw_slots(p.bnn), dw_max);
  p.dw_rows = ((dw_steps + sp - 1) / sp) * kStep;
  p.dw_splits = (B + p.dw_rows - 1) / p.dw_rows;
  p.dw_ws = p.dw_splits > 1 ? p.dw_splits * split_floats : 0;
  const int da_steps = (B + Da::BM - 1) / Da::BM;
  sp = choose_splits(k_tiles, da_steps, da_slots(), kMaxSplits);
  p.da_rows = ((da_steps + sp - 1) / sp) * Da::BM;
  p.da_splits = (B + p.da_rows - 1) / p.da_rows;
  p.conv_ws = (long long)(conv_dim / kTK) * p.da_splits * kTK * kCq;
  p.patch_ws = patch_floats(B, conv_dim / kTK);
  return p;
}

}  // namespace

// Floats of workspace dcd_teacher_proj_backward needs for this shape, or
// -1 if it does not take it: C = 128 (the K-tile is one pixel's channels),
// K = (X-2)(Y-2)C + E a multiple of 4 and N a multiple of 8.
extern "C" int dcd_teacher_proj_backward_workspace(int B, int N, int K, int C,
                                                  int E) {
  if (C != kTK || K % 4 != 0 || N % 8 != 0 || E < 0 || K - E <= 0 ||
      (K - E) % C != 0) {
    return -1;
  }
  if (B <= 0 || N <= 0) return 0;
  const BwdPlan p = bwd_plan(B, N, K, K - E);
  return (int)(p.patch_ws + p.dw_ws + p.conv_ws);
}

// The gradients of zx = [relu(conv(img / 10)) || e] @ W_i^T given
// g = d zx (B, N): dW (N, K), d conv_w (C, 3, 3, 3), d conv_b (C,) and
// g_e (B, E), all overwritten.  ws holds
// dcd_teacher_proj_backward_workspace(B, N, K, C, E) floats.  ``parts``
// picks the kernels: 1 dW, 2 dA (the conv gradients and g_e), 3 both (a
// timing of one alone leaves the other's outputs unwritten).
extern "C" int dcd_teacher_proj_backward(
    const void* img, const void* conv_w, const void* conv_b, const void* e,
    const void* w, const void* g, void* dw, void* dconv_w, void* dconv_b,
    void* g_e, void* ws, int B, int X, int Y, int C, int E, int N, int parts,
    void* stream) {
  const int conv_dim = (X - 2) * (Y - 2) * C;
  const int K = conv_dim + E;
  if (dcd_teacher_proj_backward_workspace(B, N, K, C, E) < 0 ||
      (uintptr_t)w % 16 != 0 || (uintptr_t)g % 16 != 0 ||
      (uintptr_t)dw % 16 != 0 || (uintptr_t)ws % 16 != 0 || parts < 1 ||
      parts > 3) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const BwdPlan p = bwd_plan(B, N, K, conv_dim);
  cudaStream_t s = (cudaStream_t)stream;
  const int P = (X - 2) * (Y - 2);
  const int k_tiles = (K + kTK - 1) / kTK;
  uint8_t* patches = (uint8_t*)ws;
  float* dw_part = (float*)ws + p.patch_ws;
  float* conv_part = dw_part + p.dw_ws;
  float* dw_dst = p.dw_splits > 1 ? dw_part : (float*)dw;
  const dim3 dw_grid(k_tiles, (N + p.bnn - 1) / p.bnn, p.dw_splits);
  make_patches(img, patches, B, X, Y, s);
  const int cl = cluster_size(dw_grid.y);
  if (!(parts & 1)) {
    // dA alone
  } else if (p.bnn == 64) {
    launch_clusters(teacher_proj_dw_kernel<64>, dw_grid, dim3(1, cl, 1),
                    Dw<64>::kSmem, s, (const uint8_t*)patches,
                    (const float*)conv_w, (const float*)conv_b,
                    (const float*)e, (const float*)g, dw_dst, B, P, E, N,
                    p.dw_rows, cl);
  } else {
    launch_clusters(teacher_proj_dw_kernel<128>, dw_grid, dim3(1, cl, 1),
                    Dw<128>::kSmem, s, (const uint8_t*)patches,
                    (const float*)conv_w, (const float*)conv_b,
                    (const float*)e, (const float*)g, dw_dst, B, P, E, N,
                    p.dw_rows, cl);
  }
  if ((parts & 1) && p.dw_splits > 1) {
    sum_splits(dw_part, (float*)dw, (long long)N * K, p.dw_splits, s);
  }
  if (!(parts & 2)) return (int)cudaGetLastError();
  teacher_proj_da_kernel<<<dim3(k_tiles, 1, p.da_splits), kThreads,
                           Da::kSmem, s>>>(
      patches, (const float*)conv_w, (const float*)conv_b, (const float*)g,
      (const float*)w, (float*)g_e, conv_part, B, P, E, N, p.da_rows);
  conv_grad_sum_kernel<<<(kTK * kCq + kThreads - 1) / kThreads, kThreads, 0,
                         s>>>(conv_part, (float*)dconv_w, (float*)dconv_b, P,
                              p.da_splits);
  return (int)cudaGetLastError();
}
