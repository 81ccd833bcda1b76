// The teacher's conv-128 embed fused into its LSTM input projection.
//
// Replaces the forward of dcd_isaac_tpu/models/multigrid_models.py
// _core_sequence.zx_chunk (:120-152) with _embed (:75-89), and the same
// projection of the one-step forward:
//   zx[b, :] = [relu(conv3x3(img[b] / 10) + bias) flattened (h, w, c)
//               || e[b]] @ W_i^T
// img (B, X, Y, 3) uint8 (NHWC, the JAX layout), conv weight (C, 3, 3, 3)
// OIHW, bias (C,), e (B, E) the scalar embed and random_z, W_i (N, K)
// row-major with K = (X-2)(Y-2)C + E, zx (B, N) float32.
//
// A tiled fp32 SIMT GEMM whose A operand is produced by its prologue: each
// K-tile of 32 conv features (one output pixel, 32 channels, since C is a
// multiple of 32) is computed from the 3x3x3 image patch as the tile is
// consumed, so the (B, K) activation never reaches device memory.
//   * Block tile BM x 128 over (B, N), 256 threads; each thread holds
//     (BM/16) x 8 outputs and reads its operands as float4 along k, so a
//     step of 4 k costs 2 * BM/16 + 8 shared loads for 32 * BM/16 FMAs.
//   * W_i tiles are copied with cp.async into kStages shared buffers: the
//     copies of the next kStages - 1 tiles are in flight while tile t is
//     multiplied.  At most 128 registers a thread, so two CTAs share an SM
//     and one's prologue overlaps the other's product.
//   * In the prologue each thread embeds one row for BM/8 channels, with
//     the conv weights stored [q][c] so that a warp reads them as one
//     broadcast float4 per 4 FMAs.
//   * The K range is split over gridDim.z CTAs (split-K) so that a batch
//     of 32 still fills the card; a second kernel sums the splits in a
//     fixed order (the result does not depend on scheduling).
// No tensor cores: TF32 is off in the port, and wgmma/TMA is later work.
//
// The entry points own the tiling rules: dcd_teacher_proj_workspace says
// whether a shape is supported and how much split-K workspace it needs,
// and dcd_teacher_proj launches with the same plan.
//
// Bound on the H100: at B = 32, bytes (W_i's 88.9 MB once, 26.5 us at
// 3.35 TB/s); at B = 864 (the teacher update), operations
// (2 * B * K * N + the conv's 2 * 27 * B * K, ~0.57 ms at 67 TFLOP/s).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 32;          // K-tile: 32 channels of one output pixel
constexpr int kBN = 128;         // N-tile
constexpr int kThreads = 256;
constexpr int kLd = kBK + 4;     // row stride of the shared tiles (floats)
constexpr int kPatch = 27;       // 3 input channels x 3 x 3
constexpr int kMaxC = 128;       // conv filters held in shared memory
constexpr int kMaxSplits = 64;
constexpr int kStages = 3;       // W_i tiles in shared memory at once

template <int BM>
struct Smem {
  float bs[kStages][kBN][kLd];  // W_i tiles [n][k], a ring of kStages
  float as[BM][kLd];           // conv features or e columns [m][k]
  float patch[BM][kPatch];     // each row's image patch / 10
  float w[kPatch][kMaxC];      // conv weights [q][c]
  float bias[kMaxC];
};

template <int BM>
__global__ void __launch_bounds__(kThreads, 2) teacher_proj_kernel(
    const uint8_t* __restrict__ img, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ e,
    const float* __restrict__ w, float* __restrict__ out, int B, int X,
    int Y, int C, int E, int N, int k_chunk) {
  constexpr int TM = BM / 16;        // rows per thread in the product
  constexpr int CPT = BM / 8;        // channels per thread in the prologue
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<BM>& s = *reinterpret_cast<Smem<BM>*>(smem_raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * BM;
  const int OY = Y - 2;
  const int conv_dim = (X - 2) * OY * C;
  const int K = conv_dim + E;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;

  // Tile t of W_i into buffer t % kStages: 128 rows of 32 k as 16-byte
  // copies, eight consecutive threads per row.  Chunks past N or k_end are zeros
  // (k_end and K are multiples of 4, so a chunk is wholly in or out).
  auto load_w = [&](int t) {
    const int k0 = k_begin + t * kBK;
    float(*dst)[kLd] = s.bs[t % kStages];
#pragma unroll
    for (int r = 0; r < kBN * kBK / 4 / kThreads; ++r) {
      const int id = tid + r * kThreads;
      const int nn = id / (kBK / 4), kq = (id % (kBK / 4)) * 4;
      const int n = n0 + nn, k = k0 + kq;
      float* d = &dst[nn][kq];
      if (n < N && k < k_end) {
        __pipeline_memcpy_async(d, w + (size_t)n * K + k, 16);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  // One commit group per tile, empty past the last, so that waiting for
  // all but the newest kStages - 1 groups means tile t has landed.
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_w(t);
    __pipeline_commit();
  }
  for (int i = tid; i < C * kPatch; i += kThreads) {
    s.w[i % kPatch][i / kPatch] = conv_w[i];
  }
  for (int i = tid; i < C; i += kThreads) s.bias[i] = conv_b[i];

  const int pm = tid % BM;                 // the row this thread embeds
  const int pc = (tid / BM) * CPT;         // its first channel in a tile
  const int tx = tid % 16, ty = tid / 16;  // its outputs in the product
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int cur_p = -1;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = k_begin + t * kBK;
    // The A tile: 32 conv features of one output pixel, or e columns.
    if (k0 < conv_dim) {
      const int p = k0 / C;
      if (p != cur_p) {
        __syncthreads();   // s.w on the first tile; no patch reader left
        const int pi = p / OY, pj = p % OY;
        for (int i = tid; i < BM * kPatch; i += kThreads) {
          const int m = i / kPatch, q = i % kPatch;
          const int ci = q / 9, di = (q / 3) % 3, dj = q % 3;
          const int row = row0 + m;
          s.patch[m][q] =
              row < B ? (float)img[(((size_t)row * X + pi + di) * Y + pj +
                                    dj) * 3 + ci] / 10.0f
                      : 0.0f;
        }
        cur_p = p;
        __syncthreads();
      }
      // Four channels at a time, to keep the registers for the product.
      const int c0 = k0 - p * C + pc;
#pragma unroll
      for (int c = 0; c < CPT; c += 4) {
        float4 v = *reinterpret_cast<const float4*>(&s.bias[c0 + c]);
#pragma unroll
        for (int q = 0; q < kPatch; ++q) {
          const float x = s.patch[pm][q];
          const float4 w4 = *reinterpret_cast<const float4*>(&s.w[q][c0 + c]);
          v.x = fmaf(w4.x, x, v.x);
          v.y = fmaf(w4.y, x, v.y);
          v.z = fmaf(w4.z, x, v.z);
          v.w = fmaf(w4.w, x, v.w);
        }
        *reinterpret_cast<float4*>(&s.as[pm][pc + c]) = make_float4(
            fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
            fmaxf(v.w, 0.f));
      }
    } else {
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int m = i / kBK, kk = i % kBK;
        const int row = row0 + m, k = k0 + kk;
        s.as[m][kk] = (row < B && k < k_end)
                          ? e[(size_t)row * E + (k - conv_dim)]
                          : 0.0f;
      }
    }
    // Its buffer was last read by tile t - 1, done at the loop's end.
    if (t + kStages - 1 < tiles) load_w(t + kStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();

    const float(*bs)[kLd] = s.bs[t % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      // Half of the thread's columns at a time keeps it within 128
      // registers; the A operand is read once for each half.
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = *reinterpret_cast<const float4*>(&bs[tx + 16 * (h + j)][kk]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(&s.as[ty + 16 * i][kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float c = acc[i][h + j];
            c = fmaf(a.x, b[j].x, c);
            c = fmaf(a.y, b[j].y, c);
            c = fmaf(a.z, b[j].z, c);
            c = fmaf(a.w, b[j].w, c);
            acc[i][h + j] = c;
          }
        }
      }
    }
    __syncthreads();   // s.as and this buffer are free for the next tiles
  }

  float* o = out + (size_t)blockIdx.z * B * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) o[(size_t)row * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over s of ws[s][i], in order of s.
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int count,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = ws[i];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, ws[(size_t)k * count + i]);
  out[i] = s;
}

// Row tile of a construction step's batch (B <= 32) and of larger ones.
constexpr int kSmallBM = 32, kLargeBM = 64;

struct Plan {
  int bm, splits, k_chunk;
};

// CTAs of the kernel with row tile BM that fit on the card at once.
template <int BM>
int slots() {
  static int per_sm = 0;
  if (per_sm == 0) {
    const void* fn = (const void*)teacher_proj_kernel<BM>;
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem<BM>));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                  sizeof(Smem<BM>));
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * per_sm;
}

// The row tile, and the split count that minimises waves x tiles per CTA,
// preferring fewer splits.
Plan plan(int B, int N, int K) {
  Plan p;
  p.bm = B <= kSmallBM ? kSmallBM : kLargeBM;
  const int ctas = ((N + kBN - 1) / kBN) * ((B + p.bm - 1) / p.bm);
  const int tiles = (K + kBK - 1) / kBK;
  const long long slot =
      p.bm == kSmallBM ? slots<kSmallBM>() : slots<kLargeBM>();
  long long best = -1;
  int splits = 1;
  for (int sp = 1; sp <= kMaxSplits && sp <= tiles; ++sp) {
    const long long waves = ((long long)ctas * sp + slot - 1) / slot;
    const long long cost = waves * ((tiles + sp - 1) / sp);
    if (best < 0 || cost * 100 < best * 97) {
      best = cost;
      splits = sp;
    }
  }
  p.k_chunk = ((tiles + splits - 1) / splits) * kBK;
  p.splits = (K + p.k_chunk - 1) / p.k_chunk;
  return p;
}

template <int BM>
void launch(const Plan& p, const void* img, const void* conv_w,
            const void* conv_b, const void* e, const void* w, float* dst,
            int B, int X, int Y, int C, int E, int N, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (B + BM - 1) / BM, p.splits);
  teacher_proj_kernel<BM><<<grid, kThreads, sizeof(Smem<BM>), s>>>(
      (const uint8_t*)img, (const float*)conv_w, (const float*)conv_b,
      (const float*)e, (const float*)w, dst, B, X, Y, C, E, N, p.k_chunk);
}

}  // namespace

// Floats of split-K workspace dcd_teacher_proj needs for this shape (0 if
// none), or -1 if the kernel does not take it: C a multiple of 32 up to
// 128, and K = (X-2)(Y-2)C + E a multiple of 4 (16-byte rows of W_i).
extern "C" int dcd_teacher_proj_workspace(int B, int N, int K, int C) {
  if (C <= 0 || C % kBK != 0 || C > kMaxC || K % 4 != 0) return -1;
  if (B <= 0 || N <= 0) return 0;
  const Plan p = plan(B, N, K);
  return p.splits > 1 ? p.splits * B * N : 0;
}

// ws holds dcd_teacher_proj_workspace(B, N, K, C) floats (unused when 0).
extern "C" int dcd_teacher_proj(const void* img, const void* conv_w,
                                const void* conv_b, const void* e,
                                const void* w, void* out, void* ws, int B,
                                int X, int Y, int C, int E, int N,
                                void* stream) {
  const int K = (X - 2) * (Y - 2) * C + E;
  if (dcd_teacher_proj_workspace(B, N, K, C) < 0 ||
      (uintptr_t)w % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const Plan p = plan(B, N, K);
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = p.splits > 1 ? (float*)ws : (float*)out;
  if (p.bm == kSmallBM) {
    launch<kSmallBM>(p, img, conv_w, conv_b, e, w, dst, B, X, Y, C, E, N, s);
  } else {
    launch<kLargeBM>(p, img, conv_w, conv_b, e, w, dst, B, X, Y, C, E, N, s);
  }
  if (p.splits > 1) {
    const int count = B * N;
    sum_splits_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const float*)ws, (float*)out, count, p.splits);
  }
  return (int)cudaGetLastError();
}
