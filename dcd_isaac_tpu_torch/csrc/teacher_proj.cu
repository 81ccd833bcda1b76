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
//
// The backward (teacher_proj_dw_kernel, teacher_proj_da_kernel), given
// g = d zx (B, N):
//   dW = g^T A (N, K), the reduction over the rows split over gridDim.z;
//   dA = g W_i (B, K), never stored: in its epilogue the conv columns are
//        multiplied by ReLU' of the recomputed pre-activation and reduced
//        straight into the conv weight and bias gradients, and the last E
//        columns are written as g_e (B, E).
// Both tile K by one output pixel's 128 channels (the teacher's C = 128)
// and recompute A's conv columns from the image in the forward's order,
// so the (B, K) embed is not written on either pass; each thread holds an
// 8 x 8 block of outputs, and the next step's operands are in flight
// (cp.async, registers) while a step's product runs.  Partial sums (the
// split rows of dW, each pixel's share of the conv gradients) go to a
// workspace and a second kernel sums them in a fixed order: no float
// atomics, two runs give the same bits.  The backward is bound by
// operations (2 * B * N * K each product): at N = 1024, B = 864 about
// 1.15 ms; at B = 52 * 8192 about 0.56 s; at N = 64, B = 864 about 0.07
// ms.

#include <algorithm>
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

// ---------------------------------------------------------------------------
// The backward.  Both kernels tile K by one output pixel's 128 channels
// (kTK: C = 128, the teacher's), so a K-tile's A columns come from one 3x3
// patch a row, and give each thread an 8 x 8 block of outputs.

namespace {

constexpr int kTK = 128;         // K-tile: the 128 channels of one pixel
constexpr int kDwStep = 32;      // rows a dW step
constexpr int kStep = 8;         // n a dA step
constexpr int kDaBM = 128;       // rows a dA tile
constexpr int kCq = kPatch + 1;  // a channel's conv gradient: 27 weights, bias
constexpr long long kMaxWsFloats = 1LL << 28;   // 1 GiB of split partials
static_assert(kThreads == 256 && kTK == 128 && kDaBM == 128 && kStep == 8 &&
                  kDwStep * kTK % kThreads == 0,
              "the backward kernels' thread layouts");

// The K-tile's 128 channels' conv weights ([q][c]) and biases.
struct TileConv {
  float w[kPatch][kTK];
  float bias[kTK];
};

template <int BNN>
struct DwSmem {
  float gs[2][kDwStep][BNN];     // g tiles [row][n], two in flight
  float as[kDwStep][kTK + 4];    // A tile [row][k]
  float patch[kDwStep][kPatch];  // the step's patches / 10
  TileConv conv;
};

struct DaSmem {
  float gs[2][kStep][kDaBM + 4];   // g tiles [n][row], two in flight
  float ws[2][kStep][kTK];         // W_i tiles [n][k]
  float patch[kDaBM][kPatch];
  float dpre[kDaBM][kTK + 1];      // dA * ReLU'(pre) of the conv tile
  TileConv conv;
};

__device__ __forceinline__ void load_tile_conv(
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    TileConv& t) {
  for (int i = threadIdx.x; i < kTK * kPatch; i += kThreads) {
    t.w[i % kPatch][i / kPatch] = conv_w[i];
  }
  for (int i = threadIdx.x; i < kTK; i += kThreads) t.bias[i] = conv_b[i];
}

// Byte q of row `row`'s patch at pixel (pi, pj) / 10, 0 past r_end.
__device__ __forceinline__ float patch_at(const uint8_t* __restrict__ img,
                                          int row, int r_end, int q, int X,
                                          int Y, int pi, int pj) {
  const int ci = q / 9, di = (q / 3) % 3, dj = q % 3;
  return row < r_end
             ? (float)img[(((size_t)row * X + pi + di) * Y + pj + dj) * 3 +
                          ci] / 10.0f
             : 0.0f;
}

// The conv pre-activation of one row and channel, in the forward's order.
__device__ __forceinline__ float conv_pre(const TileConv& t,
                                          const float* patch_row, int c) {
  float v = t.bias[c];
#pragma unroll
  for (int q = 0; q < kPatch; ++q) v = fmaf(t.w[q][c], patch_row[q], v);
  return v;
}

__device__ __forceinline__ void fma8(float (&acc)[8], float a,
                                     const float4& b0, const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

// dW tile: BNN rows of W_i (n) x 128 k, summed over the rows of split z in
// steps of 32.  Thread (tn, tk) holds n tn*TN.. and k tk*8..  The next
// step's g tile arrives by cp.async and its patch bytes in registers while
// this step's A tile and product run (the one e tile reads e directly).
template <int BNN>
__global__ void __launch_bounds__(kThreads, 2) teacher_proj_dw_kernel(
    const uint8_t* __restrict__ img, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ e,
    const float* __restrict__ g, float* __restrict__ out, int B, int X,
    int Y, int E, int N, int rows_chunk) {
  constexpr int TN = BNN / 16;                   // n per thread
  constexpr int kChunks = kDwStep * BNN / 4;     // 16-byte copies of a g tile
  constexpr int kPatchIn = (kDwStep * kPatch + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<BNN>& s = *reinterpret_cast<DwSmem<BNN>*>(smem_raw);
  const int tid = threadIdx.x;
  const int OY = Y - 2;
  const int conv_dim = (X - 2) * OY * kTK;
  const int K = conv_dim + E;
  const int k0 = blockIdx.x * kTK;
  const int n0 = blockIdx.y * BNN;
  const int r_begin = blockIdx.z * rows_chunk;
  const int r_end = min(B, r_begin + rows_chunk);
  const bool conv = k0 < conv_dim;
  const int pi = (k0 / kTK) / OY, pj = (k0 / kTK) % OY;
  if (conv) load_tile_conv(conv_w, conv_b, s.conv);
  const int tk = tid % 16, tn = tid / 16;
  float acc[TN][8];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Step r0's g tile (16-byte copies; rows past r_end or n past N zeros)
  // into buffer buf, and its patch entries ([row][q] flattened) into
  // registers.
  float ppre[kPatchIn];
  auto fetch = [&](int r0, int buf) {
    for (int i = tid; i < kChunks; i += kThreads) {
      const int b = i / (BNN / 4), nq = (i % (BNN / 4)) * 4;
      const int row = r0 + b, n = n0 + nq;
      float* d = &s.gs[buf][b][nq];
      if (row < r_end && n < N) {
        __pipeline_memcpy_async(d, g + (size_t)row * N + n, 16);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __pipeline_commit();
#pragma unroll
    for (int v = 0; v < kPatchIn; ++v) {
      const int i = tid + v * kThreads;
      ppre[v] = conv && i < kDwStep * kPatch
                    ? patch_at(img, r0 + i / kPatch, r_end, i % kPatch, X, Y,
                               pi, pj)
                    : 0.0f;
    }
  };

  int buf = 0;
  if (r_begin < r_end) fetch(r_begin, 0);
  for (int r0 = r_begin; r0 < r_end; r0 += kDwStep, buf ^= 1) {
    if (conv) {
#pragma unroll
      for (int v = 0; v < kPatchIn; ++v) {
        const int i = tid + v * kThreads;
        if (i < kDwStep * kPatch) s.patch[i / kPatch][i % kPatch] = ppre[v];
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();   // the g tile, the patches, the conv weights; the
                       // last step's product is done with s.as
    for (int i = tid; i < kDwStep * kTK; i += kThreads) {
      const int b = i / kTK, c = i % kTK;
      const int row = r0 + b, k = k0 + c;
      s.as[b][c] = conv ? fmaxf(conv_pre(s.conv, s.patch[b], c), 0.0f)
                        : (row < r_end && k < K)
                              ? e[(size_t)row * E + (k - conv_dim)]
                              : 0.0f;
    }
    if (r0 + kDwStep < r_end) fetch(r0 + kDwStep, buf ^ 1);
    __syncthreads();   // the A tile
#pragma unroll 4
    for (int b = 0; b < kDwStep; ++b) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.as[b][tk * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.as[b][tk * 8 + 4]);
#pragma unroll
      for (int i = 0; i < TN; i += 4) {
        const float4 gv =
            *reinterpret_cast<const float4*>(&s.gs[buf][b][tn * TN + i]);
        fma8(acc[i], gv.x, a0, a1);
        fma8(acc[i + 1], gv.y, a0, a1);
        fma8(acc[i + 2], gv.z, a0, a1);
        fma8(acc[i + 3], gv.w, a0, a1);
      }
    }
  }

  float* o = out + (size_t)blockIdx.z * N * K;
  const int k = k0 + tk * 8;
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int n = n0 + tn * TN + i;
    if (n >= N) continue;
    float* row = o + (size_t)n * K + k;
    if (k < K) {
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (k + 4 < K) {
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// dA tile: 128 rows x 128 k for each row tile of split z, the sum over n
// in steps of 8.  Thread (tr, tk) holds rows tr*8.. and k tk*8..  A conv
// K-tile adds its rows' dA * ReLU'(pre) (x) patch into its 128 channels'
// conv gradients and writes them to conv_ws[pixel][z]; the e tile writes
// g_e.  The next n-step's W_i tile arrives by cp.async and its g tile in
// registers while this step's product runs.
__global__ void __launch_bounds__(kThreads) teacher_proj_da_kernel(
    const uint8_t* __restrict__ img, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ g,
    const float* __restrict__ w, float* __restrict__ g_e,
    float* __restrict__ conv_ws, int B, int X, int Y, int E, int N,
    int rows_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DaSmem& s = *reinterpret_cast<DaSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int OY = Y - 2;
  const int conv_dim = (X - 2) * OY * kTK;
  const int K = conv_dim + E;
  const int k0 = blockIdx.x * kTK;
  const int r_begin = blockIdx.z * rows_chunk;
  const int r_end = min(B, r_begin + rows_chunk);
  const bool conv = k0 < conv_dim;
  const int pi = (k0 / kTK) / OY, pj = (k0 / kTK) % OY;
  if (conv) load_tile_conv(conv_w, conv_b, s.conv);
  const int tk = tid % 16, tr = tid / 16;
  // the g tile's entries of this thread: row gr, n gh*4..+3 (a warp's
  // transposed stores s.gs[n][row] fall in 32 banks); its W_i chunk
  const int gr = tid / 2, gh = tid % 2;
  const int wn = tid / (kTK / 4), wk = (tid % (kTK / 4)) * 4;
  // conv gradients: channel cc of q in [cq * 14, cq * 14 + 14)
  const int cc = tid % kTK, cq = tid / kTK;
  float cacc[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) cacc[j] = 0.0f;

  float4 gpre;
  auto fetch = [&](int r0, int nb, int buf) {
    const int row = r0 + gr, n = nb + gh * 4;
    gpre = (row < r_end && n < N)
               ? *reinterpret_cast<const float4*>(g + (size_t)row * N + n)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = &s.ws[buf][wn][wk];
    if (nb + wn < N && k0 + wk < K) {
      __pipeline_memcpy_async(d, w + (size_t)(nb + wn) * K + k0 + wk, 16);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __pipeline_commit();
  };

  for (int r0 = r_begin; r0 < r_end; r0 += kDaBM) {
    if (conv) {
      for (int i = tid; i < kDaBM * kPatch; i += kThreads) {
        s.patch[i / kPatch][i % kPatch] =
            patch_at(img, r0 + i / kPatch, r_end, i % kPatch, X, Y, pi, pj);
      }
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    int buf = 0;
    fetch(r0, 0, 0);
    for (int nb = 0; nb < N; nb += kStep, buf ^= 1) {
      s.gs[buf][gh * 4 + 0][gr] = gpre.x;
      s.gs[buf][gh * 4 + 1][gr] = gpre.y;
      s.gs[buf][gh * 4 + 2][gr] = gpre.z;
      s.gs[buf][gh * 4 + 3][gr] = gpre.w;
      __pipeline_wait_prior(0);
      __syncthreads();
      if (nb + kStep < N) fetch(r0, nb + kStep, buf ^ 1);
#pragma unroll
      for (int n = 0; n < kStep; ++n) {
        const float4 g0 =
            *reinterpret_cast<const float4*>(&s.gs[buf][n][tr * 8]);
        const float4 g1 =
            *reinterpret_cast<const float4*>(&s.gs[buf][n][tr * 8 + 4]);
        const float4 w0 =
            *reinterpret_cast<const float4*>(&s.ws[buf][n][tk * 8]);
        const float4 w1 =
            *reinterpret_cast<const float4*>(&s.ws[buf][n][tk * 8 + 4]);
        fma8(acc[0], g0.x, w0, w1);
        fma8(acc[1], g0.y, w0, w1);
        fma8(acc[2], g0.z, w0, w1);
        fma8(acc[3], g0.w, w0, w1);
        fma8(acc[4], g1.x, w0, w1);
        fma8(acc[5], g1.y, w0, w1);
        fma8(acc[6], g1.z, w0, w1);
        fma8(acc[7], g1.w, w0, w1);
      }
      // the other buffers are written after the next iteration's barrier
    }
    __syncthreads();   // the last step's tiles are read
    if (conv) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tr * 8 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tk * 8 + j;
          s.dpre[r][c] =
              conv_pre(s.conv, s.patch[r], c) > 0.0f ? acc[i][j] : 0.0f;
        }
      }
      __syncthreads();
      for (int r = 0; r < kDaBM; ++r) {
        const float d = s.dpre[r][cc];
#pragma unroll
        for (int j = 0; j < 14; ++j) {
          const int q = cq * 14 + j;
          cacc[j] = q < kPatch ? fmaf(d, s.patch[r][q], cacc[j])
                               : cacc[j] + d;
        }
      }
      __syncthreads();   // patch and dpre are free for the next row tile
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + tr * 8 + i;
        if (row >= r_end) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tk * 8 + j;
          if (k < K) g_e[(size_t)row * E + (k - conv_dim)] = acc[i][j];
        }
      }
    }
  }
  if (conv) {
    float* dst = conv_ws +
                 ((size_t)blockIdx.x * gridDim.z + blockIdx.z) * kTK * kCq;
#pragma unroll
    for (int j = 0; j < 14; ++j) dst[cc * kCq + cq * 14 + j] = cacc[j];
  }
}

// d conv_w[c][q] and d conv_b[c]: the sum over the pixels' K-tiles and
// the splits, in that order.
__global__ void conv_grad_sum_kernel(const float* __restrict__ ws,
                                     float* __restrict__ dconv_w,
                                     float* __restrict__ dconv_b, int P,
                                     int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTK * kCq) return;
  const int c = i / kCq, q = i % kCq;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) {
    for (int sp = 0; sp < splits; ++sp) {
      s = __fadd_rn(s, ws[((size_t)p * splits + sp) * kTK * kCq + i]);
    }
  }
  if (q < kPatch) {
    dconv_w[c * kPatch + q] = s;
  } else {
    dconv_b[c] = s;
  }
}

template <typename Kern>
int occupancy_slots(Kern fn, int smem) {
  int per_sm = 0, dev = 0, sms = 1;
  cudaFuncSetAttribute((const void*)fn,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn,
                                                kThreads, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * (per_sm > 0 ? per_sm : 1);
}

int dw_slots(int bnn) {
  static int s64 = 0, s128 = 0;
  int& s = bnn == 64 ? s64 : s128;
  if (s == 0) {
    s = bnn == 64 ? occupancy_slots(teacher_proj_dw_kernel<64>,
                                    (int)sizeof(DwSmem<64>))
                  : occupancy_slots(teacher_proj_dw_kernel<128>,
                                    (int)sizeof(DwSmem<128>));
  }
  return s;
}

int da_slots() {
  static int s = 0;
  if (s == 0) s = occupancy_slots(teacher_proj_da_kernel, (int)sizeof(DaSmem));
  return s;
}

// Splits of `steps` row steps over `tiles` CTAs that minimise waves x
// steps per CTA (preferring fewer), at most max_splits.
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

struct BwdPlan {
  int bnn, dw_splits, dw_rows, da_splits, da_rows;
  long long dw_ws, conv_ws;   // floats of workspace
};

BwdPlan bwd_plan(int B, int N, int K, int conv_dim) {
  BwdPlan p;
  p.bnn = N <= 64 ? 64 : 128;
  const int k_tiles = (K + kTK - 1) / kTK;
  const long long dw_tiles = (long long)k_tiles * ((N + p.bnn - 1) / p.bnn);
  const int dw_steps = (B + kDwStep - 1) / kDwStep;
  const long long split_floats = (long long)N * K;
  const int dw_max = (int)std::min<long long>(
      kMaxSplits, std::max<long long>(1, kMaxWsFloats / split_floats));
  int sp = choose_splits(dw_tiles, dw_steps, dw_slots(p.bnn), dw_max);
  p.dw_rows = ((dw_steps + sp - 1) / sp) * kDwStep;
  p.dw_splits = (B + p.dw_rows - 1) / p.dw_rows;
  p.dw_ws = p.dw_splits > 1 ? p.dw_splits * split_floats : 0;
  const int da_steps = (B + kDaBM - 1) / kDaBM;
  sp = choose_splits(k_tiles, da_steps, da_slots(), kMaxSplits);
  p.da_rows = ((da_steps + sp - 1) / sp) * kDaBM;
  p.da_splits = (B + p.da_rows - 1) / p.da_rows;
  p.conv_ws = (long long)(conv_dim / kTK) * p.da_splits * kTK * kCq;
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
  return (int)(p.dw_ws + p.conv_ws);   // at most 2^28 + 2^24
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
  const int k_tiles = (K + kTK - 1) / kTK;
  float* dw_dst = p.dw_splits > 1 ? (float*)ws : (float*)dw;
  float* conv_part = (float*)ws + p.dw_ws;
  const dim3 dw_grid(k_tiles, (N + p.bnn - 1) / p.bnn, p.dw_splits);
  if (!(parts & 1)) {
    // dA alone
  } else if (p.bnn == 64) {
    teacher_proj_dw_kernel<64><<<dw_grid, kThreads, sizeof(DwSmem<64>), s>>>(
        (const uint8_t*)img, (const float*)conv_w, (const float*)conv_b,
        (const float*)e, (const float*)g, dw_dst, B, X, Y, E, N, p.dw_rows);
  } else {
    teacher_proj_dw_kernel<128>
        <<<dw_grid, kThreads, sizeof(DwSmem<128>), s>>>(
            (const uint8_t*)img, (const float*)conv_w, (const float*)conv_b,
            (const float*)e, (const float*)g, dw_dst, B, X, Y, E, N,
            p.dw_rows);
  }
  if ((parts & 1) && p.dw_splits > 1) {
    const int count = N * K;
    sum_splits_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const float*)ws, (float*)dw, count, p.dw_splits);
  }
  if (!(parts & 2)) return (int)cudaGetLastError();
  teacher_proj_da_kernel<<<dim3(k_tiles, 1, p.da_splits), kThreads,
                           sizeof(DaSmem), s>>>(
      (const uint8_t*)img, (const float*)conv_w, (const float*)conv_b,
      (const float*)g, (const float*)w, (float*)g_e, conv_part, B, X, Y, E,
      N, p.da_rows);
  conv_grad_sum_kernel<<<(kTK * kCq + kThreads - 1) / kThreads, kThreads, 0,
                         s>>>(conv_part, (float*)dconv_w, (float*)dconv_b,
                              (X - 2) * (Y - 2), p.da_splits);
  return (int)cudaGetLastError();
}
