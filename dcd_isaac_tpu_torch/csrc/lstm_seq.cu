// The LSTM recurrence of BPTT: forward, and a backward that recomputes the
// gates.
//
// Replaces dcd_isaac_tpu/models/common.py:RNNCore.sequence_zx (:125-154),
// the scan the PPO update runs through the students' and the teacher's
// LSTM-256 (and the students' remat scan, models/multigrid_models.py
// :154-165), with its VJP.  Per step t, with m_t the (N,) mask, W_h the
// (4H, H) recurrent weight in PyTorch's Linear layout and b its bias:
//   cp = m_t * c_{t-1},  hp = m_t * h_{t-1}
//   z  = (hp @ W_h^T + b) + zx_t                  gates i, f, g, o
//   c_t = sigmoid(f) * cp + sigmoid(i) * tanh(g),  h_t = sigmoid(o) * tanh(c_t)
//
// Forward step kernel: a tiled fp32 SIMT GEMM of the (N, H) masked h
// against W_h^T (H, 4H).  Each CTA owns BM rows and BU hidden units, that
// is the four gate columns of the same units, so the cell update runs in
// the GEMM's epilogue and no z reaches memory; it writes c_t and h_t.
//
// Backward step kernel for step t: two products for its rows and units,
//   dh_t = dh_out_t + m_{t+1} * (dz_{t+1} @ W_h)          (K = 4H)
//   z_t recomputed from hp and W_h^T as in the forward   (K = H)
// then the cell's VJP, which writes dz_t into dzx and carries
// dc_{t-1} = m_t * f * (dc_t + dh_t * o * (1 - tanh(c_t)^2)) in place.  A
// last launch with the product alone gives d(h0) = m_0 * (dz_0 @ W_h);
// after step 0 the dc carry is d(c0).  dW_h and db are one large matmul
// over the stored tensors, outside this file.
//
// One launch per step in each direction (T forward, T + 1 backward), all
// made by the C entry points so a pass costs Python one call.  A persistent
// kernel with a grid-wide barrier between steps is later work, as are
// tensor cores (TF32 is off in the port), TMA and a W_h kept in shared
// memory.
//
// Bound on the H100, by operations: the forward does 2 * N * H * 4H FMAs
// a step (at N = 8192, T = 256, H = 256: 1.10e12 operations, 16.4 ms at
// 67 TFLOP/s), the backward twice that; at N = 32 the 256 dependent steps
// and their launches hold it far above the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;          // rows of a CTA tile
constexpr int kBU = 32;          // hidden units of a CTA: 4 * kBU z columns
constexpr int kBK = 16;          // k of a shared tile
constexpr int kThreads = 256;    // 16 row groups x 16 unit groups
constexpr int kTM = 4;           // rows per thread
constexpr int kTU = 2;           // units per thread

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[r][g][u] = sum_k (m * h_prev)[row r, k] * W_hT[k, g * H + unit u]
// over the CTA's rows row0.. and units u0.. (thread: rows ty*4+r, units
// tx*2+u).  W_hT is W_h transposed, (H, 4H) row-major.
__device__ __forceinline__ void recurrent_product(
    const float* __restrict__ h_prev, const float* __restrict__ mask,
    const float* __restrict__ w_hT, int N, int H, int row0, int u0,
    float (&acc)[kTM][4][kTU], float (*as)[kBM], float (*bs)[4 * kBU]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int u = 0; u < kTU; ++u) acc[r][g][u] = 0.0f;
  // A loads: one float4 of one row a thread (64 rows x 16 k).
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const int grow = row0 + a_row;
  const float m = grow < N ? mask[grow] : 0.0f;
  for (int k0 = 0; k0 < H; k0 += kBK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < N) {
      a = *reinterpret_cast<const float4*>(h_prev + (size_t)grow * H + k0 +
                                           a_k);
    }
    as[a_k + 0][a_row] = a.x * m;
    as[a_k + 1][a_row] = a.y * m;
    as[a_k + 2][a_row] = a.z * m;
    as[a_k + 3][a_row] = a.w * m;
    // B loads: 16 k x 4 gates x 32 units = 512 float4, two a thread.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = tid + i * kThreads;
      const int k = f / 32, g = (f / 8) % 4, q = f % 8;
      *reinterpret_cast<float4*>(&bs[k][g * kBU + q * 4]) =
          *reinterpret_cast<const float4*>(
              w_hT + (size_t)(k0 + k) * 4 * H + g * H + u0 + q * 4);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float a4[kTM] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&bs[kk][g * kBU + tx * kTU]);
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          acc[r][g][0] += a4[r] * bv.x;
          acc[r][g][1] += a4[r] * bv.y;
        }
      }
    }
    __syncthreads();
  }
}

// acc[r][u] = sum_j dz[row r, j] * W_h[j, unit u] over j < 4H.
__device__ __forceinline__ void hidden_grad_product(
    const float* __restrict__ dz, const float* __restrict__ w_h, int N, int H,
    int row0, int u0, float (&acc)[kTM][kTU], float (*as)[kBM],
    float (*bs)[4 * kBU]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int u = 0; u < kTU; ++u) acc[r][u] = 0.0f;
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const int grow = row0 + a_row;
  const int K = 4 * H;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < N) {
      a = *reinterpret_cast<const float4*>(dz + (size_t)grow * K + k0 + a_k);
    }
    as[a_k + 0][a_row] = a.x;
    as[a_k + 1][a_row] = a.y;
    as[a_k + 2][a_row] = a.z;
    as[a_k + 3][a_row] = a.w;
    // 16 j x 32 units = 128 float4, one for each of the first 128 threads.
    if (tid < 128) {
      const int k = tid / 8, q = tid % 8;
      *reinterpret_cast<float4*>(&bs[k][q * 4]) =
          *reinterpret_cast<const float4*>(w_h + (size_t)(k0 + k) * H + u0 +
                                           q * 4);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float a4[kTM] = {av.x, av.y, av.z, av.w};
      const float2 bv = *reinterpret_cast<const float2*>(&bs[kk][tx * kTU]);
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        acc[r][0] += a4[r] * bv.x;
        acc[r][1] += a4[r] * bv.y;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) lstm_fwd_step_kernel(
    const float* __restrict__ zx, const float* __restrict__ mask,
    const float* __restrict__ w_hT, const float* __restrict__ b,
    const float* __restrict__ c_prev, const float* __restrict__ h_prev,
    float* __restrict__ c_out, float* __restrict__ h_out, int N, int H) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][4 * kBU];
  const int row0 = blockIdx.x * kBM, u0 = blockIdx.y * kBU;
  float acc[kTM][4][kTU];
  recurrent_product(h_prev, mask, w_hT, N, H, row0, u0, acc, as, bs);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int row = row0 + ty * kTM + r;
    if (row >= N) continue;
    const float m = mask[row];
#pragma unroll
    for (int u = 0; u < kTU; ++u) {
      const int unit = u0 + tx * kTU + u;
      const float* zr = zx + (size_t)row * 4 * H + unit;
      const float zi = (acc[r][0][u] + b[unit]) + zr[0];
      const float zf = (acc[r][1][u] + b[H + unit]) + zr[H];
      const float zg = (acc[r][2][u] + b[2 * H + unit]) + zr[2 * H];
      const float zo = (acc[r][3][u] + b[3 * H + unit]) + zr[3 * H];
      const float cp = c_prev[(size_t)row * H + unit] * m;
      const float c = sigm(zf) * cp + sigm(zi) * tanhf(zg);
      c_out[(size_t)row * H + unit] = c;
      h_out[(size_t)row * H + unit] = sigm(zo) * tanhf(c);
    }
  }
}

// kVjp: step t of the backward (dz_next = dz_{t+1} or null at t = T - 1).
// !kVjp: the product alone, dh_prev_out = m_next * (dz_next @ W_h).
template <bool kVjp>
__global__ void __launch_bounds__(kThreads) lstm_bwd_step_kernel(
    const float* __restrict__ zx, const float* __restrict__ mask,
    const float* __restrict__ w_h, const float* __restrict__ w_hT,
    const float* __restrict__ b, const float* __restrict__ c_prev,
    const float* __restrict__ h_prev, const float* __restrict__ dh_out,
    const float* __restrict__ dz_next, const float* __restrict__ mask_next,
    float* __restrict__ dc, float* __restrict__ dz,
    float* __restrict__ dh_prev_out, int N, int H) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][4 * kBU];
  const int row0 = blockIdx.x * kBM, u0 = blockIdx.y * kBU;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dhr[kTM][kTU];
  if (dz_next != nullptr) {
    hidden_grad_product(dz_next, w_h, N, H, row0, u0, dhr, as, bs);
  } else {
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int u = 0; u < kTU; ++u) dhr[r][u] = 0.0f;
  }
  if constexpr (!kVjp) {
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const int row = row0 + ty * kTM + r;
      if (row >= N) continue;
#pragma unroll
      for (int u = 0; u < kTU; ++u) {
        dh_prev_out[(size_t)row * H + u0 + tx * kTU + u] =
            mask_next[row] * dhr[r][u];
      }
    }
    return;
  }
  float acc[kTM][4][kTU];
  recurrent_product(h_prev, mask, w_hT, N, H, row0, u0, acc, as, bs);
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int row = row0 + ty * kTM + r;
    if (row >= N) continue;
    const float m = mask[row];
    const float mn = dz_next != nullptr ? mask_next[row] : 0.0f;
#pragma unroll
    for (int u = 0; u < kTU; ++u) {
      const int unit = u0 + tx * kTU + u;
      const size_t hu = (size_t)row * H + unit;
      const float* zr = zx + (size_t)row * 4 * H + unit;
      const float i = sigm((acc[r][0][u] + b[unit]) + zr[0]);
      const float f = sigm((acc[r][1][u] + b[H + unit]) + zr[H]);
      const float g = tanhf((acc[r][2][u] + b[2 * H + unit]) + zr[2 * H]);
      const float o = sigm((acc[r][3][u] + b[3 * H + unit]) + zr[3 * H]);
      const float cp = c_prev[hu] * m;
      const float tc = tanhf(f * cp + i * g);
      const float dh = dh_out[hu] + mn * dhr[r][u];
      const float dct = dc[hu] + dh * o * (1.0f - tc * tc);
      float* dzr = dz + (size_t)row * 4 * H + unit;
      dzr[0] = dct * g * i * (1.0f - i);
      dzr[H] = dct * cp * f * (1.0f - f);
      dzr[2 * H] = dct * i * (1.0f - g * g);
      dzr[3 * H] = dh * tc * o * (1.0f - o);
      dc[hu] = m * (dct * f);
    }
  }
}

bool supported(int N, int H, const void* const* ptrs, int n_ptrs) {
  if (N < 0 || H <= 0 || H % kBU != 0) return false;
  for (int i = 0; i < n_ptrs; ++i) {
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  }
  return true;
}

}  // namespace

// zx (T, N, 4H), masks (T, N), w_hT (H, 4H) = W_h^T, b (4H,), c0/h0 (N, H)
// -> c_all, h_all (T, N, H): T launches of the step kernel.
extern "C" int dcd_lstm_seq_forward(const void* zx, const void* masks,
                                    const void* w_hT, const void* b,
                                    const void* c0, const void* h0,
                                    void* c_all, void* h_all, int T, int N,
                                    int H, void* stream) {
  const void* ptrs[] = {zx, w_hT, c0, h0, c_all, h_all};
  if (!supported(N, H, ptrs, 6)) return (int)cudaErrorInvalidValue;
  if (T <= 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + kBM - 1) / kBM, H / kBU);
  const size_t nh = (size_t)N * H;
  for (int t = 0; t < T; ++t) {
    const float* cp = t ? (const float*)c_all + (t - 1) * nh : (const float*)c0;
    const float* hp = t ? (const float*)h_all + (t - 1) * nh : (const float*)h0;
    lstm_fwd_step_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)zx + t * 4 * nh, (const float*)masks + (size_t)t * N,
        (const float*)w_hT, (const float*)b, cp, hp,
        (float*)c_all + t * nh, (float*)h_all + t * nh, N, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The forward's inputs and c_all, h_all; w_h (4H, H) and its transpose;
// dh_all (T, N, H) the gradient of h_all; dc (N, H) the gradient of c_T on
// entry and d(c0) on return; dzx (T, N, 4H) and dh0 (N, H) written.
// T + 1 launches.
extern "C" int dcd_lstm_seq_backward(
    const void* zx, const void* masks, const void* w_h, const void* w_hT,
    const void* b, const void* c0, const void* h0, const void* c_all,
    const void* h_all, const void* dh_all, void* dc, void* dzx, void* dh0,
    int T, int N, int H, void* stream) {
  const void* ptrs[] = {zx, w_h, w_hT, c0, h0, c_all, h_all, dh_all, dc, dzx,
                        dh0};
  if (!supported(N, H, ptrs, 11)) return (int)cudaErrorInvalidValue;
  if (T <= 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + kBM - 1) / kBM, H / kBU);
  const size_t nh = (size_t)N * H;
  const float* m = (const float*)masks;
  float* dz = (float*)dzx;
  for (int t = T - 1; t >= 0; --t) {
    const float* cp = t ? (const float*)c_all + (t - 1) * nh : (const float*)c0;
    const float* hp = t ? (const float*)h_all + (t - 1) * nh : (const float*)h0;
    const bool last = t == T - 1;
    lstm_bwd_step_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)zx + t * 4 * nh, m + (size_t)t * N, (const float*)w_h,
        (const float*)w_hT, (const float*)b, cp, hp,
        (const float*)dh_all + t * nh, last ? nullptr : dz + (t + 1) * 4 * nh,
        last ? nullptr : m + (size_t)(t + 1) * N, (float*)dc, dz + t * 4 * nh,
        nullptr, N, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  lstm_bwd_step_kernel<false><<<grid, kThreads, 0, s>>>(
      nullptr, nullptr, (const float*)w_h, nullptr, nullptr, nullptr, nullptr,
      nullptr, dz, m, nullptr, nullptr, (float*)dh0, N, H);
  return (int)cudaGetLastError();
}
