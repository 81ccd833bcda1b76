// The MultiGrid student's policy step: embed, LSTM cell, heads and the
// action draw of a batch of students, in one launch.
//
// Replaces dcd_isaac_tpu/models/multigrid_models.py:98-103 __call__ with
// _embed (:75-89), common.py's LSTM cell and _heads (:91-96), and
// models/distributions.py:17-25 categorical_sample / categorical_log_prob.
// Per row b:
//   x   = [relu(conv3x3(img[b] / 10) + conv_b) flattened (h, w, c)
//          || emb_w[:, dir[b]] + emb_b]                          (F,)
//   c, h = m * c, m * h                                (m the row's mask)
//   z   = (h @ W_h^T + b_h) + x @ W_i^T                  gates i, f, g, o
//   c'  = sig(f) c + sig(i) tanh(g),  h' = sig(o) tanh(c')
//   logits = head(tanh(tanh(h' A0 + a0) A1 + a1)),  value likewise
// and by mode: 0 forward (logits, value, c', h'); 1 sample (also the
// action: the number of CDF entries but the last of softmax(logits) at or
// below the row's uniform u, and its log-prob); 2 given action (its
// log-prob); 3 value only (no carry, no logits written).
//
// One CTA of H threads (one a hidden unit) per tile of BM rows.  The
// view, the embed x, the masked h, the gate pre-activations z and the
// trunks' activations of the tile live in shared memory.  In the gate
// product each thread owns four adjacent columns of the 4H, reads them
// from W_i^T (F, 4H) and W_h^T (H, 4H) as one float4 a k (a warp reads
// 512 contiguous bytes from L2) and reuses each for the BM rows.  The
// weights (about 1.7 MB at H = 256) do not fit in shared memory; every
// CTA streams them from L2.  No tensor cores: TF32 is off in the port.
//
// Bound on the H100: at B = 32 the weights' bytes (about 1.74 MB, 0.5 us
// at 3.35 TB/s); at B = 8192 the operations (2 B (F + H) 4H, about 7
// GFLOP, 0.11 ms at 67 TFLOP/s).  A CTA a row tile reads all the weights,
// so a small batch waits on each SM's L2 reads; splitting the gate
// columns over CTAs is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 16;        // conv filters
constexpr int kQ = 27;        // 3 input channels x 3 x 3
constexpr int kDirs = 4;      // one-hot scalar
constexpr int kFc = 5;        // its embed
constexpr int kT = 32;        // trunk width
constexpr int kMaxA = 32;
constexpr int kMaxH = 256;
constexpr int kMinV = 3, kMaxV = 9;

enum Mode { kForward = 0, kSample = 1, kAction = 2, kValue = 3 };

struct Args {
  const uint8_t* img;
  const int* dir;
  const float* c_in;
  const float* h_in;
  const float* mask;
  const float* conv_w;   // (16, 3, 3, 3) OIHW
  const float* conv_b;
  const float* emb_w;    // (5, 4)
  const float* emb_b;
  const float* w_iT;     // (F, 4H)
  const float* w_hT;     // (H, 4H)
  const float* b_h;      // (4H,)
  const float* trunk[12];  // actor then critic: W0^T (H, 32), b0,
                           // W1^T (32, 32), b1, head^T (32, A or 1), bh
  const float* u;
  const int64_t* action_in;
  float* logits;
  float* value;
  float* c_out;
  float* h_out;
  int64_t* action_out;
  float* logp;
  int B, V, H, A, mode;
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared floats of a CTA with row tile BM.
__host__ __device__ inline int smem_floats(int BM, int V, int H, int A) {
  const int O = V - 2;
  const int F = O * O * kC + kFc;
  return BM * V * V * 3            // the view / 10
         + BM * F                  // x
         + BM * H                  // masked h, then h'
         + BM * 4 * H              // z
         + kQ * kC + kC            // conv weights [q][c] and bias
         + BM * 4 * kT             // trunk activations, two layers x two
         + BM * (A + 1);           // logits and value
}

template <int BM>
__global__ void __launch_bounds__(kMaxH) policy_step_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int V = a.V, H = a.H, A = a.A, mode = a.mode;
  const int O = V - 2, P = O * O, F = P * kC + kFc, G = 4 * H;
  const int VV3 = V * V * 3;
  float* s_view = smem;
  float* s_x = s_view + BM * VV3;
  float* s_h = s_x + BM * F;
  float* s_z = s_h + BM * H;
  float* s_w = s_z + BM * G;            // [q][c], then the bias
  float* s_t = s_w + kQ * kC + kC;      // [r][4 * kT]: a1, v1 | a2, v2
  float* s_o = s_t + BM * 4 * kT;       // [r][A + 1]: logits, value

  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, a.B - row0);

  // 1. The view / 10, the conv weights, the masked carry's h.
  for (int i = tid; i < BM * VV3; i += nt) {
    s_view[i] = i < rows * VV3
                    ? (float)a.img[(size_t)row0 * VV3 + i] / 10.0f : 0.0f;
  }
  for (int i = tid; i < kQ * kC; i += nt) {
    s_w[(i % kQ) * kC + i / kQ] = a.conv_w[i];
  }
  for (int i = tid; i < kC; i += nt) s_w[kQ * kC + i] = a.conv_b[i];
  for (int i = tid; i < BM * H; i += nt) {
    const int r = i / H;
    s_h[i] = r < rows ? a.h_in[(size_t)row0 * H + i] * a.mask[row0 + r]
                      : 0.0f;
  }
  __syncthreads();

  // 2. The embed: conv features (pixel-major, channel-minor) and the
  // direction's embed.
  for (int i = tid; i < BM * P * kC; i += nt) {
    const int r = i / (P * kC), f = i % (P * kC);
    const int p = f / kC, ch = f % kC;
    const int pi = p / O, pj = p % O;
    const float* v = s_view + r * VV3;
    float acc = s_w[kQ * kC + ch];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int ci = q / 9, di = (q / 3) % 3, dj = q % 3;
      acc = fmaf(s_w[q * kC + ch], v[((pi + di) * V + pj + dj) * 3 + ci],
                 acc);
    }
    s_x[r * F + f] = fmaxf(acc, 0.0f);
  }
  for (int i = tid; i < BM * kFc; i += nt) {
    const int r = i / kFc, o = i % kFc;
    const int d = r < rows ? a.dir[row0 + r] : 0;
    s_x[r * F + P * kC + o] = a.emb_w[o * kDirs + d] + a.emb_b[o];
  }
  __syncthreads();

  // 3. The gate product: columns j0..j0+3 for the tile's rows, x @ W_i^T
  // first, then (h @ W_h^T + b_h) added to it.  A small tile unrolls
  // further, to keep more of its L2 reads in flight.
  constexpr int kUnroll = BM <= 4 ? 16 : 4;
  const int j0 = tid * 4;
  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
#pragma unroll kUnroll
  for (int k = 0; k < F; ++k) {
    const float4 w =
        __ldg(reinterpret_cast<const float4*>(a.w_iT + (size_t)k * G + j0));
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float x = s_x[r * F + k];
      acc[r][0] = fmaf(x, w.x, acc[r][0]);
      acc[r][1] = fmaf(x, w.y, acc[r][1]);
      acc[r][2] = fmaf(x, w.z, acc[r][2]);
      acc[r][3] = fmaf(x, w.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_z[r * G + j0 + q] = acc[r][q];
      acc[r][q] = 0.0f;
    }
#pragma unroll kUnroll
  for (int k = 0; k < H; ++k) {
    const float4 w =
        __ldg(reinterpret_cast<const float4*>(a.w_hT + (size_t)k * G + j0));
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float x = s_h[r * H + k];
      acc[r][0] = fmaf(x, w.x, acc[r][0]);
      acc[r][1] = fmaf(x, w.y, acc[r][1]);
      acc[r][2] = fmaf(x, w.z, acc[r][2]);
      acc[r][3] = fmaf(x, w.w, acc[r][3]);
    }
  }
  {
    const float4 b = *reinterpret_cast<const float4*>(a.b_h + j0);
    const float bq[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_z[r * G + j0 + q] = (acc[r][q] + bq[q]) + s_z[r * G + j0 + q];
      }
  }
  __syncthreads();

  // 4. The cell: one thread a unit, for each row; h' replaces h.
  for (int r = 0; r < BM; ++r) {
    const int u = tid;
    const float* z = s_z + r * G;
    const bool live = r < rows;
    const float m = live ? a.mask[row0 + r] : 0.0f;
    const float c = live ? a.c_in[(size_t)(row0 + r) * H + u] * m : 0.0f;
    const float c2 = sigm(z[H + u]) * c + sigm(z[u]) * tanhf(z[2 * H + u]);
    const float h2 = sigm(z[3 * H + u]) * tanhf(c2);
    s_h[r * H + u] = h2;
    if (live && mode != kValue) {
      a.c_out[(size_t)(row0 + r) * H + u] = c2;
      a.h_out[(size_t)(row0 + r) * H + u] = h2;
    }
  }
  __syncthreads();

  // 5. The trunks: layer 0 from h' (H inputs), layer 1 (32 inputs); the
  // actor's columns first, then the critic's.
  for (int layer = 0; layer < 2; ++layer) {
    const int in_dim = layer == 0 ? H : kT;
    for (int i = tid; i < BM * 2 * kT; i += nt) {
      const int r = i / (2 * kT), o = i % (2 * kT);
      const int side = o / kT, oo = o % kT;
      const float* W = a.trunk[6 * side + 2 * layer];
      const float* in = layer == 0 ? s_h + r * H
                                   : s_t + r * 4 * kT + side * kT;
      float v = 0.0f;
      for (int k = 0; k < in_dim; ++k) v = fmaf(in[k], W[k * kT + oo], v);
      v += a.trunk[6 * side + 2 * layer + 1][oo];
      s_t[r * 4 * kT + (layer == 0 ? 0 : 2 * kT) + side * kT + oo] =
          tanhf(v);
    }
    __syncthreads();
  }
  // the heads: A logits from the actor, one value from the critic
  for (int i = tid; i < BM * (A + 1); i += nt) {
    const int r = i / (A + 1), o = i % (A + 1);
    const int side = o < A ? 0 : 1;
    const int width = side == 0 ? A : 1;
    const int oo = side == 0 ? o : 0;
    const float* W = a.trunk[6 * side + 4];
    const float* in = s_t + r * 4 * kT + 2 * kT + side * kT;
    float v = 0.0f;
    for (int k = 0; k < kT; ++k) v = fmaf(in[k], W[k * width + oo], v);
    s_o[i] = v + a.trunk[6 * side + 5][oo];
  }
  __syncthreads();

  // 6. Per row: outputs, the draw and the log-prob.
  if (tid < rows) {
    const int r = tid;
    const size_t b = (size_t)row0 + r;
    const float* l = s_o + r * (A + 1);
    a.value[b] = l[A];
    if (mode != kValue) {
      float mx = l[0];
      for (int k = 0; k < A; ++k) {
        a.logits[b * A + k] = l[k];
        mx = fmaxf(mx, l[k]);
      }
      if (mode == kSample || mode == kAction) {
        float sum = 0.0f;
        for (int k = 0; k < A; ++k) sum += expf(l[k] - mx);
        int act;
        if (mode == kSample) {
          const float u = a.u[b];
          float cdf = 0.0f;
          act = 0;
          for (int k = 0; k < A - 1; ++k) {
            cdf += expf(l[k] - mx) / sum;
            act += cdf <= u ? 1 : 0;
          }
          a.action_out[b] = act;
        } else {
          act = (int)a.action_in[b];
        }
        a.logp[b] = (l[act] - mx) - logf(sum);
      }
    }
  }
}

template <int BM>
int launch(const Args& a, cudaStream_t s) {
  // Once: the shared memory of the largest shape the entry point takes
  // (not during a CUDA graph's capture of a later launch).
  static const cudaError_t set = cudaFuncSetAttribute(
      policy_step_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(BM, kMaxV, kMaxH, kMaxA) * (int)sizeof(float));
  if (set != cudaSuccess) return (int)set;
  const int bytes = smem_floats(BM, a.V, a.H, a.A) * (int)sizeof(float);
  policy_step_kernel<BM><<<(a.B + BM - 1) / BM, a.H, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers: the view (B, V, V, 3) uint8, dir (B,) int32, c, h (B, H),
// mask (B,); conv_w, conv_b, emb_w, emb_b, W_i^T, W_h^T, b_h and the
// twelve trunk tensors (actor, critic: W0^T, b0, W1^T, b1, head^T, bh);
// u (B,) for mode 1, the actions (B,) int64 for mode 2 (else null); the
// outputs logits (B, A), value (B,), c', h' (B, H), the actions (B,)
// int64 and log-probs (B,), null where the mode writes none.
extern "C" int dcd_policy_step(
    const void* img, const void* dir, const void* c_in, const void* h_in,
    const void* mask, const void* conv_w, const void* conv_b,
    const void* emb_w, const void* emb_b, const void* w_iT,
    const void* w_hT, const void* b_h, const void* a0T, const void* a0b,
    const void* a1T, const void* a1b, const void* ahT, const void* ahb,
    const void* v0T, const void* v0b, const void* v1T, const void* v1b,
    const void* vhT, const void* vhb, const void* u, const void* action_in,
    void* logits, void* value, void* c_out, void* h_out, void* action_out,
    void* logp, int B, int V, int H, int A, int mode, void* stream) {
  if (V < kMinV || V > kMaxV || H <= 0 || H % 32 != 0 || H > kMaxH ||
      A <= 0 || A > kMaxA || mode < kForward || mode > kValue ||
      (uintptr_t)w_iT % 16 != 0 || (uintptr_t)w_hT % 16 != 0 ||
      (uintptr_t)b_h % 16 != 0 || (mode == kSample && !u) ||
      (mode == kAction && !action_in) ||
      (mode != kValue && !(logits && c_out && h_out)) ||
      ((mode == kSample || mode == kAction) && !logp) ||
      (mode == kSample && !action_out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0) return (int)cudaGetLastError();
  Args a;
  a.img = (const uint8_t*)img;
  a.dir = (const int*)dir;
  a.c_in = (const float*)c_in;
  a.h_in = (const float*)h_in;
  a.mask = (const float*)mask;
  a.conv_w = (const float*)conv_w;
  a.conv_b = (const float*)conv_b;
  a.emb_w = (const float*)emb_w;
  a.emb_b = (const float*)emb_b;
  a.w_iT = (const float*)w_iT;
  a.w_hT = (const float*)w_hT;
  a.b_h = (const float*)b_h;
  const void* trunk[12] = {a0T, a0b, a1T, a1b, ahT, ahb,
                           v0T, v0b, v1T, v1b, vhT, vhb};
  for (int i = 0; i < 12; ++i) a.trunk[i] = (const float*)trunk[i];
  a.u = (const float*)u;
  a.action_in = (const int64_t*)action_in;
  a.logits = (float*)logits;
  a.value = (float*)value;
  a.c_out = (float*)c_out;
  a.h_out = (float*)h_out;
  a.action_out = (int64_t*)action_out;
  a.logp = (float*)logp;
  a.B = B;
  a.V = V;
  a.H = H;
  a.A = A;
  a.mode = mode;
  cudaStream_t s = (cudaStream_t)stream;
  // Four rows a CTA fill more SMs at a rollout's batch; sixteen reuse each
  // weight more at an update-sized one.
  return B <= 2048 ? launch<4>(a, s) : launch<16>(a, s);
}
