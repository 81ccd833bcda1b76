// The PPO loss over a minibatch's rows, its gradient, and the advantage
// normalisation.
//
// Replaces dcd_isaac_tpu/algos/ppo.py:loss_fn (:82-114) after the model's
// forward, and the advantage normalisation of update (:142-144).  Per row
// r of R = T * N, with A action logits:
//   logp = log_softmax(logits[r]),  entropy_r = -sum exp(logp) * logp
//   ratio = exp(logp[action] - old_log_prob)
//   a_r = min(ratio * adv, clamp(ratio, 1 - clip, 1 + clip) * adv)
//   v_r = max((v - ret)^2, (old_v + clamp(v - old_v, -clip, clip) - ret)^2)
//         (clip_value_loss), or smooth_l1(v - ret)
//   aloss = -mean(a_r), vloss = 0.5 * mean(v_r) (clipped) or mean(v_r),
//   entropy = mean(entropy_r),
//   loss = vloss * value_loss_coef + aloss - entropy * entropy_coef.
//
// lo and hi are the ratio's clip bounds 1 -/+ clip, rounded once by the
// caller as PyTorch rounds its scalar bounds.
//
// Forward: one thread a row; each CTA sums its rows' three terms in double
// in a fixed tree and writes one partial per term; a second kernel of one
// CTA sums the partials in a fixed order and writes the four means.  No
// atomics, and the CTA count depends on R alone, so two runs give the same
// bits.  Backward: one pass, one thread a row, recomputing the row's terms
// and writing dlogits (R, A) and dvalues (R,) from the four upstream
// gradients, with autograd's tie and boundary rules for min, max and
// clamp (a tie sends half to each side; clamp passes its bounds).
// Normalisation: per-CTA double sums of x = ret - v and x^2, then a kernel
// in which every CTA folds the same partials in the same order and writes
// (x - mean) / (std + 1e-5) with the population std.
//
// The diagonal-Gaussian branch (the walker student's 4 torques: a mean per
// row and one shared log-std) has its own rows and backward kernels below,
// with a fixed-order fold for the log-std's gradient, a sum over the rows.
// The Beta branch (CarRacing's 3 actions, alpha and beta per row and
// action) computes each row's log-density, entropy and their gradients in
// double, with lgamma and hand-written digamma and trigamma (CUDA's math
// library has neither): the recurrence up to x >= 6, then the asymptotic
// series.
//
// Bound on the H100, by bytes: at R = 2 097 152 and A = 7 the forward reads
// about 117 MB (35 us at 3.35 TB/s), the backward reads that and writes
// dlogits and dvalues (about 185 MB, 55 us).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 512;   // partial sums of a reduction

int reduce_blocks(int R) {
  const int b = (R + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

// Sums v over the CTA in a fixed tree; the result is valid in thread 0.
template <int kTerms>
__device__ void block_sum(double (&v)[kTerms], double (*buf)[kThreads]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) buf[k][tid] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < kTerms; ++k) buf[k][tid] += buf[k][tid + s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kTerms; ++k) v[k] = buf[k][0];
}

// Sums the n partials [j * kTerms + k] in a fixed order: thread i takes
// j = i, i + kThreads, ..., then the tree.
template <int kTerms>
__device__ void fold_partials(const double* __restrict__ partials, int n,
                              double (&v)[kTerms], double (*buf)[kThreads]) {
#pragma unroll
  for (int k = 0; k < kTerms; ++k) v[k] = 0.0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) v[k] += partials[j * kTerms + k];
  }
  block_sum<kTerms>(v, buf);
}

struct Row {
  float mx, lse;                   // logp_j = (logits_j - mx) - lse
  float entropy, ratio, surr1, surr2;
};

// The row's log-softmax (as PyTorch: x - max - log(sum(exp(x - max)))),
// entropy, ratio and surrogates.  A is any width (7 for the students, 169
// for the teacher's 13 x 13 placements): the logits are read again rather
// than held.
__device__ __forceinline__ void row_terms(const float* __restrict__ logits,
                                          int64_t action, float old_lp,
                                          float adv, int A, float lo, float hi,
                                          Row& row) {
  float mx = logits[0];
  for (int j = 1; j < A; ++j) mx = fmaxf(mx, logits[j]);
  float s = 0.0f;
  for (int j = 0; j < A; ++j) s += expf(logits[j] - mx);
  const float lse = logf(s);
  float ent = 0.0f;
  for (int j = 0; j < A; ++j) {
    const float lp = (logits[j] - mx) - lse;
    ent -= expf(lp) * lp;
  }
  row.mx = mx;
  row.lse = lse;
  row.entropy = ent;
  row.ratio = expf(((logits[action] - mx) - lse) - old_lp);
  row.surr1 = row.ratio * adv;
  row.surr2 = fminf(fmaxf(row.ratio, lo), hi) * adv;
}

__global__ void __launch_bounds__(kThreads) ppo_loss_rows_kernel(
    const float* __restrict__ logits, const float* __restrict__ values,
    const int64_t* __restrict__ actions, const float* __restrict__ old_lp,
    const float* __restrict__ old_v, const float* __restrict__ returns,
    const float* __restrict__ advs, double* __restrict__ partials, int R,
    int A, float clip, float lo, float hi, int clip_value_loss) {
  __shared__ double buf[3][kThreads];
  double sum[3] = {0.0, 0.0, 0.0};   // min(surr1, surr2), value term, entropy
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < R;
       r += gridDim.x * kThreads) {
    Row row;
    row_terms(logits + (size_t)r * A, actions[r], old_lp[r], advs[r], A, lo,
              hi, row);
    const float v = values[r], ret = returns[r];
    float vterm;
    if (clip_value_loss) {
      const float clipped = old_v[r] + fminf(fmaxf(v - old_v[r], -clip), clip);
      const float d1 = v - ret, d2 = clipped - ret;
      vterm = fmaxf(d1 * d1, d2 * d2);
    } else {
      const float d = fabsf(v - ret);
      vterm = d < 1.0f ? 0.5f * d * d : d - 0.5f;
    }
    sum[0] += (double)fminf(row.surr1, row.surr2);
    sum[1] += (double)vterm;
    sum[2] += (double)row.entropy;
  }
  block_sum<3>(sum, buf);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) partials[blockIdx.x * 3 + k] = sum[k];
  }
}

// out = (loss, vloss, aloss, entropy).
__global__ void __launch_bounds__(kThreads) ppo_loss_final_kernel(
    const double* __restrict__ partials, int n, float* __restrict__ out,
    int R, int clip_value_loss, float value_loss_coef, float entropy_coef) {
  __shared__ double buf[3][kThreads];
  double sum[3];
  fold_partials<3>(partials, n, sum, buf);
  if (threadIdx.x == 0) {
    const float aloss = -(float)(sum[0] / R);
    const float vmean = (float)(sum[1] / R);
    const float vloss = clip_value_loss ? 0.5f * vmean : vmean;
    const float entropy = (float)(sum[2] / R);
    // rounded as PyTorch rounds the scalar expression, without FMAs
    out[0] = __fsub_rn(__fadd_rn(__fmul_rn(vloss, value_loss_coef), aloss),
                       __fmul_rn(entropy, entropy_coef));
    out[1] = vloss;
    out[2] = aloss;
    out[3] = entropy;
  }
}

// grad_out = upstream gradients of (loss, vloss, aloss, entropy).
__global__ void __launch_bounds__(kThreads) ppo_loss_backward_kernel(
    const float* __restrict__ logits, const float* __restrict__ values,
    const int64_t* __restrict__ actions, const float* __restrict__ old_lp,
    const float* __restrict__ old_v, const float* __restrict__ returns,
    const float* __restrict__ advs, const float* __restrict__ grad_out,
    float* __restrict__ dlogits, float* __restrict__ dvalues, int R, int A,
    float clip, float lo, float hi, int clip_value_loss,
    float value_loss_coef, float entropy_coef) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float inv_r = 1.0f / (float)R;
  const float g_loss = grad_out[0];
  const float c_v = g_loss * value_loss_coef + grad_out[1];
  const float c_a = g_loss + grad_out[2];
  const float c_e = grad_out[3] - g_loss * entropy_coef;
  const float adv = advs[r];
  const int64_t action = actions[r];
  Row row;
  row_terms(logits + (size_t)r * A, action, old_lp[r], adv, A, lo, hi, row);

  // aloss = -mean(min(surr1, surr2)): a tie sends half to each side.
  const float w1 = row.surr1 < row.surr2 ? 1.0f
                   : row.surr1 > row.surr2 ? 0.0f : 0.5f;
  const bool in_clip = row.ratio >= lo && row.ratio <= hi;
  const float g_min = -c_a * inv_r;
  const float g_ratio =
      g_min * (w1 * adv + (1.0f - w1) * (in_clip ? adv : 0.0f));
  const float g_lp = g_ratio * row.ratio;
  const float g_ent = c_e * inv_r;
  const float* lg = logits + (size_t)r * A;
  float* dl = dlogits + (size_t)r * A;
  for (int j = 0; j < A; ++j) {
    const float lp = (lg[j] - row.mx) - row.lse;
    const float p = expf(lp);
    const float onehot = j == action ? 1.0f : 0.0f;
    dl[j] = g_lp * (onehot - p) - g_ent * (p * (lp + row.entropy));
  }

  const float v = values[r], ret = returns[r];
  float dv;
  if (clip_value_loss) {
    const float d = v - old_v[r];
    const float clipped = old_v[r] + fminf(fmaxf(d, -clip), clip);
    const float d1 = v - ret, d2 = clipped - ret;
    const float q1 = d1 * d1, q2 = d2 * d2;
    const float w = q1 > q2 ? 1.0f : q1 < q2 ? 0.0f : 0.5f;
    const float pass = (d >= -clip && d <= clip) ? 1.0f : 0.0f;
    const float g = c_v * 0.5f * inv_r;
    dv = g * (w * 2.0f * d1 + (1.0f - w) * 2.0f * d2 * pass);
  } else {
    const float d1 = v - ret;
    const float d = fabsf(d1);
    const float sign = d1 > 0.0f ? 1.0f : d1 < 0.0f ? -1.0f : 0.0f;
    dv = c_v * inv_r * (d < 1.0f ? d : 1.0f) * sign;
  }
  dvalues[r] = dv;
}

// partials[b * 2 + {0, 1}] = sums of x and x^2 over CTA b's rows.
__global__ void __launch_bounds__(kThreads) adv_moments_kernel(
    const float* __restrict__ returns, const float* __restrict__ values,
    double* __restrict__ partials, int R) {
  __shared__ double buf[2][kThreads];
  double sum[2] = {0.0, 0.0};
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < R;
       r += gridDim.x * kThreads) {
    const double x = (double)(returns[r] - values[r]);
    sum[0] += x;
    sum[1] += x * x;
  }
  block_sum<2>(sum, buf);
  if (threadIdx.x == 0) {
    partials[blockIdx.x * 2] = sum[0];
    partials[blockIdx.x * 2 + 1] = sum[1];
  }
}

__global__ void __launch_bounds__(kThreads) adv_normalize_kernel(
    const float* __restrict__ returns, const float* __restrict__ values,
    const double* __restrict__ partials, int n, float* __restrict__ out,
    int R) {
  __shared__ double buf[2][kThreads];
  __shared__ float stats[2];
  double sum[2];
  fold_partials<2>(partials, n, sum, buf);
  if (threadIdx.x == 0) {
    const double mean = sum[0] / R;
    const double var = sum[1] / R - mean * mean;
    stats[0] = (float)mean;
    stats[1] = (float)sqrt(var > 0.0 ? var : 0.0) + 1e-5f;
  }
  __syncthreads();
  const float mean = stats[0], denom = stats[1];
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < R;
       r += gridDim.x * kThreads) {
    out[r] = ((returns[r] - values[r]) - mean) / denom;
  }
}


// ---- the diagonal-Gaussian branch (the walker student) ---------------------
// Per row r with A actions, mean m (R, A) and the shared log-std ls (A,):
//   lp = sum_j (-(a_j - m_j)^2 / (2 exp(2 ls_j)) - ls_j - c),
//   c = log(2 pi) / 2;  entropy_r = sum_j (ls_j + log(2 pi e) / 2),
// the same for every row.  The rest of the loss is the categorical branch's.
// Backward: dmean_j = g_lp (a_j - m_j) / var_j and, summed over the rows in
// per-CTA double partials folded in a fixed order, dls_j = sum_r g_lp
// ((a_j - m_j)^2 / var_j - 1) + c_e (the entropy's gradient is 1 a dim).

constexpr int kMaxGaussA = 8;

struct GaussRow {
  float lp, ratio, surr1, surr2;
};

__device__ __forceinline__ void gauss_row(const float* __restrict__ mean,
                                          const float* __restrict__ act,
                                          const float* var, const float* ls,
                                          float c, float old_lp, float adv,
                                          int A, float lo, float hi,
                                          GaussRow& row) {
  float lp = 0.0f;
  for (int j = 0; j < A; ++j) {
    const float d = __fsub_rn(act[j], mean[j]);
    const float t = __fsub_rn(
        __fsub_rn(__fdiv_rn(-__fmul_rn(d, d), __fmul_rn(2.0f, var[j])), ls[j]),
        c);
    lp = j == 0 ? t : __fadd_rn(lp, t);
  }
  row.lp = lp;
  row.ratio = expf(__fsub_rn(lp, old_lp));
  row.surr1 = __fmul_rn(row.ratio, adv);
  row.surr2 = __fmul_rn(fminf(fmaxf(row.ratio, lo), hi), adv);
}

__device__ __forceinline__ float value_term(float v, float old_v, float ret,
                                            float clip, int clip_value_loss) {
  if (clip_value_loss) {
    const float clipped = old_v + fminf(fmaxf(v - old_v, -clip), clip);
    const float d1 = v - ret, d2 = clipped - ret;
    return fmaxf(d1 * d1, d2 * d2);
  }
  const float d = fabsf(v - ret);
  return d < 1.0f ? 0.5f * d * d : d - 0.5f;
}

__global__ void __launch_bounds__(kThreads) ppo_gauss_rows_kernel(
    const float* __restrict__ mean, const float* __restrict__ log_std,
    const float* __restrict__ values, const float* __restrict__ actions,
    const float* __restrict__ old_lp, const float* __restrict__ old_v,
    const float* __restrict__ returns, const float* __restrict__ advs,
    double* __restrict__ partials, int R, int A, float clip, float lo,
    float hi, int clip_value_loss, float c, float c_ent) {
  __shared__ double buf[3][kThreads];
  float ls[kMaxGaussA], var[kMaxGaussA];
  float ent = 0.0f;
  for (int j = 0; j < A; ++j) {
    ls[j] = log_std[j];
    var[j] = expf(__fmul_rn(2.0f, ls[j]));
    const float e = __fadd_rn(ls[j], c_ent);
    ent = j == 0 ? e : __fadd_rn(ent, e);
  }
  double sum[3] = {0.0, 0.0, 0.0};
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < R;
       r += gridDim.x * kThreads) {
    GaussRow row;
    gauss_row(mean + (size_t)r * A, actions + (size_t)r * A, var, ls, c,
              old_lp[r], advs[r], A, lo, hi, row);
    sum[0] += (double)fminf(row.surr1, row.surr2);
    sum[1] += (double)value_term(values[r], old_v[r], returns[r], clip,
                                 clip_value_loss);
    sum[2] += (double)ent;
  }
  block_sum<3>(sum, buf);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) partials[blockIdx.x * 3 + k] = sum[k];
  }
}

__global__ void __launch_bounds__(kThreads) ppo_gauss_backward_kernel(
    const float* __restrict__ mean, const float* __restrict__ log_std,
    const float* __restrict__ values, const float* __restrict__ actions,
    const float* __restrict__ old_lp, const float* __restrict__ old_v,
    const float* __restrict__ returns, const float* __restrict__ advs,
    const float* __restrict__ grad_out, float* __restrict__ dmean,
    float* __restrict__ dvalues, double* __restrict__ partials, int R, int A,
    float clip, float lo, float hi, int clip_value_loss,
    float value_loss_coef, float c) {
  __shared__ double buf[kMaxGaussA][kThreads];
  float ls[kMaxGaussA], var[kMaxGaussA];
  for (int j = 0; j < A; ++j) {
    ls[j] = log_std[j];
    var[j] = expf(__fmul_rn(2.0f, ls[j]));
  }
  const float inv_r = 1.0f / (float)R;
  const float g_loss = grad_out[0];
  const float c_v = g_loss * value_loss_coef + grad_out[1];
  const float c_a = g_loss + grad_out[2];
  double dls[kMaxGaussA];
  for (int j = 0; j < kMaxGaussA; ++j) dls[j] = 0.0;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < R;
       r += gridDim.x * kThreads) {
    const float adv = advs[r];
    const float* m = mean + (size_t)r * A;
    const float* a = actions + (size_t)r * A;
    GaussRow row;
    gauss_row(m, a, var, ls, c, old_lp[r], adv, A, lo, hi, row);
    const float w1 = row.surr1 < row.surr2 ? 1.0f
                     : row.surr1 > row.surr2 ? 0.0f : 0.5f;
    const bool in_clip = row.ratio >= lo && row.ratio <= hi;
    const float g_lp = -c_a * inv_r *
                       (w1 * adv + (1.0f - w1) * (in_clip ? adv : 0.0f)) *
                       row.ratio;
    for (int j = 0; j < A; ++j) {
      const float d = a[j] - m[j];
      dmean[(size_t)r * A + j] = g_lp * d / var[j];
      dls[j] += (double)(g_lp * (d * d / var[j] - 1.0f));
    }
    const float v = values[r], ret = returns[r];
    float dv;
    if (clip_value_loss) {
      const float d = v - old_v[r];
      const float clipped = old_v[r] + fminf(fmaxf(d, -clip), clip);
      const float d1 = v - ret, d2 = clipped - ret;
      const float q1 = d1 * d1, q2 = d2 * d2;
      const float w = q1 > q2 ? 1.0f : q1 < q2 ? 0.0f : 0.5f;
      const float pass = (d >= -clip && d <= clip) ? 1.0f : 0.0f;
      dv = c_v * 0.5f * inv_r * (w * 2.0f * d1 + (1.0f - w) * 2.0f * d2 * pass);
    } else {
      const float d1 = v - ret;
      const float d = fabsf(d1);
      const float sign = d1 > 0.0f ? 1.0f : d1 < 0.0f ? -1.0f : 0.0f;
      dv = c_v * inv_r * (d < 1.0f ? d : 1.0f) * sign;
    }
    dvalues[r] = dv;
  }
  block_sum<kMaxGaussA>(dls, buf);
  if (threadIdx.x == 0) {
    for (int j = 0; j < A; ++j) partials[blockIdx.x * kMaxGaussA + j] = dls[j];
  }
}

// dlog_std_j = the rows' partials folded in a fixed order + c_e.
__global__ void __launch_bounds__(kThreads) ppo_gauss_dls_kernel(
    const double* __restrict__ partials, int n, const float* __restrict__ grad_out,
    float* __restrict__ dlog_std, int A, float entropy_coef) {
  __shared__ double buf[kMaxGaussA][kThreads];
  double sum[kMaxGaussA];
  fold_partials<kMaxGaussA>(partials, n, sum, buf);
  if (threadIdx.x == 0) {
    const float c_e = grad_out[3] - grad_out[0] * entropy_coef;
    for (int j = 0; j < A; ++j) dlog_std[j] = (float)sum[j] + c_e;
  }
}

// ---- the Beta branch (the CarRacing student) -------------------------------
// Per row r and action j: x = clamp(u, 1e-6, 1 - 1e-6),
//   logB = lgamma(a) + lgamma(b) - lgamma(a + b),
//   lp = sum_j (a - 1) log x + (b - 1) log1p(-x) - logB,
//   entropy_r = sum_j logB - (a - 1) psi(a) - (b - 1) psi(b)
//               + (a + b - 2) psi(a + b),
// the rest of the loss as the categorical branch, the ratio and the
// surrogates in double, clamped at the caller's float32 bounds 1 -/+ clip
// (JAX's).  Double, because at the clip edges (a - 1) log x reaches ~100,
// and float32 rows would put the means more than 1e-6 relative off
// (tests/test_torch_carracing.py:test_beta_means_need_double_rows).
// Backward:
//   dalpha = g_lp (log x - psi(a) + psi(a + b))
//            + g_ent (-(a - 1) psi1(a) + (a + b - 2) psi1(a + b)),
// and dbeta likewise with log1p(-x) and b, g_ent = c_e / R.

constexpr int kBetaA = 3;

// digamma for x > 0: psi(x) = psi(x + 1) - 1 / x up to x >= 6, then
// ln x - 1/(2x) - 1/(12x^2) + 1/(120x^4) - 1/(252x^6) + 1/(240x^8)
// - 1/(132x^10).
__device__ double digamma_d(double x) {
  double r = 0.0;
  while (x < 6.0) {
    r -= 1.0 / x;
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  return r + log(x) - 0.5 / x -
         f * (1.0 / 12 - f * (1.0 / 120 - f * (1.0 / 252 -
                                               f * (1.0 / 240 - f / 132))));
}

// trigamma for x > 0: psi1(x) = psi1(x + 1) + 1 / x^2 up to x >= 6, then
// 1/x + 1/(2x^2) + 1/(6x^3) - 1/(30x^5) + 1/(42x^7) - 1/(30x^9)
// + 5/(66x^11).
__device__ double trigamma_d(double x) {
  double r = 0.0;
  while (x < 6.0) {
    r += 1.0 / (x * x);
    x += 1.0;
  }
  const double f = 1.0 / (x * x);
  return r + 1.0 / x + 0.5 * f +
         f / x * (1.0 / 6 - f * (1.0 / 30 - f * (1.0 / 42 -
                                                 f * (1.0 / 30 - f * 5.0 / 66))));
}

struct BetaRow {
  double lp, entropy, ratio, surr1, surr2;
};

__device__ __forceinline__ void beta_row(const float* __restrict__ alpha,
                                         const float* __restrict__ beta,
                                         const float* __restrict__ u,
                                         float old_lp, float adv, double lo,
                                         double hi, BetaRow& row) {
  double lp = 0.0, ent = 0.0;
  for (int j = 0; j < kBetaA; ++j) {
    const double a = alpha[j], b = beta[j];
    const double x = fminf(fmaxf(u[j], 1e-6f), 1.0f - 1e-6f);
    const double log_b = lgamma(a) + lgamma(b) - lgamma(a + b);
    lp += (a - 1.0) * log(x) + (b - 1.0) * log1p(-x) - log_b;
    ent += log_b - (a - 1.0) * digamma_d(a) - (b - 1.0) * digamma_d(b) +
           (a + b - 2.0) * digamma_d(a + b);
  }
  row.lp = lp;
  row.entropy = ent;
  row.ratio = exp(lp - (double)old_lp);
  row.surr1 = row.ratio * adv;
  row.surr2 = fmin(fmax(row.ratio, lo), hi) * adv;
}

__global__ void __launch_bounds__(kThreads) ppo_beta_rows_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ values, const float* __restrict__ u,
    const float* __restrict__ old_lp, const float* __restrict__ old_v,
    const float* __restrict__ returns, const float* __restrict__ advs,
    double* __restrict__ partials, int R, float clip, double lo, double hi,
    int clip_value_loss) {
  __shared__ double buf[3][kThreads];
  double sum[3] = {0.0, 0.0, 0.0};
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < R;
       r += gridDim.x * kThreads) {
    BetaRow row;
    beta_row(alpha + (size_t)r * kBetaA, beta + (size_t)r * kBetaA,
             u + (size_t)r * kBetaA, old_lp[r], advs[r], lo, hi, row);
    sum[0] += fmin(row.surr1, row.surr2);
    sum[1] += (double)value_term(values[r], old_v[r], returns[r], clip,
                                 clip_value_loss);
    sum[2] += row.entropy;
  }
  block_sum<3>(sum, buf);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) partials[blockIdx.x * 3 + k] = sum[k];
  }
}

__global__ void __launch_bounds__(kThreads) ppo_beta_backward_kernel(
    const float* __restrict__ alpha, const float* __restrict__ beta,
    const float* __restrict__ values, const float* __restrict__ u,
    const float* __restrict__ old_lp, const float* __restrict__ old_v,
    const float* __restrict__ returns, const float* __restrict__ advs,
    const float* __restrict__ grad_out, float* __restrict__ dalpha,
    float* __restrict__ dbeta, float* __restrict__ dvalues, int R,
    float clip, double lo, double hi, int clip_value_loss,
    float value_loss_coef, float entropy_coef) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const double inv_r = 1.0 / (double)R;
  const float g_loss = grad_out[0];
  const float c_v = g_loss * value_loss_coef + grad_out[1];
  const double c_a = (double)g_loss + (double)grad_out[2];
  const double c_e = (double)grad_out[3] - (double)g_loss * entropy_coef;
  const float adv = advs[r];
  const float* al = alpha + (size_t)r * kBetaA;
  const float* be = beta + (size_t)r * kBetaA;
  const float* uu = u + (size_t)r * kBetaA;
  BetaRow row;
  beta_row(al, be, uu, old_lp[r], adv, lo, hi, row);
  const double w1 = row.surr1 < row.surr2 ? 1.0
                    : row.surr1 > row.surr2 ? 0.0 : 0.5;
  const bool in_clip = row.ratio >= lo && row.ratio <= hi;
  const double g_lp = -c_a * inv_r *
                      (w1 * adv + (1.0 - w1) * (in_clip ? adv : 0.0)) *
                      row.ratio;
  const double g_ent = c_e * inv_r;
  for (int j = 0; j < kBetaA; ++j) {
    const double a = al[j], b = be[j];
    const double x = fminf(fmaxf(uu[j], 1e-6f), 1.0f - 1e-6f);
    const double psi_ab = digamma_d(a + b), t_ab = trigamma_d(a + b);
    const double s = (a + b - 2.0) * t_ab;
    dalpha[(size_t)r * kBetaA + j] = (float)(
        g_lp * (log(x) - digamma_d(a) + psi_ab) +
        g_ent * (s - (a - 1.0) * trigamma_d(a)));
    dbeta[(size_t)r * kBetaA + j] = (float)(
        g_lp * (log1p(-x) - digamma_d(b) + psi_ab) +
        g_ent * (s - (b - 1.0) * trigamma_d(b)));
  }
  const float v = values[r], ret = returns[r];
  float dv;
  if (clip_value_loss) {
    const float d = v - old_v[r];
    const float clipped = old_v[r] + fminf(fmaxf(d, -clip), clip);
    const float d1 = v - ret, d2 = clipped - ret;
    const float q1 = d1 * d1, q2 = d2 * d2;
    const float w = q1 > q2 ? 1.0f : q1 < q2 ? 0.0f : 0.5f;
    const float pass = (d >= -clip && d <= clip) ? 1.0f : 0.0f;
    dv = c_v * 0.5f / (float)R * (w * 2.0f * d1 + (1.0f - w) * 2.0f * d2 * pass);
  } else {
    const float d1 = v - ret;
    const float d = fabsf(d1);
    const float sign = d1 > 0.0f ? 1.0f : d1 < 0.0f ? -1.0f : 0.0f;
    dv = c_v / (float)R * (d < 1.0f ? d : 1.0f) * sign;
  }
  dvalues[r] = dv;
}

}  // namespace

// Doubles of workspace a call with R rows needs (3 per partial).
extern "C" int dcd_ppo_loss_workspace(int R) { return 3 * reduce_blocks(R); }

extern "C" int dcd_ppo_loss_forward(
    const void* logits, const void* values, const void* actions,
    const void* old_lp, const void* old_v, const void* returns,
    const void* advs, void* partials, void* out, int R, int A, float clip,
    float lo, float hi, int clip_value_loss, float value_loss_coef,
    float entropy_coef, void* stream) {
  if (R <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = reduce_blocks(R);
  ppo_loss_rows_kernel<<<n, kThreads, 0, s>>>(
      (const float*)logits, (const float*)values, (const int64_t*)actions,
      (const float*)old_lp, (const float*)old_v, (const float*)returns,
      (const float*)advs, (double*)partials, R, A, clip, lo, hi,
      clip_value_loss);
  ppo_loss_final_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, n, (float*)out, R, clip_value_loss,
      value_loss_coef, entropy_coef);
  return (int)cudaGetLastError();
}

extern "C" int dcd_ppo_loss_backward(
    const void* logits, const void* values, const void* actions,
    const void* old_lp, const void* old_v, const void* returns,
    const void* advs, const void* grad_out, void* dlogits, void* dvalues,
    int R, int A, float clip, float lo, float hi, int clip_value_loss,
    float value_loss_coef, float entropy_coef, void* stream) {
  if (R <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
  ppo_loss_backward_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)values, (const int64_t*)actions,
      (const float*)old_lp, (const float*)old_v, (const float*)returns,
      (const float*)advs, (const float*)grad_out, (float*)dlogits,
      (float*)dvalues, R, A, clip, lo, hi, clip_value_loss, value_loss_coef,
      entropy_coef);
  return (int)cudaGetLastError();
}

// Doubles of workspace for R rows (2 per partial).
extern "C" int dcd_normalize_advantages_workspace(int R) {
  return 2 * reduce_blocks(R);
}

extern "C" int dcd_normalize_advantages(const void* returns,
                                        const void* values, void* partials,
                                        void* out, int R, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = reduce_blocks(R);
  adv_moments_kernel<<<n, kThreads, 0, s>>>(
      (const float*)returns, (const float*)values, (double*)partials, R);
  adv_normalize_kernel<<<n, kThreads, 0, s>>>(
      (const float*)returns, (const float*)values, (const double*)partials,
      n, (float*)out, R);
  return (int)cudaGetLastError();
}

// ---- the diagonal-Gaussian branch ------------------------------------------

extern "C" int dcd_ppo_gauss_workspace(int R) {
  return kMaxGaussA * reduce_blocks(R);
}

// c = log(2 pi) / 2 and c_ent = log(2 pi e) / 2, rounded by the caller.
extern "C" int dcd_ppo_gauss_forward(
    const void* mean, const void* log_std, const void* values,
    const void* actions, const void* old_lp, const void* old_v,
    const void* returns, const void* advs, void* partials, void* out, int R,
    int A, float clip, float lo, float hi, int clip_value_loss,
    float value_loss_coef, float entropy_coef, float c, float c_ent,
    void* stream) {
  if (R <= 0 || A <= 0 || A > kMaxGaussA) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = reduce_blocks(R);
  ppo_gauss_rows_kernel<<<n, kThreads, 0, s>>>(
      (const float*)mean, (const float*)log_std, (const float*)values,
      (const float*)actions, (const float*)old_lp, (const float*)old_v,
      (const float*)returns, (const float*)advs, (double*)partials, R, A,
      clip, lo, hi, clip_value_loss, c, c_ent);
  ppo_loss_final_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, n, (float*)out, R, clip_value_loss,
      value_loss_coef, entropy_coef);
  return (int)cudaGetLastError();
}

extern "C" int dcd_ppo_gauss_backward(
    const void* mean, const void* log_std, const void* values,
    const void* actions, const void* old_lp, const void* old_v,
    const void* returns, const void* advs, const void* grad_out, void* dmean,
    void* dlog_std, void* dvalues, void* partials, int R, int A, float clip,
    float lo, float hi, int clip_value_loss, float value_loss_coef,
    float entropy_coef, float c, void* stream) {
  if (R <= 0 || A <= 0 || A > kMaxGaussA) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = reduce_blocks(R);
  ppo_gauss_backward_kernel<<<n, kThreads, 0, s>>>(
      (const float*)mean, (const float*)log_std, (const float*)values,
      (const float*)actions, (const float*)old_lp, (const float*)old_v,
      (const float*)returns, (const float*)advs, (const float*)grad_out,
      (float*)dmean, (float*)dvalues, (double*)partials, R, A, clip, lo, hi,
      clip_value_loss, value_loss_coef, c);
  ppo_gauss_dls_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, n, (const float*)grad_out, (float*)dlog_std,
      A, entropy_coef);
  return (int)cudaGetLastError();
}

// ---- the Beta branch -------------------------------------------------------

extern "C" int dcd_ppo_beta_workspace(int R) { return 3 * reduce_blocks(R); }

extern "C" int dcd_ppo_beta_forward(
    const void* alpha, const void* beta, const void* values, const void* u,
    const void* old_lp, const void* old_v, const void* returns,
    const void* advs, void* partials, void* out, int R, float clip,
    double lo, double hi, int clip_value_loss, float value_loss_coef,
    float entropy_coef, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = reduce_blocks(R);
  ppo_beta_rows_kernel<<<n, kThreads, 0, s>>>(
      (const float*)alpha, (const float*)beta, (const float*)values,
      (const float*)u, (const float*)old_lp, (const float*)old_v,
      (const float*)returns, (const float*)advs, (double*)partials, R, clip,
      lo, hi, clip_value_loss);
  ppo_loss_final_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, n, (float*)out, R, clip_value_loss,
      value_loss_coef, entropy_coef);
  return (int)cudaGetLastError();
}

extern "C" int dcd_ppo_beta_backward(
    const void* alpha, const void* beta, const void* values, const void* u,
    const void* old_lp, const void* old_v, const void* returns,
    const void* advs, const void* grad_out, void* dalpha, void* dbeta,
    void* dvalues, int R, float clip, double lo, double hi,
    int clip_value_loss, float value_loss_coef, float entropy_coef,
    void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  ppo_beta_backward_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)alpha, (const float*)beta, (const float*)values,
      (const float*)u, (const float*)old_lp, (const float*)old_v,
      (const float*)returns, (const float*)advs, (const float*)grad_out,
      (float*)dalpha, (float*)dbeta, (float*)dvalues, R, clip, lo, hi,
      clip_value_loss, value_loss_coef, entropy_coef);
  return (int)cudaGetLastError();
}
