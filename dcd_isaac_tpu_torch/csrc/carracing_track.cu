// Kernel B13b: N CarRacing tracks from their control points — the ccw
// sort, the smoothed Bezier curve padded to 480 points, build_track
// (normal angles, zero-length steps masked, bbox centring, border flags),
// the start tile of start_alpha and the car at rest on it.
//
// Replaces dcd_isaac_tpu/envs/carracing/adversarial.py:_bezier_track_padded
// (:62-87) with bezier.py:get_bezier_track (:33-64), track.py:build_track
// (:48-105), adversarial.py:_closest_track_index (:46-59) and
// dynamics.py:init_car (:96).  Its plain twin is envs/carracing/
// adversarial.py:build_level_plain.
//
// Design: one warp (a block of 32 threads) per level.  Lane 0 sorts the
// n <= 12 points (a rank count with the index as tie-break: a stable
// sort) and computes the n segments' control points; the 480 curve
// samples, their angles, the border runs and the start-angle search are
// spread over the lanes with the curve in shared memory.  Every float
// operation is rounded on its own (__fadd_rn, __fmul_rn, ...; nvcc would
// otherwise contract a*b+c into an FMA) in the twin's order; the sum of
// |dbeta| is the twin's tree_sum: 512 slots (zero padded), halves added
// pairwise; the start search takes the first index of the least
// difference.  The constants (the Bernstein table, p and 1 - p, pi, ...)
// come in as a float32 table that the wrapper builds with the twin's
// arithmetic (kernels/carracing_track.py: CONSTS).
//
// Bound on the H100: a level reads 104 B and writes about 7.7 kB; at
// N = 16 that is nanoseconds of bandwidth, and the kernel is bound by
// lane 0's serial sort and its barriers, not by bytes or flops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCP = 12;
constexpr int kNum = 40;
constexpr int kCap = kCP * kNum;   // 480
constexpr int kPad = 512;
constexpr int kBorderMin = 4;

// Offsets into the constant table (kernels/carracing_track.py: CONSTS).
constexpr int C_BERN = 0, C_P = 160, C_Q = 161, C_PI = 162, C_TWO_PI = 163,
              C_HALF_PI = 164, C_RAD = 165, C_BIG = 166, C_COUNT = 167;

// sin, cos and atan2 in double, rounded once to float: the twins'
// (envs/carracing/bezier.py), so the CPU and the card agree to the bit.
// sqrtf is correctly rounded already.
__device__ __forceinline__ float sin_rn(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos_rn(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float atan2_rn(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct TrackArgs {
  const float* cps;          // (N, 12, 2)
  const int* n;              // (N,)
  const float* start_alpha;  // (N,)
  const float* consts;
  float* points;             // (N, 480, 2)
  float* beta;               // (N, 480)
  uint8_t* border;           // (N, 480) bool
  uint8_t* valid;            // (N, 480) bool
  int* n_points;             // (N,)
  float* offset;             // (N, 2)
  int* start;                // (N,)
  float* car_pos;            // (N, 2)
  float* car_angle;          // (N,)
  int levels;
};

__global__ void __launch_bounds__(32) carracing_track_kernel(TrackArgs a) {
  const int lv = blockIdx.x;
  const int lane = threadIdx.x;
  const float* C = a.consts;
  __shared__ float cx[kCap], cy[kCap], bt[kCap];
  __shared__ float red[kPad];
  __shared__ uint8_t ok[kCap], bd[2][kCap];
  // the segments' control points p1, c1, c2, p2 (x then y)
  __shared__ float seg[kCP][8];
  __shared__ float stats[2];

  const float* cp = a.cps + (size_t)lv * kCP * 2;
  const int n_raw = a.n[lv];
  const int n = n_raw < 3 ? 3 : (n_raw > kCP ? kCP : n_raw);
  if (lane == 0) {
    // ccw order around the mean of the first n points by atan2(dx, dy)
    float mx = 0.0f, my = 0.0f;
    for (int j = 0; j < kCP; ++j) {
      const float x = j < n ? cp[2 * j] : 0.0f;
      const float y = j < n ? cp[2 * j + 1] : 0.0f;
      mx = j == 0 ? x : fadd(mx, x);
      my = j == 0 ? y : fadd(my, y);
    }
    mx = fdiv(mx, (float)n);
    my = fdiv(my, (float)n);
    float s[kCP], ax[kCP], ay[kCP];
    for (int j = 0; j < n; ++j)
      s[j] = atan2_rn(fsub(cp[2 * j], mx), fsub(cp[2 * j + 1], my));
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int j = 0; j < n; ++j) r += (s[j] < s[i]) || (s[j] == s[i] && j < i);
      ax[r] = cp[2 * i];
      ay[r] = cp[2 * i + 1];
    }
    float ang[kCP], dx[kCP], dy[kCP];
    for (int j = 0; j < n; ++j) {
      const int k = j + 1 == n ? 0 : j + 1;
      dx[j] = fsub(ax[k], ax[j]);
      dy[j] = fsub(ay[k], ay[j]);
      float g = atan2_rn(dy[j], dx[j]);
      ang[j] = g >= 0.0f ? g : fadd(g, C[C_TWO_PI]);
    }
    float sm[kCP];
    for (int j = 0; j < n; ++j) {
      const float a1 = ang[j], a2 = ang[j == 0 ? n - 1 : j - 1];
      const float wrap = fabsf(fsub(a2, a1)) > C[C_PI] ? C[C_PI] : 0.0f;
      sm[j] = fadd(fadd(fmul(C[C_P], a1), fmul(C[C_Q], a2)), wrap);
    }
    for (int j = 0; j < n; ++j) {
      const int k = j + 1 == n ? 0 : j + 1;
      const float r = fmul(C[C_RAD], sqrtf(fadd(fmul(dx[j], dx[j]),
                                                fmul(dy[j], dy[j]))));
      const float th2 = fadd(sm[k], C[C_PI]);
      seg[j][0] = ax[j];
      seg[j][1] = fadd(ax[j], fmul(r, cos_rn(sm[j])));
      seg[j][2] = fadd(ax[k], fmul(r, cos_rn(th2)));
      seg[j][3] = ax[k];
      seg[j][4] = ay[j];
      seg[j][5] = fadd(ay[j], fmul(r, sin_rn(sm[j])));
      seg[j][6] = fadd(ay[k], fmul(r, sin_rn(th2)));
      seg[j][7] = ay[k];
    }
  }
  __syncthreads();

  // the Bernstein samples of the n segments, then the padding
  const int used = n * kNum;
  for (int i = lane; i < kCap; i += 32) {
    const int j = i < used ? i / kNum : n - 1;
    const int m = i < used ? i % kNum : kNum - 1;
    const float* b = C + C_BERN + 4 * m;
    const float* s = seg[j];
    cx[i] = fadd(fadd(fadd(fmul(b[0], s[0]), fmul(b[1], s[1])),
                      fmul(b[2], s[2])), fmul(b[3], s[3]));
    cy[i] = fadd(fadd(fadd(fmul(b[0], s[4]), fmul(b[1], s[5])),
                      fmul(b[2], s[6])), fmul(b[3], s[7]));
  }
  __syncthreads();

  // build_track: angles of the steps, the valid mask, the bbox
  float lo_x = C[C_BIG], lo_y = C[C_BIG], hi_x = -C[C_BIG], hi_y = -C[C_BIG];
  int count = 0;
  for (int i = lane; i < kCap; i += 32) {
    const int k = i + 1 == kCap ? 0 : i + 1;
    const float dx = fsub(cx[k], cx[i]), dy = fsub(cy[k], cy[i]);
    bt[i] = fadd(C[C_HALF_PI], atan2_rn(dy, dx));
    const bool v = i < used && !(dx == 0.0f && dy == 0.0f);
    ok[i] = v;
    count += v;
    if (v) {
      lo_x = fminf(lo_x, cx[i]);
      lo_y = fminf(lo_y, cy[i]);
      hi_x = fmaxf(hi_x, cx[i]);
      hi_y = fmaxf(hi_y, cy[i]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, o));
    lo_y = fminf(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, o));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, o));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, o));
    count += __shfl_xor_sync(0xffffffffu, count, o);
  }
  const float off_x = fadd(lo_x, fmul(fsub(hi_x, lo_x), 0.5f));
  const float off_y = fadd(lo_y, fmul(fsub(hi_y, lo_y), 0.5f));
  __syncthreads();

  // mean |dbeta| over the valid points: the twin's tree_sum over 512
  for (int i = lane; i < kPad; i += 32) {
    float v = 0.0f;
    if (i < kCap && ok[i]) {
      const int k = i + 1 == kCap ? 0 : i + 1;
      v = fabsf(fsub(bt[k], bt[i]));
    }
    red[i] = v;
  }
  __syncthreads();
  for (int h = kPad / 2; h >= 1; h >>= 1) {
    for (int i = lane; i < h; i += 32) red[i] = fadd(red[i], red[i + h]);
    __syncthreads();
  }
  const float mean_abs = fdiv(red[0], (float)(count < 1 ? 1 : count));

  // border runs: four steps turning the same way, each beyond the mean,
  // then spread by the twin's iterated rolls
  for (int i = lane; i < kCap; i += 32) {
    bool good = true;
    float oneside = 0.0f;
    for (int neg = 0; neg < kBorderMin; ++neg) {
      const float b1 = bt[(i - neg + kCap) % kCap];
      const float b2 = bt[(i - neg - 1 + kCap) % kCap];
      const float d = fsub(b1, b2);
      good = good && fabsf(d) > mean_abs;
      oneside = fadd(oneside, signf(d));
    }
    bd[0][i] = good && fabsf(oneside) == (float)kBorderMin;
  }
  __syncthreads();
  int cur = 0;
  for (int neg = 1; neg < kBorderMin; ++neg) {
    for (int i = lane; i < kCap; i += 32)
      bd[1 - cur][i] = bd[cur][i] | bd[cur][(i + neg) % kCap];
    __syncthreads();
    cur = 1 - cur;
  }

  // outputs of the track
  float* pts = a.points + (size_t)lv * kCap * 2;
  for (int i = lane; i < kCap; i += 32) {
    const float px = fsub(cx[i], off_x), py = fsub(cy[i], off_y);
    pts[2 * i] = px;
    pts[2 * i + 1] = py;
    a.beta[(size_t)lv * kCap + i] = bt[i];
    a.border[(size_t)lv * kCap + i] = bd[cur][i] && ok[i];
    a.valid[(size_t)lv * kCap + i] = ok[i];
  }

  // the start tile: polar angle around the control points' mean
  const float sa = a.start_alpha[lv];
  int best_i = 0;
  if (sa >= 0.0f) {
    if (lane == 0) {
      float ux = 0.0f, uy = 0.0f;
      for (int j = 0; j < kCP; ++j) {
        const float x = j < n_raw ? cp[2 * j] : 0.0f;
        const float y = j < n_raw ? cp[2 * j + 1] : 0.0f;
        ux = j == 0 ? x : fadd(ux, x);
        uy = j == 0 ? y : fadd(uy, y);
      }
      const float nf = (float)(n_raw < 1 ? 1 : n_raw);
      stats[0] = fsub(fdiv(ux, nf), off_x);
      stats[1] = fsub(fdiv(uy, nf), off_y);
    }
    __syncthreads();
    float best = __int_as_float(0x7f800000);
    best_i = 1 << 30;
    for (int i = lane; i < kCap; i += 32) {
      if (!ok[i]) continue;
      float al = atan2_rn(fsub(fsub(cy[i], off_y), stats[1]),
                        fsub(fsub(cx[i], off_x), stats[0]));
      if (al < 0.0f) al = fadd(al, C[C_TWO_PI]);
      const float d = fabsf(fsub(al, sa));
      if (d < best) { best = d; best_i = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob < best || (ob == best && oi < best_i)) { best = ob; best_i = oi; }
    }
    if (best_i >= kCap) best_i = 0;
  }
  if (lane == 0) {
    a.n_points[lv] = count;
    a.offset[2 * lv] = off_x;
    a.offset[2 * lv + 1] = off_y;
    a.start[lv] = best_i;
    a.car_pos[2 * lv] = fsub(cx[best_i], off_x);
    a.car_pos[2 * lv + 1] = fsub(cy[best_i], off_y);
    a.car_angle[lv] = bt[best_i];
  }
}

}  // namespace

extern "C" int dcd_carracing_track_consts_count() { return C_COUNT; }

extern "C" int dcd_carracing_track(
    const void* cps, const void* n, const void* start_alpha,
    const void* consts, void* points, void* beta, void* border, void* valid,
    void* n_points, void* offset, void* start, void* car_pos,
    void* car_angle, int levels, void* stream) {
  if (levels <= 0) return (int)cudaErrorInvalidValue;
  TrackArgs a;
  a.cps = (const float*)cps;
  a.n = (const int*)n;
  a.start_alpha = (const float*)start_alpha;
  a.consts = (const float*)consts;
  a.points = (float*)points;
  a.beta = (float*)beta;
  a.border = (uint8_t*)border;
  a.valid = (uint8_t*)valid;
  a.n_points = (int*)n_points;
  a.offset = (float*)offset;
  a.start = (int*)start;
  a.car_pos = (float*)car_pos;
  a.car_angle = (float*)car_angle;
  a.levels = levels;
  carracing_track_kernel<<<levels, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
