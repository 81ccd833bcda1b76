// Kernel B12: the CarRacing observation of N cars — the 96 x 96 frame
// rasterized from the track's centerline (road, borders, grass checker,
// car sprite, indicator bars), cast to uint8, preprocessed (crop,
// grayscale, /128 - 1) and written into the frame stack after its older
// frames (or over the whole stack at a reset).
//
// Replaces dcd_isaac_tpu/envs/carracing/track.py:render_frame (:148-241)
// with nearest_tile (:107-133), env.py:_preprocess / _render_obs (:89-106)
// and the stack shift of step (:296-298).  Its plain twin is
// envs/carracing/env.py:stack_frames_plain.
//
// Design: a 2-D grid of (pixel tiles of 256, cars); the car's track (480
// points, their |p|^2, normal angles, border and valid flags: about 10 kB)
// in shared memory; one thread a pixel.  The thread computes the pixel's
// world point, then the first index of the least
//   d2 = (|q|^2 + |p|^2) - 2 (qx px + qy py)
// over the valid points, every product and sum rounded in fp32 on its own
// (__fmul_rn, __fadd_rn: the cross term must not be fused or reduced in
// precision; track.py:111-124 says why), then the layers in the JAX
// order.  A division by a constant is a product with its float32
// reciprocal, as XLA compiles the JAX package; the constants come in as a
// float32 table that the wrapper builds (kernels/carracing_render.py:
// CONSTS).
//
// Bound on the H100: 96 * 96 * 480 distance terms a car (~8 operations
// each, 35 M a car) against 442 kB written a car: at N = 16 about 9 us of
// fp32 throughput, so the kernel is bound by operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 480;
constexpr int kW = 96, kH = 96;
constexpr int kThreads = 256;
constexpr int kBars = 7;

// Offsets into the constant table (kernels/carracing_render.py: CONSTS).
constexpr int C_Z0 = 0, C_Z1 = 1, C_RW = 2, C_RH = 3, C_TW = 4, C_TWB = 5,
              C_ROAD = 6, C_BASE = 7, C_PATCH = 10, C_R20 = 13,
              C_SHADE = 14, C_BAR_SCALE = 15, C_BAR_X = 22, C_BAR_RGB = 29,
              C_SPRITE = 50, C_HULL_RGB = 59, C_GRAY = 62, C_R128 = 65,
              C_COUNT = 66;

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
__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

struct RenderArgs {
  const float *points, *beta;          // (N, 480, 2) (N, 480)
  const uint8_t *border, *valid;       // (N, 480) bool
  const float *pos, *angle, *vel, *angvel, *omega, *steer, *t;
  const float* old;                    // (N, h, w, c * stack) or null
  const float* consts;
  float* out;                          // (N, h, w, c * stack)
  int n, crop, gray, stack, shift;
};

__global__ void __launch_bounds__(kThreads) carracing_render_kernel(
    RenderArgs a) {
  const int car = blockIdx.y;
  const float* C = a.consts;
  __shared__ float spx[kCap], spy[kCap], sp2[kCap], sbt[kCap];
  __shared__ uint8_t sbd[kCap], sok[kCap];
  for (int i = threadIdx.x; i < kCap; i += kThreads) {
    const float x = a.points[((size_t)car * kCap + i) * 2];
    const float y = a.points[((size_t)car * kCap + i) * 2 + 1];
    spx[i] = x;
    spy[i] = y;
    sp2[i] = fadd(fmul(x, x), fmul(y, y));
    sbt[i] = a.beta[(size_t)car * kCap + i];
    sbd[i] = a.border[(size_t)car * kCap + i];
    sok[i] = a.valid[(size_t)car * kCap + i];
  }
  __syncthreads();
  const int ho = a.crop ? 84 : kH, wo = a.crop ? 84 : kW;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= ho * wo) return;
  const int oi = pix / wo, oj = pix % wo;
  const int row = oi, col = a.crop ? oj + 6 : oj;

  // camera: zoom ramp over the first second, the car at (W/2, H/4)
  const float t = a.t[car];
  const float zoom = fadd(fmul(C[C_Z0], fmaxf(fsub(1.0f, t), 0.0f)),
                          fmul(C[C_Z1], fminf(t, 1.0f)));
  const float sx = fmul(fmul(zoom, (float)kW), C[C_RW]);
  const float sy = fmul(fmul(zoom, (float)kH), C[C_RH]);
  const float ex = fdiv(fsub((float)col, 48.0f), sx);
  const float ey = fdiv(fsub(fsub(95.0f, (float)row), 24.0f), sy);
  const float ang = a.angle[car];
  const float ca = cos_rn(ang), sa = sin_rn(ang);
  const float wx = fadd(fadd(a.pos[2 * car], fmul(ex, ca)), fmul(ey, -sa));
  const float wy = fadd(fadd(a.pos[2 * car + 1], fmul(ex, sa)), fmul(ey, ca));

  // nearest valid centerline point, the first on a tie
  const float q2 = fadd(fmul(wx, wx), fmul(wy, wy));
  float best = __int_as_float(0x7f800000);
  int idx = 0;
  for (int i = 0; i < kCap; ++i) {
    if (!sok[i]) continue;
    const float qp = fadd(fmul(wx, spx[i]), fmul(wy, spy[i]));
    const float d2 = fsub(fadd(q2, sp2[i]), fmul(2.0f, qp));
    if (d2 < best) { best = d2; idx = i; }
  }
  const float dist = sqrtf(fmaxf(best, 0.0f));

  float rgb[3];
  if (dist <= C[C_TW]) {
    const float road = fadd(C[C_ROAD], fmul(C[C_SHADE], (float)(idx % 3)));
    rgb[0] = rgb[1] = rgb[2] = road;
  } else {
    const float s = fadd(floorf(fmul(wx, C[C_R20])), floorf(fmul(wy, C[C_R20])));
    const float* g = fmodf(s, 2.0f) == 0.0f ? C + C_PATCH : C + C_BASE;
    rgb[0] = g[0];
    rgb[1] = g[1];
    rgb[2] = g[2];
  }
  const float b_i = sbt[idx];
  const float b_prev = sbt[(idx + kCap - 1) % kCap];
  const float lat = fadd(fmul(fsub(wx, spx[idx]), cos_rn(b_i)),
                         fmul(fsub(wy, spy[idx]), sin_rn(b_i)));
  if (sbd[idx] && dist > C[C_TW] && dist <= C[C_TWB] &&
      signf(lat) == signf(fsub(b_prev, b_i))) {
    const bool white = idx % 2 == 0;
    rgb[0] = 1.0f;
    rgb[1] = white ? 1.0f : 0.0f;
    rgb[2] = white ? 1.0f : 0.0f;
  }
  const float* sp = C + C_SPRITE;
  const float alx = fabsf(ex);
  if (alx < sp[0] && ey > sp[1] && ey < sp[2]) {
    rgb[0] = C[C_HULL_RGB];
    rgb[1] = C[C_HULL_RGB + 1];
    rgb[2] = C[C_HULL_RGB + 2];
  }
  if (fabsf(fsub(alx, sp[3])) < sp[4] &&
      (fabsf(fsub(ey, sp[5])) < sp[6] || fabsf(fadd(ey, sp[7])) < sp[8])) {
    rgb[0] = rgb[1] = rgb[2] = 0.0f;
  }
  if (row >= kH - 12) {
    rgb[0] = rgb[1] = rgb[2] = 0.0f;
    const float vx = a.vel[2 * car], vy = a.vel[2 * car + 1];
    const float value[kBars] = {
        sqrtf(fadd(fmul(vx, vx), fmul(vy, vy))), a.omega[4 * car],
        a.omega[4 * car + 1], a.omega[4 * car + 2], a.omega[4 * car + 3],
        a.steer[car], a.angvel[car]};
    for (int b = 0; b < kBars; ++b) {
      const float h = fmul(clamp01(fmul(fabsf(value[b]), C[C_BAR_SCALE + b])),
                           12.0f);
      const float x0 = C[C_BAR_X + b];
      if ((float)col >= x0 && (float)col < fadd(x0, 2.0f) &&
          (float)row >= fsub((float)kH, h)) {
        rgb[0] = C[C_BAR_RGB + 3 * b];
        rgb[1] = C[C_BAR_RGB + 3 * b + 1];
        rgb[2] = C[C_BAR_RGB + 3 * b + 2];
      }
    }
  }

  // uint8, then the preprocessing
  float u[3];
  for (int k = 0; k < 3; ++k)
    u[k] = (float)(uint8_t)fmul(clamp01(rgb[k]), 255.0f);
  float obs[3];
  int c = 3;
  if (a.gray) {
    c = 1;
    obs[0] = fadd(fadd(fmul(u[0], C[C_GRAY]), fmul(u[1], C[C_GRAY + 1])),
                  fmul(u[2], C[C_GRAY + 2]));
  } else {
    obs[0] = u[0];
    obs[1] = u[1];
    obs[2] = u[2];
  }
  for (int k = 0; k < c; ++k) obs[k] = fsub(fmul(obs[k], C[C_R128]), 1.0f);
  const int ct = c * a.stack;
  const size_t base = ((size_t)car * ho * wo + pix) * ct;
  if (a.shift) {
    for (int k = 0; k < ct - c; ++k) a.out[base + k] = a.old[base + k + c];
    for (int k = 0; k < c; ++k) a.out[base + ct - c + k] = obs[k];
  } else {
    for (int s = 0; s < a.stack; ++s)
      for (int k = 0; k < c; ++k) a.out[base + s * c + k] = obs[k];
  }
}

}  // namespace

extern "C" int dcd_carracing_render_consts_count() { return C_COUNT; }

// `old` may be null when `shift` is 0 (a reset fills the whole stack).
extern "C" int dcd_carracing_render(
    const void* points, const void* beta, const void* border,
    const void* valid, const void* pos, const void* angle, const void* vel,
    const void* angvel, const void* omega, const void* steer, const void* t,
    const void* old, const void* consts, void* out, int n, int crop,
    int gray, int stack, int shift, void* stream) {
  if (n <= 0 || stack <= 0 || (shift && old == nullptr))
    return (int)cudaErrorInvalidValue;
  RenderArgs a;
  a.points = (const float*)points;
  a.beta = (const float*)beta;
  a.border = (const uint8_t*)border;
  a.valid = (const uint8_t*)valid;
  a.pos = (const float*)pos;
  a.angle = (const float*)angle;
  a.vel = (const float*)vel;
  a.angvel = (const float*)angvel;
  a.omega = (const float*)omega;
  a.steer = (const float*)steer;
  a.t = (const float*)t;
  a.old = (const float*)old;
  a.consts = (const float*)consts;
  a.out = (float*)out;
  a.n = n;
  a.crop = crop;
  a.gray = gray;
  a.stack = stack;
  a.shift = shift;
  const int pixels = crop ? 84 * 84 : kW * kH;
  dim3 grid((pixels + kThreads - 1) / kThreads, n);
  carracing_render_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
