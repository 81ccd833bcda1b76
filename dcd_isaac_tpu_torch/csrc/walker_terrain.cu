// Kernel B11: the walker's terrain and initial placement of N levels.
//
// Replaces dcd_isaac_tpu/envs/walker/terrain.py:generate_terrain (:36-219),
// the 200-column GRASS / STUMP / STAIRS / PIT state machine that turns the
// 8 level params into a heightfield and up to 64 boxes, and env.py's
// place_walker (:40-59) with its random push of the hull.  The JAX package
// draws from jax.random keys of the level seed; the port draws each
// column's eight uniforms and the push from a counter-based hash of
// (seed, column, slot) — seeds.py:hash_uniform, the same integer operations
// in uint32 — so kernel and plain twin (envs/walker/terrain.py) make the
// same terrain bit for bit.  The slots are 0 grass velocity, 1 pit gap,
// 2 stump height, 3 stair height, 4 stair slope, 5 stair steps, 6 next
// counter, 7 next feature; the push is slot 0 of column 200.
//
// Design: one thread a level runs the state machine, writing xs, ys and
// the boxes as it goes.  Every float operation is rounded on its own
// (__fadd_rn, __fmul_rn, ...), in the twin's order; constant divisors are
// products with the constants XLA folds them into.  The constants come in
// as a float32 table the wrapper builds with the twin's arithmetic
// (kernels/walker_terrain.py: CONSTS).
//
// Bound on the H100: a level writes 2.7 kB (1.6 kB heightfield, 1 kB boxes,
// the bodies), nanoseconds of bandwidth at N = 16; the kernel is bound by
// its 200 dependent column steps (~57 operations each) on one thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLen = 200;
constexpr int kBoxes = 64;
constexpr int kGrass = 0, kStump = 1, kStairs = 2, kPit = 3;

// Offsets into the constant table (kernels/walker_terrain.py: CONSTS).
constexpr int T_STEP = 0, T_STEP4 = 1, T_HEIGHT = 2, T_STAIR_X = 3,
              T_VEL_DECAY = 13, T_VEL_PULL = 14, T_RSCALE = 15, T_POS = 16,
              T_ANGLE = 26, T_PUSH = 31, T_PUSH_DV = 32, T_COUNT = 33;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t col,
                                              uint32_t slot) {
  uint32_t h = seed * 0x9E3779B1u + col * 0x7F4A7C15u + slot * 0x2545F491u +
               0x6A09E667u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __fmul_rn((float)(h >> 8), 5.9604644775390625e-08f);  // 2^-24
}

// jax.random.uniform's map: max(lo, u * (hi - lo) + lo)
__device__ __forceinline__ float uniform_range(float u, float lo, float hi) {
  return fmaxf(lo, fadd(fmul(u, fsub(hi, lo)), lo));
}

// an int in [lo, hi): lo + min(floor(u * (hi - lo)), hi - lo - 1)
__device__ __forceinline__ int randint_range(float u, int lo, int hi) {
  const int span = hi - lo;
  const int k = (int)floorf(fmul(u, (float)span));
  return lo + (k < span - 1 ? k : span - 1);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Boxes {
  float* out;
  int n;
  __device__ void emit(float x0, float y0, float x1, float y1) {
    const int i = n < kBoxes - 1 ? n : kBoxes - 1;
    out[4 * i] = fminf(x0, x1);
    out[4 * i + 1] = fminf(y0, y1);
    out[4 * i + 2] = fmaxf(x0, x1);
    out[4 * i + 3] = fmaxf(y0, y1);
    ++n;
  }
};

__global__ void walker_terrain_kernel(
    const float* __restrict__ params, const int* __restrict__ seeds,
    const float* __restrict__ consts, float* __restrict__ xs,
    float* __restrict__ ys, float* __restrict__ boxes,
    int* __restrict__ n_boxes, float* __restrict__ pos,
    float* __restrict__ angle, float* __restrict__ vel,
    float* __restrict__ angvel, int n) {
  const int lv = blockIdx.x * blockDim.x + threadIdx.x;
  if (lv >= n) return;
  float T[T_COUNT];
  for (int k = 0; k < T_COUNT; ++k) T[k] = consts[k];
  const float STEP = T[T_STEP], STEP4 = T[T_STEP4];
  const float* p = params + 8 * lv;
  const uint32_t seed = (uint32_t)seeds[lv];
  const float roughness = p[0];
  const float pit_lo = fminf(p[1], p[2]), pit_hi = fmaxf(p[1], p[2]);
  const float stump_lo = fminf(p[3], p[4]), stump_hi = fmaxf(p[3], p[4]);
  const float stair_lo = fminf(p[5], p[6]), stair_hi = fmaxf(p[5], p[6]);
  const int stair_steps_max = (int)rintf(p[7]);   // half to even
  const bool feat_on[3] = {stump_hi >= 0.2f, stair_hi >= 0.2f, pit_hi >= 0.8f};
  const int feat_id[3] = {kStump, kStairs, kPit};
  const int n_on = (int)feat_on[0] + (int)feat_on[1] + (int)feat_on[2];
  const bool hardcore = n_on > 0;

  float* bx = boxes + (size_t)lv * kBoxes * 4;
  for (int k = 0; k < kBoxes * 4; ++k) bx[k] = 0.0f;
  Boxes out{bx, 0};
  int state = kGrass, counter = 20, st_steps = 0;
  bool oneshot = false;
  float velocity = 0.0f, y = T[T_HEIGHT], original_y = 0.0f, pit_diff = 0.0f;
  float st_h = 0.0f, st_slope = 1.0f;

  for (int col = 0; col < kLen; ++col) {
    const float x = fmul((float)col, STEP);

    // GRASS
    const bool is_grass = state == kGrass && !oneshot;
    const float dh = fsub(T[T_HEIGHT], y);
    const float sgn = dh > 0.0f ? 1.0f : (dh < 0.0f ? -1.0f : 0.0f);
    float v_new = fadd(fmul(T[T_VEL_DECAY], velocity), fmul(T[T_VEL_PULL], sgn));
    if (col > 20) {
      v_new = fadd(v_new, fmul(uniform_range(hash_uniform(seed, col, 0), -1.0f, 1.0f),
                               T[T_RSCALE]));
    }
    if (is_grass) {
      velocity = v_new;
      y = fadd(y, fmul(roughness, velocity));
    }

    // PIT oneshot
    if (state == kPit && oneshot) {
      const float pit_gap = fadd(1.0f, uniform_range(hash_uniform(seed, col, 1), pit_lo, pit_hi));
      const int new_counter = (int)ceilf(pit_gap);
      out.emit(x, fsub(y, STEP4), fadd(x, STEP), y);
      out.emit(fadd(x, fmul(STEP, pit_gap)), fsub(y, STEP4),
               fadd(x, fmul(STEP, fadd(1.0f, pit_gap))), y);
      counter = new_counter + 2;
      pit_diff = fsub((float)new_counter, pit_gap);
      original_y = y;
    }

    // PIT continue
    float x_shift = 0.0f;
    if (state == kPit && !oneshot) {
      y = counter > 1 ? fsub(original_y, STEP4) : original_y;
      if (counter == 1) {
        x_shift = fmul(-pit_diff, STEP);
        pit_diff = 0.0f;
      }
    }

    // STUMP oneshot
    if (state == kStump && oneshot) {
      const float h = uniform_range(hash_uniform(seed, col, 2), stump_lo, stump_hi);
      out.emit(x, fadd(y, 0.0f), fadd(x, STEP), fadd(y, fmul(fadd(h, 0.0f), STEP)));
    }

    // STAIRS oneshot
    if (state == kStairs && oneshot) {
      const float sh = uniform_range(hash_uniform(seed, col, 3), stair_lo, stair_hi);
      const float slope = hash_uniform(seed, col, 4) > 0.5f ? 1.0f : -1.0f;
      const int ss = randint_range(hash_uniform(seed, col, 5), 0,
                                   stair_steps_max > 1 ? stair_steps_max : 1);
      if (sh > 0.01f) {
        for (int s = 0; s < ss && s < 9; ++s) {
          const float y_top = fadd(y, fmul(fmul(fmul((float)s, sh), slope), STEP));
          out.emit(fadd(x, T[T_STAIR_X + s]), fsub(y_top, fmul(sh, STEP)),
                   fadd(x, T[T_STAIR_X + s + 1]), y_top);
        }
        counter = ss * 4 + 1;
      }
      st_h = sh;
      st_slope = slope;
      st_steps = ss;
      original_y = y;
    }

    // STAIRS continue
    if (state == kStairs && !oneshot) {
      const int n_step = floordiv(st_steps * 4 - counter, 4);
      y = fsub(fadd(original_y, fmul(fmul(fmul((float)n_step, st_h), st_slope), STEP)),
               fmul(st_slope < 0.0f ? st_h : 0.0f, STEP));
    }

    // emit the column, advance counter and state
    ys[(size_t)lv * kLen + col] = y;
    xs[(size_t)lv * kLen + col] = fadd(x, x_shift);
    counter -= 1;
    const int next_counter = randint_range(hash_uniform(seed, col, 6), 5, 10);
    if (counter == 0) {
      int feature = kGrass;
      if (hardcore) {
        int k = (int)floorf(fmul(hash_uniform(seed, col, 7), (float)n_on));
        if (k > n_on - 1) k = n_on - 1;
        for (int f = 0, seen = 0; f < 3; ++f) {
          if (feat_on[f]) {
            if (seen == k) { feature = feat_id[f]; break; }
            ++seen;
          }
        }
      }
      state = (state == kGrass && hardcore) ? feature : kGrass;
      counter = next_counter;
      oneshot = true;
    } else {
      oneshot = false;
    }
    if (out.n > kBoxes) out.n = kBoxes;
  }
  n_boxes[lv] = out.n;

  // placement: fixed poses, the hull pushed by U(-5, 5) for one step
  const float push = T[T_PUSH];
  const float u = hash_uniform(seed, kLen, 0);
  const float fx = fmaxf(-push, fadd(fmul(u, fsub(push, -push)), -push));
  for (int k = 0; k < 10; ++k) {
    pos[(size_t)lv * 10 + k] = T[T_POS + k];
    vel[(size_t)lv * 10 + k] = 0.0f;
  }
  vel[(size_t)lv * 10] = fmul(fx, T[T_PUSH_DV]);   // fx / mass * dt
  for (int k = 0; k < 5; ++k) {
    angle[(size_t)lv * 5 + k] = T[T_ANGLE + k];
    angvel[(size_t)lv * 5 + k] = 0.0f;
  }
}

}  // namespace

extern "C" int dcd_walker_terrain_consts_count() { return T_COUNT; }

extern "C" int dcd_walker_terrain(const void* params, const void* seeds,
                                  const void* consts, void* xs, void* ys,
                                  void* boxes, void* n_boxes, void* pos,
                                  void* angle, void* vel, void* angvel, int n,
                                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  walker_terrain_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)params, (const int*)seeds, (const float*)consts,
      (float*)xs, (float*)ys, (float*)boxes, (int*)n_boxes, (float*)pos,
      (float*)angle, (float*)vel, (float*)angvel, n);
  return (int)cudaGetLastError();
}
