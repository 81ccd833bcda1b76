// Kernel B13a: one control step of N CarRacing cars — the action repeated
// for 8 physics substeps, each with the wheels' road test, the car's
// friction-circle dynamics, the tile visits and their rewards, the
// shaping, the early-termination ring and the done latch; then the
// TimeLimit.  The frame of the new state is kernel B12's.
//
// Replaces dcd_isaac_tpu/envs/carracing/env.py:step (:186-309) with its
// inner scan, dynamics.py:car_step (:109-177) and wheel_positions,
// _visit_tiles and _goal_eval (env.py:108-139).  Its plain twin is
// envs/carracing/env.py:step_dynamics_plain.
//
// Design: one warp (a block of 32 threads) per car.  The track (480
// points with |p|^2 and the valid flags) and the visited tiles are in
// shared memory.  Every lane carries the car's state and computes the
// same substep (the same inputs give the same bits); only the nearest-
// point searches are split across lanes (15 points a lane, then a
// butterfly on (d2, index) that keeps the first index on a tie), and
// only lane 0 writes.  The wheels' road flags of a substep are those its
// predecessor found for the same car.  The ring's mean is the twin's
// tree_sum over 128 slots (zero padded): halves added pairwise, the last
// five levels by shuffles.  Every float operation is rounded on its own
// (__fadd_rn, __fmul_rn, ...) in the twin's order, a division by a
// constant is a product with its float32 reciprocal, and the constants
// come in as a float32 table that the wrapper builds with the twin's
// arithmetic (kernels/carracing_step.py: CONSTS).
//
// Bound on the H100: a car reads and writes about 9 kB (the track 5.8 kB,
// the visited flags, the ring); at N = 16 that is nanoseconds of
// bandwidth, and the kernel is bound by its 8 dependent substeps of
// searches and shuffles, not by bytes or flops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 480;
constexpr int kHist = 100;

// Offsets into the constant table (kernels/carracing_step.py: CONSTS).
constexpr int C_WX = 0, C_WY = 4, C_FRONT = 8, C_REAR = 12, C_GAS = 16,
              C_RMOM = 17, C_RMASS = 18, C_RI = 19, C_DT = 20, C_WR = 21,
              C_FC = 22, C_FL = 23, C_GRASS = 24, C_STEER = 25, C_TW = 26,
              C_TSTEP = 27, C_RHIST = 28, C_TINY = 29, C_COUNT = 30;

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
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Car {
  float px, py, angle, vx, vy, w, omega[4], steer, gas, fuel;
};

struct StepArgs {
  // car state
  const float *pos, *angle, *vel, *angvel, *omega, *steer, *gas, *fuel;
  // track
  const float* points;
  const uint8_t* valid;
  const int* n_points;
  // env state
  const uint8_t* visited;
  const int *count;
  const float *reward_total, *prev_reward, *t;
  const int* steps;
  const float* hist;
  const int* ptr;
  const uint8_t* done;
  const int* goal_bin;
  const uint8_t* goal_reached;
  const float* sparse_accum;
  const float* action;
  const float* consts;
  // outputs
  float *o_pos, *o_angle, *o_vel, *o_angvel, *o_omega, *o_steer, *o_gas,
      *o_fuel;
  uint8_t* o_visited;
  int* o_count;
  float *o_reward_total, *o_prev_reward, *o_t;
  int* o_steps;
  float* o_hist;
  int* o_ptr;
  uint8_t* o_done;
  uint8_t* o_goal_reached;
  float* o_sparse_accum;
  float* o_reward;
  uint8_t *o_done_out, *o_truncated;
  int n, repeat, max_inner, flags, goal_bins;
  float playfield, clip, r_goal_bins;
};

constexpr int F_SHAPING = 1, F_SPARSE = 2, F_CLIP = 4;

// The first index of the least d2 of (qx, qy) over the valid points, on
// every lane; the distance sqrt(max(d2, 0)).
__device__ __forceinline__ int nearest(float qx, float qy, const float* px,
                                       const float* py, const float* p2,
                                       const uint8_t* ok, float& dist) {
  const float q2 = fadd(fmul(qx, qx), fmul(qy, qy));
  float best = __int_as_float(0x7f800000);
  int bi = 1 << 30;
  for (int i = threadIdx.x; i < kCap; i += 32) {
    if (!ok[i]) continue;
    const float qp = fadd(fmul(qx, px[i]), fmul(qy, py[i]));
    const float d2 = fsub(fadd(q2, p2[i]), fmul(2.0f, qp));
    if (d2 < best) { best = d2; bi = i; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
  dist = sqrtf(fmaxf(best, 0.0f));
  return bi;
}

__device__ __forceinline__ float sum4(const float* x) {
  return fadd(fadd(fadd(x[0], x[1]), x[2]), x[3]);
}

// The wheels' world offsets WHEELPOS @ R.T.
__device__ __forceinline__ void wheel_offsets(const float* C, float angle,
                                              float* ox, float* oy) {
  const float ca = cos_rn(angle), sa = sin_rn(angle);
  for (int k = 0; k < 4; ++k) {
    ox[k] = fadd(fmul(C[C_WX + k], ca), fmul(C[C_WY + k], -sa));
    oy[k] = fadd(fmul(C[C_WX + k], sa), fmul(C[C_WY + k], ca));
  }
}

// dynamics.py:car_step, the twin's order.
__device__ Car car_step(const float* C, const Car& c, float steer_cmd,
                        float gas_cmd, float brake_cmd, const bool* road) {
  Car o;
  const float dt = C[C_DT];
  gas_cmd = clampf(gas_cmd, 0.0f, 1.0f);
  o.gas = fadd(c.gas, fminf(fsub(gas_cmd, c.gas), 0.1f));
  const float err = fsub(steer_cmd, c.steer);
  const float rate = fmul(signf(err), fminf(fmul(50.0f, fabsf(err)), 3.0f));
  o.steer = clampf(fadd(c.steer, fmul(dt, rate)), -C[C_STEER], C[C_STEER]);

  float ox[4], oy[4];
  wheel_offsets(C, c.angle, ox, oy);
  float rx[4], ry[4], fx[4], fy[4], sx[4], sy[4], vf[4], vs[4], wg[4];
  float om[4];
  for (int k = 0; k < 4; ++k) {
    rx[k] = fsub(fadd(c.px, ox[k]), c.px);
    ry[k] = fsub(fadd(c.py, oy[k]), c.py);
    const float wa = fadd(c.angle, fmul(C[C_FRONT + k], o.steer));
    const float sn = sin_rn(wa), cs = cos_rn(wa);
    fx[k] = -sn;
    fy[k] = cs;
    sx[k] = cs;
    sy[k] = sn;
    const float vx = fadd(c.vx, fmul(c.w, -ry[k]));
    const float vy = fadd(c.vy, fmul(c.w, rx[k]));
    vf[k] = fadd(fmul(fx[k], vx), fmul(fy[k], vy));
    vs[k] = fadd(fmul(sx[k], vx), fmul(sy[k], vy));
    wg[k] = fmul(C[C_REAR + k], o.gas);
    om[k] = fadd(c.omega[k], fdiv(fmul(fmul(C[C_GAS], wg[k]), C[C_RMOM]),
                                  fadd(fabsf(c.omega[k]), 5.0f)));
  }
  o.fuel = fadd(c.fuel, fmul(C[C_GAS], sum4(wg)));
  const float brake = clampf(brake_cmd, 0.0f, 1.0f);
  const bool hard = brake >= 0.9f;
  float Fx[4], Fy[4], tq[4];
  for (int k = 0; k < 4; ++k) {
    const float bdelta = fminf(fmul(15.0f, brake), fabsf(om[k]));
    om[k] = hard ? 0.0f : fsub(om[k], fmul(signf(om[k]), bdelta));
    const float vr = fmul(om[k], C[C_WR]);
    float f = fmul(fadd(-vf[k], vr), C[C_FC]);
    float p = fmul(-vs[k], C[C_FC]);
    const float force = sqrtf(fadd(fmul(f, f), fmul(p, p)));
    const float limit = fmul(C[C_FL], road[k] ? 1.0f : C[C_GRASS]);
    const float scale =
        force > limit ? fdiv(limit, fmaxf(force, C[C_TINY])) : 1.0f;
    f = fmul(f, scale);
    p = fmul(p, scale);
    om[k] = fsub(om[k], fmul(fmul(fmul(dt, f), C[C_WR]), C[C_RMOM]));
    Fx[k] = fadd(fmul(p, sx[k]), fmul(f, fx[k]));
    Fy[k] = fadd(fmul(p, sy[k]), fmul(f, fy[k]));
    tq[k] = fsub(fmul(rx[k], Fy[k]), fmul(ry[k], Fx[k]));
    o.omega[k] = om[k];
  }
  o.vx = fadd(c.vx, fmul(fmul(dt, sum4(Fx)), C[C_RMASS]));
  o.vy = fadd(c.vy, fmul(fmul(dt, sum4(Fy)), C[C_RMASS]));
  o.w = fadd(c.w, fmul(fmul(dt, sum4(tq)), C[C_RI]));
  o.px = fadd(c.px, fmul(dt, o.vx));
  o.py = fadd(c.py, fmul(dt, o.vy));
  o.angle = fadd(c.angle, fmul(dt, o.w));
  return o;
}

__global__ void __launch_bounds__(32) carracing_step_kernel(StepArgs a) {
  const int e = blockIdx.x;
  const int lane = threadIdx.x;
  const float* C = a.consts;
  __shared__ float px[kCap], py[kCap], p2[kCap];
  __shared__ uint8_t ok[kCap], vis[kCap];
  __shared__ float hist[kHist];
  int nvis = 0;
  for (int i = lane; i < kCap; i += 32) {
    const float x = a.points[((size_t)e * kCap + i) * 2];
    const float y = a.points[((size_t)e * kCap + i) * 2 + 1];
    px[i] = x;
    py[i] = y;
    p2[i] = fadd(fmul(x, x), fmul(y, y));
    ok[i] = a.valid[(size_t)e * kCap + i];
    vis[i] = a.visited[(size_t)e * kCap + i];
    nvis += vis[i] != 0;
  }
  for (int o = 16; o > 0; o >>= 1) nvis += __shfl_xor_sync(0xffffffffu, nvis, o);
  for (int i = lane; i < kHist; i += 32) hist[i] = a.hist[(size_t)e * kHist + i];
  __syncwarp();

  Car car;
  car.px = a.pos[2 * e];
  car.py = a.pos[2 * e + 1];
  car.angle = a.angle[e];
  car.vx = a.vel[2 * e];
  car.vy = a.vel[2 * e + 1];
  car.w = a.angvel[e];
  for (int k = 0; k < 4; ++k) car.omega[k] = a.omega[4 * e + k];
  car.steer = a.steer[e];
  car.gas = a.gas[e];
  car.fuel = a.fuel[e];
  int count = a.count[e], steps = a.steps[e], ptr = a.ptr[e];
  float reward_total = a.reward_total[e], prev = a.prev_reward[e];
  float t = a.t[e], sparse_accum = a.sparse_accum[e];
  bool done = a.done[e] != 0, goal_reached = a.goal_reached[e] != 0;
  const int goal_bin = a.goal_bin[e];
  const int n_pts = a.n_points[e];
  const float steer_cmd = -a.action[3 * e];
  const float gas_cmd = a.action[3 * e + 1];
  const float brake_cmd = a.action[3 * e + 2];
  const float n_track = (float)(n_pts < 1 ? 1 : n_pts);
  const float tile_reward = fdiv(1000.0f, n_track);
  const float tw = C[C_TW];

  bool road[4];
  {
    float ox[4], oy[4], d;
    wheel_offsets(C, car.angle, ox, oy);
    for (int k = 0; k < 4; ++k) {
      nearest(fadd(car.px, ox[k]), fadd(car.py, oy[k]), px, py, p2, ok, d);
      road[k] = d <= tw;
    }
  }
  float shaped_sum = 0.0f;
  for (int sub = 0; sub < a.repeat; ++sub) {
    const Car c2 = car_step(C, car, steer_cmd, gas_cmd, brake_cmd, road);
    // the tile visits of the new wheel positions
    float ox[4], oy[4];
    wheel_offsets(C, c2.angle, ox, oy);
    int idx[4];
    bool road2[4];
    for (int k = 0; k < 4; ++k) {
      float d;
      idx[k] = nearest(fadd(c2.px, ox[k]), fadd(c2.py, oy[k]), px, py, p2,
                       ok, d);
      road2[k] = d <= tw;
    }
    int n_new = 0;
    int news[4];
    for (int k = 0; k < 4; ++k) {
      if (!road2[k] || vis[idx[k]]) continue;
      bool seen = false;
      for (int m = 0; m < n_new; ++m) seen = seen || news[m] == idx[k];
      if (!seen) news[n_new++] = idx[k];
    }
    const float t2 = fadd(t, C[C_TSTEP]);
    const float rt2 = fadd(fsub(reward_total, 0.1f),
                           fmul(tile_reward, (float)n_new));
    float step_reward = fsub(rt2, prev);
    const bool all_visited = nvis + n_new >= n_pts;
    const bool off_field = fabsf(c2.px) > a.playfield ||
                           fabsf(c2.py) > a.playfield;
    bool die = all_visited || off_field;
    if (off_field) step_reward = -100.0f;
    bool goal2 = goal_reached;
    float accum2 = sparse_accum;
    if (a.flags & F_SPARSE) {
      bool reached = false;
      const float nf = (float)n_pts;
      const float goal_step = fmul(nf, a.r_goal_bins);
      for (int m = 0; m < n_new; ++m) {
        const float fi = (float)news[m];
        const float distance = fsub(nf, fi);
        const float tile_bin = floorf(fdiv(distance, fmaxf(goal_step, 1e-6f)));
        const bool force_false =
            (goal_bin == 0 && distance < 10.0f) ||
            (goal_bin == a.goal_bins - 1 && fi < 10.0f);
        reached = reached || (tile_bin == (float)goal_bin && !force_false &&
                              ok[news[m]]);
      }
      goal2 = goal_reached || reached;
      accum2 = fadd(sparse_accum, step_reward);
      step_reward = goal2 ? accum2 : 0.0f;
      accum2 = goal2 ? 0.0f : accum2;
      die = die || goal2;
    }
    if (a.flags & F_CLIP) step_reward = clampf(step_reward, -a.clip, a.clip);
    float shaped = step_reward;
    if (a.flags & F_SHAPING) {
      shaped = fadd(shaped, die && !off_field ? 100.0f : 0.0f);
      float d;
      nearest(c2.px, c2.py, px, py, p2, ok, d);
      shaped = fsub(shaped, d <= tw ? 0.0f : 0.05f);
    }
    bool early = false;
    int ptr2 = ptr;
    if (a.flags & F_SHAPING) {
      if (!done) {
        __syncwarp();
        if (lane == 0) hist[ptr % kHist] = shaped;
        ptr2 = ptr + 1;
      }
      __syncwarp();
      const float x0 = hist[lane], x1 = hist[lane + 32], x2 = hist[lane + 64];
      const float x3 = lane + 96 < kHist ? hist[lane + 96] : 0.0f;
      float v = fadd(fadd(x0, x2), fadd(x1, x3));
      for (int h = 16; h > 0; h >>= 1) v = fadd(v, __shfl_down_sync(0xffffffffu, v, h));
      v = __shfl_sync(0xffffffffu, v, 0);
      early = fmul(v, C[C_RHIST]) <= -0.1f;
    }
    const bool new_done = done || die || early;
    if (!done) {
      car = c2;
      for (int k = 0; k < 4; ++k) road[k] = road2[k];
      __syncwarp();
      if (lane == 0)
        for (int m = 0; m < n_new; ++m) vis[news[m]] = 1;
      __syncwarp();
      nvis += n_new;
      reward_total = rt2;
      prev = rt2;
      t = t2;
      steps += 1;
      goal_reached = goal2;
      sparse_accum = accum2;
      count += n_new;
    } else {
      shaped = 0.0f;
    }
    ptr = ptr2;
    done = new_done;
    shaped_sum = sub == 0 ? shaped : fadd(shaped_sum, shaped);
  }
  const bool timeout = steps >= a.max_inner;

  __syncwarp();
  for (int i = lane; i < kCap; i += 32) a.o_visited[(size_t)e * kCap + i] = vis[i];
  for (int i = lane; i < kHist; i += 32) a.o_hist[(size_t)e * kHist + i] = hist[i];
  if (lane == 0) {
    a.o_pos[2 * e] = car.px;
    a.o_pos[2 * e + 1] = car.py;
    a.o_angle[e] = car.angle;
    a.o_vel[2 * e] = car.vx;
    a.o_vel[2 * e + 1] = car.vy;
    a.o_angvel[e] = car.w;
    for (int k = 0; k < 4; ++k) a.o_omega[4 * e + k] = car.omega[k];
    a.o_steer[e] = car.steer;
    a.o_gas[e] = car.gas;
    a.o_fuel[e] = car.fuel;
    a.o_count[e] = count;
    a.o_reward_total[e] = reward_total;
    a.o_prev_reward[e] = prev;
    a.o_t[e] = t;
    a.o_steps[e] = steps;
    a.o_ptr[e] = ptr;
    a.o_done[e] = done;
    a.o_goal_reached[e] = goal_reached;
    a.o_sparse_accum[e] = sparse_accum;
    a.o_reward[e] = shaped_sum;
    a.o_done_out[e] = done || timeout;
    a.o_truncated[e] = timeout && !done;
  }
}

}  // namespace

extern "C" int dcd_carracing_step_consts_count() { return C_COUNT; }

extern "C" int dcd_carracing_step(
    const void* pos, const void* angle, const void* vel, const void* angvel,
    const void* omega, const void* steer, const void* gas, const void* fuel,
    const void* points, const void* valid, const void* n_points,
    const void* visited, const void* count, const void* reward_total,
    const void* prev_reward, const void* t, const void* steps,
    const void* hist, const void* ptr, const void* done,
    const void* goal_bin, const void* goal_reached,
    const void* sparse_accum, const void* action, const void* consts,
    void* o_pos, void* o_angle, void* o_vel, void* o_angvel, void* o_omega,
    void* o_steer, void* o_gas, void* o_fuel, void* o_visited,
    void* o_count, void* o_reward_total, void* o_prev_reward, void* o_t,
    void* o_steps, void* o_hist, void* o_ptr, void* o_done,
    void* o_goal_reached, void* o_sparse_accum, void* o_reward,
    void* o_done_out, void* o_truncated, int n, int repeat, int max_inner,
    int flags, int goal_bins, float playfield, float clip,
    float r_goal_bins, void* stream) {
  if (n <= 0 || repeat <= 0) return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.pos = (const float*)pos;
  a.angle = (const float*)angle;
  a.vel = (const float*)vel;
  a.angvel = (const float*)angvel;
  a.omega = (const float*)omega;
  a.steer = (const float*)steer;
  a.gas = (const float*)gas;
  a.fuel = (const float*)fuel;
  a.points = (const float*)points;
  a.valid = (const uint8_t*)valid;
  a.n_points = (const int*)n_points;
  a.visited = (const uint8_t*)visited;
  a.count = (const int*)count;
  a.reward_total = (const float*)reward_total;
  a.prev_reward = (const float*)prev_reward;
  a.t = (const float*)t;
  a.steps = (const int*)steps;
  a.hist = (const float*)hist;
  a.ptr = (const int*)ptr;
  a.done = (const uint8_t*)done;
  a.goal_bin = (const int*)goal_bin;
  a.goal_reached = (const uint8_t*)goal_reached;
  a.sparse_accum = (const float*)sparse_accum;
  a.action = (const float*)action;
  a.consts = (const float*)consts;
  a.o_pos = (float*)o_pos;
  a.o_angle = (float*)o_angle;
  a.o_vel = (float*)o_vel;
  a.o_angvel = (float*)o_angvel;
  a.o_omega = (float*)o_omega;
  a.o_steer = (float*)o_steer;
  a.o_gas = (float*)o_gas;
  a.o_fuel = (float*)o_fuel;
  a.o_visited = (uint8_t*)o_visited;
  a.o_count = (int*)o_count;
  a.o_reward_total = (float*)o_reward_total;
  a.o_prev_reward = (float*)o_prev_reward;
  a.o_t = (float*)o_t;
  a.o_steps = (int*)o_steps;
  a.o_hist = (float*)o_hist;
  a.o_ptr = (int*)o_ptr;
  a.o_done = (uint8_t*)o_done;
  a.o_goal_reached = (uint8_t*)o_goal_reached;
  a.o_sparse_accum = (float*)o_sparse_accum;
  a.o_reward = (float*)o_reward;
  a.o_done_out = (uint8_t*)o_done_out;
  a.o_truncated = (uint8_t*)o_truncated;
  a.n = n;
  a.repeat = repeat;
  a.max_inner = max_inner;
  a.flags = flags;
  a.goal_bins = goal_bins;
  a.playfield = playfield;
  a.clip = clip;
  a.r_goal_bins = r_goal_bins;
  carracing_step_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
