// Kernel B10: one step of N BipedalWalkers — the action's motor mapping,
// the physics step, the shaping reward and termination, and the 24-d
// observation with its 10-ray lidar.
//
// Replaces dcd_isaac_tpu/envs/walker/env.py:step_walker (:132-168) with
// physics.py's _contact_candidates (:201-245), physics_step (:247-404) and
// lidar (:407-449), and gen_walker_obs (env.py:61-86).  With `first` set it
// is the zero-action step of _reset_with_terrain (env.py:111-129): the
// step count stays and the reward is 0.
//
// Design: one warp (a block of 32 threads) per walker.  The terrain (200
// heightfield points and 64 boxes) and the bodies sit in shared memory.
// Lane c < 25 owns contact candidate c (vertex c % 5 of body c / 5): it
// finds the heightfield and box contact, and in each of the 40 velocity
// sweeps its normal and friction impulses (Jacobi); lane b < 5 then sums
// its body's five candidates' impulses in vertex order (JAX's segment_sum
// order) and adds them.  Lane 0 runs the four joints (motor, limit and the
// 2x2 point-to-point solve) in the JAX package's order: every joint's
// impulse from the same velocities, then the scatter-adds joint by joint.
// The lidar spreads the 199 segments and 64 boxes over the lanes and takes
// each ray's minimum with shuffles (a min is exact in any order).
//
// Every float operation is rounded on its own (__fadd_rn, __fmul_rn, ...;
// nvcc would otherwise contract a*b+c into an FMA) in the order of the
// plain twin, envs/walker/physics.py, so the two differ only where cosf
// and sinf differ from the twin's cos and sin.  A division by a constant
// is a product with its float32 reciprocal, as XLA compiles the JAX
// package.  The constants come in as a float32 table that the wrapper
// builds with the twin's own arithmetic (kernels/walker_step.py: CONSTS).
//
// Bound on the H100: a step reads the terrain (2.6 kB) and state and writes
// ~0.3 kB a walker: at N = 16 that is nanoseconds of bandwidth; the
// kernel is bound by its dependent chain — 40 sweeps of lane 0's joints
// and the contact lanes' barriers — not by bytes or flops.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLen = 200;      // heightfield points
constexpr int kBoxes = 64;
constexpr int kIters = 40;
constexpr int kRays = 10;

// Offsets into the constant table (kernels/walker_step.py: CONSTS).
constexpr int C_INV_M = 0, C_INV_I = 5, C_VERTS = 10, C_MU = 60,
              C_ANC_A = 65, C_ANC_B = 73, C_LOWER = 81, C_UPPER = 85,
              C_REF = 89, C_SPEED = 93, C_HULL_C = 97, C_LIDAR = 99,
              C_GRAV = 119, C_BOX_N = 121, C_BAUM = 129, C_SLOP = 130,
              C_DT = 131, C_TORQUE = 132, C_COST = 133, C_SHAPE = 134,
              C_RSCALE = 135, C_ANGLE_W = 136, C_FINISH = 137, C_OBS_W = 138,
              C_OBS_VX = 139, C_OBS_VY = 140, C_RFPS = 141, C_RSPEED = 142,
              C_COUNT = 146;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < 1e-9f ? 1e-9f : x;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ const int kJa[4] = {0, 1, 0, 3};
__device__ const int kJb[4] = {1, 2, 3, 4};

struct StepArgs {
  const float *pos, *angle, *vel, *angvel;          // (N,5,2) (N,5) ...
  const float *xs, *ys, *boxes;                     // (N,200) (N,200) (N,64,4)
  const int *n_boxes;                               // (N,)
  const float *prev_shaping;                        // (N,)
  const uint8_t *game_over;                         // (N,) bool
  const int *step_count;                            // (N,)
  const float *action;                              // (N,4)
  const float *consts;
  float *o_pos, *o_angle, *o_vel, *o_angvel;
  uint8_t *o_lower;                                 // (N,2) bool
  float *o_jangle, *o_jspeed;                       // (N,4)
  uint8_t *o_game_over;
  int *o_step_count;
  float *o_prev_shaping, *o_obs, *o_reward;         // (N,) (N,24) (N,)
  uint8_t *o_done, *o_finish;
  int n, first;
};

__global__ void __launch_bounds__(32) walker_step_kernel(StepArgs a) {
  const int w = blockIdx.x, lane = threadIdx.x;
  if (w >= a.n) return;
  __shared__ float C[C_COUNT];
  __shared__ float xs[kLen], ys[kLen], box[kBoxes * 4];
  __shared__ float pos[10], ang[5], vel[10], av[5], cs[5], sn[5];
  __shared__ float sa[25], sb[25], sd[25], act[4];
  __shared__ int nbox, touch[25], cnt[25];

  for (int i = lane; i < C_COUNT; i += 32) C[i] = a.consts[i];
  for (int i = lane; i < kLen; i += 32) {
    xs[i] = a.xs[w * kLen + i];
    ys[i] = a.ys[w * kLen + i];
  }
  for (int i = lane; i < kBoxes * 4; i += 32) box[i] = a.boxes[w * kBoxes * 4 + i];
  if (lane < 10) {
    pos[lane] = a.pos[w * 10 + lane];
    vel[lane] = a.vel[w * 10 + lane];
  }
  if (lane < 5) {
    ang[lane] = a.angle[w * 5 + lane];
    av[lane] = a.angvel[w * 5 + lane];
  }
  if (lane < 4) act[lane] = a.action[w * 4 + lane];
  if (lane == 0) nbox = a.n_boxes[w];
  __syncwarp();
  if (lane < 5) {
    cs[lane] = cosf(ang[lane]);
    sn[lane] = sinf(ang[lane]);
  }
  __syncwarp();

  // --- contact generation: lane c < 25 owns candidate c --------------------
  const int c = lane < 25 ? lane : 24;
  const int b = c / 5, v = c % 5;
  const bool vvalid = lane < 25 && (v < (b == 0 ? 5 : 4));
  const float vx = C[C_VERTS + 10 * b + 2 * v], vy = C[C_VERTS + 10 * b + 2 * v + 1];
  const float px = fadd(pos[2 * b], fadd(fmul(cs[b], vx), fmul(-sn[b], vy)));
  const float py = fadd(pos[2 * b + 1], fadd(fmul(sn[b], vx), fmul(cs[b], vy)));
  // heightfield: searchsorted(xs, px, right) - 1, clipped
  int count = 0;
  for (int j = 0; j < kLen; ++j) count += xs[j] <= px;
  int idx = count - 1;
  idx = idx < 0 ? 0 : (idx > kLen - 2 ? kLen - 2 : idx);
  const float x0 = xs[idx], x1 = xs[idx + 1], y0 = ys[idx], y1 = ys[idx + 1];
  const float t = clampf(fdiv(fsub(px, x0), fmaxf(fsub(x1, x0), 1e-8f)), 0.0f, 1.0f);
  const float gy = fadd(y0, fmul(t, fsub(y1, y0)));
  const float hnx = -fsub(y1, y0), hny = fsub(x1, x0);
  const float norm = fmaxf(__fsqrt_rn(fadd(fmul(hnx, hnx), fmul(hny, hny))), 1e-8f);
  const float gnx = fdiv(hnx, norm), gny = fdiv(hny, norm);
  const float pen_h = vvalid ? fmul(fsub(gy, py), gny) : -1.0f;
  // boxes: the deepest box, its least-overlap axis
  float pen_box = 0.0f;
  int best_axis = 0;
  for (int m = 0; m < kBoxes; ++m) {
    const float* bx = box + 4 * m;
    const float d[4] = {fsub(px, bx[0]), fsub(bx[2], px), fsub(py, bx[1]), fsub(bx[3], py)};
    int axis = 0;
    float dmin = d[0];
    for (int k = 1; k < 4; ++k) {
      if (d[k] < dmin) { dmin = d[k]; axis = k; }
    }
    const bool inside = d[0] > 0.0f && d[1] > 0.0f && d[2] > 0.0f && d[3] > 0.0f &&
                        m < nbox && vvalid;
    const float pen_b = inside ? dmin : -1.0f;
    if (m == 0 || pen_b > pen_box) { pen_box = pen_b; best_axis = axis; }
  }
  const bool use_box = pen_box > pen_h;
  const float pen = use_box ? pen_box : pen_h;
  const float nx = use_box ? C[C_BOX_N + 2 * best_axis] : gnx;
  const float ny = use_box ? C[C_BOX_N + 2 * best_axis + 1] : gny;
  const bool active = lane < 25 && pen > 0.0f;
  if (lane < 25) cnt[lane] = active ? 1 : 0;
  __syncwarp();
  float split = 0.0f;
  for (int k = 0; k < 5; ++k) split = fadd(split, (float)cnt[5 * b + k]);
  split = fmaxf(split, 1.0f);
  const float inv_m = C[C_INV_M + b], inv_i = C[C_INV_I + b], mu = C[C_MU + b];
  const float rx = fsub(px, pos[2 * b]), ry = fsub(py, pos[2 * b + 1]);
  const float rxn = fsub(fmul(rx, ny), fmul(ry, nx));
  const float k_n = fmaxf(fmul(fadd(inv_m, fmul(inv_i, fmul(rxn, rxn))), split), 1e-9f);
  const float tx = -ny, ty = nx;
  const float rxt = fsub(fmul(rx, ty), fmul(ry, tx));
  const float k_t = fmaxf(fmul(fadd(inv_m, fmul(inv_i, fmul(rxt, rxt))), split), 1e-9f);
  const float bias = fminf(fmul(C[C_BAUM], fmaxf(fsub(pen, C[C_SLOP]), 0.0f)), 2.0f);

  // --- joints: precomputed by lane 0, in registers -------------------------
  float rax[4], ray[4], rbx[4], rby[4], lbias[4], risum[4], mmax[4], mspeed[4];
  float k11[4], k12[4], k22[4], det[4], acc_m[4];
  bool lo_[4], hi_[4];
  if (lane == 0) {
    for (int j = 0; j < 4; ++j) {
      const int ja = kJa[j], jb = kJb[j];
      const float aax = C[C_ANC_A + 2 * j], aay = C[C_ANC_A + 2 * j + 1];
      const float abx = C[C_ANC_B + 2 * j], aby = C[C_ANC_B + 2 * j + 1];
      rax[j] = fadd(fmul(cs[ja], aax), fmul(-sn[ja], aay));
      ray[j] = fadd(fmul(sn[ja], aax), fmul(cs[ja], aay));
      rbx[j] = fadd(fmul(cs[jb], abx), fmul(-sn[jb], aby));
      rby[j] = fadd(fmul(sn[jb], abx), fmul(cs[jb], aby));
      const float jang = fsub(fsub(ang[jb], ang[ja]), C[C_REF + j]);
      const float lower = C[C_LOWER + j], upper = C[C_UPPER + j];
      lo_[j] = jang <= lower;
      hi_[j] = jang >= upper;
      lbias[j] = fmul(C[C_BAUM], fadd(lo_[j] ? fsub(jang, lower) : 0.0f,
                                      hi_[j] ? fsub(jang, upper) : 0.0f));
      const float ia = C[C_INV_I + ja], ib = C[C_INV_I + jb];
      const float ma = C[C_INV_M + ja], mb = C[C_INV_M + jb];
      risum[j] = fdiv(1.0f, fmaxf(fadd(ia, ib), 1e-9f));
      const float aj = act[j];
      const float sgn = aj > 0.0f ? 1.0f : (aj < 0.0f ? -1.0f : 0.0f);
      mspeed[j] = fmul(sgn, C[C_SPEED + j]);
      mmax[j] = fmul(fmul(C[C_TORQUE], clampf(fabsf(aj), 0.0f, 1.0f)), C[C_DT]);
      const float msum = fadd(ma, mb);
      k11[j] = fadd(fadd(msum, fmul(ia, fmul(ray[j], ray[j]))), fmul(ib, fmul(rby[j], rby[j])));
      k12[j] = fsub(fmul(fmul(-ia, rax[j]), ray[j]), fmul(fmul(ib, rbx[j]), rby[j]));
      k22[j] = fadd(fadd(msum, fmul(ia, fmul(rax[j], rax[j]))), fmul(ib, fmul(rbx[j], rbx[j])));
      det[j] = fmaxf(fsub(fmul(k11[j], k22[j]), fmul(k12[j], k12[j])), 1e-9f);
      acc_m[j] = 0.0f;
    }
    vel[0] = fadd(vel[0], C[C_GRAV]);  // gravity * dt, all bodies
    vel[1] = fadd(vel[1], C[C_GRAV + 1]);
    for (int k = 1; k < 5; ++k) {
      vel[2 * k] = fadd(vel[2 * k], C[C_GRAV]);
      vel[2 * k + 1] = fadd(vel[2 * k + 1], C[C_GRAV + 1]);
    }
  }
  __syncwarp();

  float acc_n = 0.0f, acc_t = 0.0f;
  for (int it = 0; it < kIters; ++it) {
    if (lane == 0) {
      float imp[4];
      // motor
      for (int j = 0; j < 4; ++j) {
        const float wrel = fsub(av[kJb[j]], av[kJa[j]]);
        const float m = fmul(-fsub(wrel, mspeed[j]), risum[j]);
        const float na = fminf(fmaxf(fadd(acc_m[j], m), -mmax[j]), mmax[j]);
        imp[j] = fsub(na, acc_m[j]);
        acc_m[j] = na;
      }
      for (int j = 0; j < 4; ++j) av[kJa[j]] = fadd(av[kJa[j]], fmul(-C[C_INV_I + kJa[j]], imp[j]));
      for (int j = 0; j < 4; ++j) av[kJb[j]] = fadd(av[kJb[j]], fmul(C[C_INV_I + kJb[j]], imp[j]));
      // limits
      for (int j = 0; j < 4; ++j) {
        const float wrel = fsub(av[kJb[j]], av[kJa[j]]);
        const float l = fmul(-fadd(wrel, lbias[j]), risum[j]);
        imp[j] = lo_[j] ? fmaxf(l, 0.0f) : (hi_[j] ? fminf(l, 0.0f) : 0.0f);
      }
      for (int j = 0; j < 4; ++j) av[kJa[j]] = fadd(av[kJa[j]], fmul(-C[C_INV_I + kJa[j]], imp[j]));
      for (int j = 0; j < 4; ++j) av[kJb[j]] = fadd(av[kJb[j]], fmul(C[C_INV_I + kJb[j]], imp[j]));
      // point-to-point
      float Px[4], Py[4];
      for (int j = 0; j < 4; ++j) {
        const int ja = kJa[j], jb = kJb[j];
        const float cax = fmul(-av[ja], ray[j]), cay = fmul(av[ja], rax[j]);
        const float cbx = fmul(-av[jb], rby[j]), cby = fmul(av[jb], rbx[j]);
        const float cdx = fsub(fadd(vel[2 * jb], cbx), fadd(vel[2 * ja], cax));
        const float cdy = fsub(fadd(vel[2 * jb + 1], cby), fadd(vel[2 * ja + 1], cay));
        Px[j] = fdiv(-fsub(fmul(k22[j], cdx), fmul(k12[j], cdy)), det[j]);
        Py[j] = fdiv(-fsub(fmul(k11[j], cdy), fmul(k12[j], cdx)), det[j]);
      }
      for (int j = 0; j < 4; ++j) {
        const int ja = kJa[j];
        const float m = -C[C_INV_M + ja];
        vel[2 * ja] = fadd(vel[2 * ja], fmul(m, Px[j]));
        vel[2 * ja + 1] = fadd(vel[2 * ja + 1], fmul(m, Py[j]));
      }
      for (int j = 0; j < 4; ++j) {
        const int jb = kJb[j];
        const float m = C[C_INV_M + jb];
        vel[2 * jb] = fadd(vel[2 * jb], fmul(m, Px[j]));
        vel[2 * jb + 1] = fadd(vel[2 * jb + 1], fmul(m, Py[j]));
      }
      for (int j = 0; j < 4; ++j) {
        const int ja = kJa[j];
        av[ja] = fadd(av[ja], fmul(-C[C_INV_I + ja],
                                   fsub(fmul(rax[j], Py[j]), fmul(ray[j], Px[j]))));
      }
      for (int j = 0; j < 4; ++j) {
        const int jb = kJb[j];
        av[jb] = fadd(av[jb], fmul(C[C_INV_I + jb],
                                   fsub(fmul(rbx[j], Py[j]), fmul(rby[j], Px[j]))));
      }
    }
    __syncwarp();

    // normal impulses, Jacobi over the candidates
    if (lane < 25) {
      const float wb = av[b];
      const float vn = fadd(fmul(fadd(vel[2 * b], fmul(-wb, ry)), nx),
                            fmul(fadd(vel[2 * b + 1], fmul(wb, rx)), ny));
      float lam = fdiv(-fsub(vn, bias), k_n);
      const float na = fmaxf(fadd(acc_n, active ? lam : 0.0f), 0.0f);
      lam = fsub(na, acc_n);
      acc_n = na;
      const float ix = fmul(lam, nx), iy = fmul(lam, ny);
      sa[lane] = fmul(ix, inv_m);
      sb[lane] = fmul(iy, inv_m);
      sd[lane] = fmul(fsub(fmul(rx, iy), fmul(ry, ix)), inv_i);
    }
    __syncwarp();
    if (lane < 5) {
      float dx = sa[5 * lane], dy = sb[5 * lane], dw = sd[5 * lane];
      for (int k = 1; k < 5; ++k) {
        dx = fadd(dx, sa[5 * lane + k]);
        dy = fadd(dy, sb[5 * lane + k]);
        dw = fadd(dw, sd[5 * lane + k]);
      }
      vel[2 * lane] = fadd(vel[2 * lane], dx);
      vel[2 * lane + 1] = fadd(vel[2 * lane + 1], dy);
      av[lane] = fadd(av[lane], dw);
    }
    __syncwarp();

    // friction impulses
    if (lane < 25) {
      const float wb = av[b];
      const float vt = fadd(fmul(fadd(vel[2 * b], fmul(-wb, ry)), tx),
                            fmul(fadd(vel[2 * b + 1], fmul(wb, rx)), ty));
      float lam = fdiv(-vt, k_t);
      const float maxf = fmul(mu, acc_n);
      const float na = fminf(fmaxf(fadd(acc_t, active ? lam : 0.0f), -maxf), maxf);
      lam = fsub(na, acc_t);
      acc_t = na;
      const float ix = fmul(lam, tx), iy = fmul(lam, ty);
      sa[lane] = fmul(ix, inv_m);
      sb[lane] = fmul(iy, inv_m);
      sd[lane] = fmul(fsub(fmul(rx, iy), fmul(ry, ix)), inv_i);
    }
    __syncwarp();
    if (lane < 5) {
      float dx = sa[5 * lane], dy = sb[5 * lane], dw = sd[5 * lane];
      for (int k = 1; k < 5; ++k) {
        dx = fadd(dx, sa[5 * lane + k]);
        dy = fadd(dy, sb[5 * lane + k]);
        dw = fadd(dw, sd[5 * lane + k]);
      }
      vel[2 * lane] = fadd(vel[2 * lane], dx);
      vel[2 * lane + 1] = fadd(vel[2 * lane + 1], dy);
      av[lane] = fadd(av[lane], dw);
    }
    __syncwarp();
  }

  // --- integration and contact flags ---------------------------------------
  if (lane < 25) touch[lane] = active && acc_n > 0.0f;
  if (lane < 5) {
    const float dt = C[C_DT];
    pos[2 * lane] = fadd(pos[2 * lane], fmul(vel[2 * lane], dt));
    pos[2 * lane + 1] = fadd(pos[2 * lane + 1], fmul(vel[2 * lane + 1], dt));
    ang[lane] = fadd(ang[lane], fmul(av[lane], dt));
  }
  __syncwarp();
  if (lane < 10) {
    a.o_pos[w * 10 + lane] = pos[lane];
    a.o_vel[w * 10 + lane] = vel[lane];
  }
  if (lane < 5) {
    a.o_angle[w * 5 + lane] = ang[lane];
    a.o_angvel[w * 5 + lane] = av[lane];
  }

  // --- lidar: rays from the hull's centroid -------------------------------
  float frac[kRays];
  const float p0x = pos[0], p0y = pos[1];
  for (int r = 0; r < kRays; ++r) {
    const float d0 = fsub(fadd(p0x, C[C_LIDAR + 2 * r]), p0x);
    const float d1 = fsub(fadd(p0y, C[C_LIDAR + 2 * r + 1]), p0y);
    float f = 1.0f;
    for (int j = lane; j < kLen - 1; j += 32) {
      const float ax = xs[j], ay = ys[j];
      const float ex = fsub(xs[j + 1], ax), ey = fsub(ys[j + 1], ay);
      const float den = fsub(fmul(d0, ey), fmul(d1, ex));
      const float tt = fdiv(fsub(fmul(fsub(ax, p0x), ey), fmul(fsub(ay, p0y), ex)), guard(den));
      const float s = fabsf(ex) > fabsf(ey)
                          ? fdiv(fsub(fadd(p0x, fmul(tt, d0)), ax), guard(ex))
                          : fdiv(fsub(fadd(p0y, fmul(tt, d1)), ay), guard(ey));
      if (tt >= 0.0f && tt <= 1.0f && s >= 0.0f && s <= 1.0f) f = fminf(f, tt);
    }
    const float inv0 = fdiv(1.0f, guard(d0)), inv1 = fdiv(1.0f, guard(d1));
    for (int m = lane; m < kBoxes; m += 32) {
      const float* bx = box + 4 * m;
      const float t0x = fmul(fsub(bx[0], p0x), inv0), t1x = fmul(fsub(bx[2], p0x), inv0);
      const float t0y = fmul(fsub(bx[1], p0y), inv1), t1y = fmul(fsub(bx[3], p0y), inv1);
      const float tmin = fmaxf(fminf(t0x, t1x), fminf(t0y, t1y));
      const float tmax = fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y));
      if (tmax >= tmin && tmax >= 0.0f && tmin <= 1.0f && m < nbox) f = fminf(f, fmaxf(tmin, 0.0f));
    }
    frac[r] = warp_min(f);
  }

  // --- reward, termination and observation (lane 0) -----------------------
  if (lane == 0) {
    const int n = w;
    bool hull_touch = false;
    for (int k = 0; k < 5; ++k) hull_touch = hull_touch || touch[k];
    bool lower_l = false, lower_r = false;
    for (int k = 0; k < 5; ++k) {
      lower_l = lower_l || touch[10 + k];
      lower_r = lower_r || touch[20 + k];
    }
    float jang[4], jspd[4];
    for (int j = 0; j < 4; ++j) {
      jang[j] = fsub(fsub(ang[kJb[j]], ang[kJa[j]]), C[C_REF + j]);
      jspd[j] = fsub(av[kJb[j]], av[kJa[j]]);
      a.o_jangle[n * 4 + j] = jang[j];
      a.o_jspeed[n * 4 + j] = jspd[j];
    }
    a.o_lower[n * 2] = lower_l;
    a.o_lower[n * 2 + 1] = lower_r;
    const bool game_over = a.game_over[n] || hull_touch;
    a.o_game_over[n] = game_over;
    a.o_step_count[n] = a.step_count[n] + (a.first ? 0 : 1);
    // hull origin = centroid - R(angle0) @ centroid offset
    const float c0 = cosf(ang[0]), s0 = sinf(ang[0]);
    const float hx = C[C_HULL_C], hy = C[C_HULL_C + 1];
    const float ox = fsub(pos[0], fadd(fmul(c0, hx), fmul(-s0, hy)));
    const float shaping = fsub(fmul(fmul(C[C_SHAPE], ox), C[C_RSCALE]),
                               fmul(C[C_ANGLE_W], fabsf(ang[0])));
    float reward = a.first ? 0.0f : fsub(shaping, a.prev_shaping[n]);
    a.o_prev_shaping[n] = shaping;
    float cost = 0.0f;
    for (int j = 0; j < 4; ++j) {
      const float cj = fmul(C[C_COST], clampf(fabsf(act[j]), 0.0f, 1.0f));
      cost = j == 0 ? cj : fadd(cost, cj);
    }
    reward = fsub(reward, cost);
    const bool fell = game_over || ox < 0.0f;
    const bool finish = ox > C[C_FINISH];
    a.o_reward[n] = fell ? -100.0f : reward;
    a.o_done[n] = fell || finish;
    a.o_finish[n] = finish;
    float* o = a.o_obs + n * 24;
    const float rfps = C[C_RFPS];
    o[0] = ang[0];
    o[1] = fmul(fmul(2.0f, av[0]), rfps);
    o[2] = fmul(fmul(fmul(C[C_OBS_W], vel[0]), C[C_OBS_VX]), rfps);
    o[3] = fmul(fmul(fmul(C[C_OBS_W], vel[1]), C[C_OBS_VY]), rfps);
    o[4] = jang[0];
    o[5] = fmul(jspd[0], C[C_RSPEED]);
    o[6] = fadd(jang[1], 1.0f);
    o[7] = fmul(jspd[1], C[C_RSPEED + 1]);
    o[8] = lower_l ? 1.0f : 0.0f;
    o[9] = jang[2];
    o[10] = fmul(jspd[2], C[C_RSPEED + 2]);
    o[11] = fadd(jang[3], 1.0f);
    o[12] = fmul(jspd[3], C[C_RSPEED + 3]);
    o[13] = lower_r ? 1.0f : 0.0f;
    for (int r = 0; r < kRays; ++r) o[14 + r] = frac[r];
  }
}

}  // namespace

extern "C" int dcd_walker_consts_count() { return C_COUNT; }

// Inputs (state, terrain, action) and outputs are contiguous device arrays
// of N walkers; `consts` is the C_COUNT-float table.
extern "C" int dcd_walker_step(
    const void* pos, const void* angle, const void* vel, const void* angvel,
    const void* xs, const void* ys, const void* boxes, const void* n_boxes,
    const void* prev_shaping, const void* game_over, const void* step_count,
    const void* action, const void* consts, void* o_pos, void* o_angle,
    void* o_vel, void* o_angvel, void* o_lower, void* o_jangle,
    void* o_jspeed, void* o_game_over, void* o_step_count,
    void* o_prev_shaping, void* o_obs, void* o_reward, void* o_done,
    void* o_finish, int n, int first, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.pos = (const float*)pos;
  a.angle = (const float*)angle;
  a.vel = (const float*)vel;
  a.angvel = (const float*)angvel;
  a.xs = (const float*)xs;
  a.ys = (const float*)ys;
  a.boxes = (const float*)boxes;
  a.n_boxes = (const int*)n_boxes;
  a.prev_shaping = (const float*)prev_shaping;
  a.game_over = (const uint8_t*)game_over;
  a.step_count = (const int*)step_count;
  a.action = (const float*)action;
  a.consts = (const float*)consts;
  a.o_pos = (float*)o_pos;
  a.o_angle = (float*)o_angle;
  a.o_vel = (float*)o_vel;
  a.o_angvel = (float*)o_angvel;
  a.o_lower = (uint8_t*)o_lower;
  a.o_jangle = (float*)o_jangle;
  a.o_jspeed = (float*)o_jspeed;
  a.o_game_over = (uint8_t*)o_game_over;
  a.o_step_count = (int*)o_step_count;
  a.o_prev_shaping = (float*)o_prev_shaping;
  a.o_obs = (float*)o_obs;
  a.o_reward = (float*)o_reward;
  a.o_done = (uint8_t*)o_done;
  a.o_finish = (uint8_t*)o_finish;
  a.n = n;
  a.first = first;
  walker_step_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
