// MultiGrid agent step and egocentric view gather, one thread per env.
//
// Replaces dcd_isaac_tpu/envs/multigrid/core.py:step_agent (:306-346) with
// gen_obs (:265-299) for see-through walls, and the `truncated` flag of
// AdversarialMultiGrid.step (adversarial.py:402-411).  A second entry point,
// dcd_multigrid_obs, is gen_obs alone (the reset paths' observation).
//
// Layout is the JAX engine's: grid (N, W, H) uint8 indexed [x, y] with
// flat = x * H + y; pos (N, 2) int32; dir, step, action (N,) int32; bool
// tensors are one byte.  The image is (N, v, v, 3) uint8 with channels
// (type, color, 0).  Semantics follow core.py exactly: the step count is
// bumped before the reward, the forward cell is read with clamped indices
// (as a JAX gather clamps), out-of-bounds view cells read as WALL, and the
// agent's own view cell is EMPTY.
//
// Bound on the H100: bytes.  Per env the step needs at most v*v - 1 = 24
// grid cells (its new view less the agent's own cell, which is written
// EMPTY unread, and less any out-of-bounds cell); the forward cell lies in
// that view unless the agent moves onto it, so a move adds one cell.  It
// also reads 21 bytes of state and writes 75 image bytes and 23 bytes of
// state.  At N = 32 that is a few KB, far under a microsecond at
// 3.35 TB/s, so the kernel is launch-bound on the main path.  The design
// keeps it one launch per env step (no intermediate tensors) and lets
// adjacent threads touch adjacent state entries; it does not stage the
// grid in shared memory, since each thread reads its cells once.
//
// The reward uses explicitly rounded intrinsics so nvcc cannot contract it
// into an FMA: the plain PyTorch twin rounds each operation, and the two
// must agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1, kWall = 2, kFloor = 3, kGoal = 8,
              kLava = 9, kMaxType = 10;
constexpr int kLeft = 0, kRight = 1, kForward = 2;

// constants.py TYPE_COLOR and DIR_TO_VEC.
__constant__ uint8_t kTypeColor[kMaxType + 1] = {0, 0, 5, 2, 2, 2,
                                                 2, 2, 1, 0, 0};
__constant__ int kDirVec[4][2] = {{1, 0}, {0, 1}, {-1, 0}, {0, -1}};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// gen_obs for one env: view cell (i, j), agent at (v/2, v-1) facing "up",
// maps to pos + forward * (v-1-j) + right * (i - v/2).
__device__ void write_view(const uint8_t* g, int W, int H, int px, int py,
                           int d, int v, uint8_t* img) {
  const int fx = kDirVec[d & 3][0], fy = kDirVec[d & 3][1];
  const int rx = kDirVec[(d + 1) & 3][0], ry = kDirVec[(d + 1) & 3][1];
  for (int i = 0; i < v; ++i) {
    for (int j = 0; j < v; ++j) {
      const int a = v - 1 - j, b = i - v / 2;
      const int cx = px + fx * a + rx * b, cy = py + fy * a + ry * b;
      int t;
      if (i == v / 2 && j == v - 1) {
        t = kEmpty;
      } else if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
        t = g[cx * H + cy];
      } else {
        t = kWall;
      }
      uint8_t* o = img + (i * v + j) * 3;
      o[0] = (uint8_t)t;
      o[1] = kTypeColor[t < kMaxType ? t : kMaxType];
      o[2] = 0;
    }
  }
}

__global__ void multigrid_step_kernel(
    const uint8_t* __restrict__ grid, const int* __restrict__ pos,
    const int* __restrict__ dir, const int* __restrict__ step,
    const uint8_t* __restrict__ agent_done, const int* __restrict__ action,
    int* __restrict__ pos_out, int* __restrict__ dir_out,
    int* __restrict__ step_out, uint8_t* __restrict__ agent_done_out,
    uint8_t* __restrict__ image, float* __restrict__ reward,
    uint8_t* __restrict__ done, uint8_t* __restrict__ truncated, int n_env,
    int W, int H, int v, int max_steps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_env) return;
  const uint8_t* g = grid + (size_t)n * W * H;
  const int px = pos[2 * n], py = pos[2 * n + 1], d = dir[n];
  const int sc = step[n] + 1;
  const int a = action[n];
  const int nd = a == kLeft ? (d + 3) % 4 : (a == kRight ? (d + 1) % 4 : d);

  const int fx = px + kDirVec[d & 3][0], fy = py + kDirVec[d & 3][1];
  const int ft = g[clampi(fx, 0, W - 1) * H + clampi(fy, 0, H - 1)];
  const bool fwd = a == kForward;
  const bool hit_goal = fwd && ft == kGoal;
  const bool hit_lava = fwd && ft == kLava;
  const bool moved = fwd && (ft == kEmpty || ft == kFloor);
  const int nx = moved ? fx : px, ny = moved ? fy : py;

  const bool ad = agent_done[n] || hit_goal || hit_lava;
  const bool dn = ad || sc >= max_steps;
  reward[n] = hit_goal ? __fsub_rn(1.0f, __fmul_rn(0.9f, __fdiv_rn(
                                               (float)sc, (float)max_steps)))
                       : 0.0f;
  pos_out[2 * n] = nx;
  pos_out[2 * n + 1] = ny;
  dir_out[n] = nd;
  step_out[n] = sc;
  agent_done_out[n] = ad;
  done[n] = dn;
  truncated[n] = dn && !ad;
  write_view(g, W, H, nx, ny, nd, v, image + (size_t)n * v * v * 3);
}

__global__ void multigrid_obs_kernel(const uint8_t* __restrict__ grid,
                                     const int* __restrict__ pos,
                                     const int* __restrict__ dir,
                                     uint8_t* __restrict__ image, int n_env,
                                     int W, int H, int v) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_env) return;
  write_view(grid + (size_t)n * W * H, W, H, pos[2 * n], pos[2 * n + 1],
             dir[n], v, image + (size_t)n * v * v * 3);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int dcd_multigrid_step(
    const void* grid, const void* pos, const void* dir, const void* step,
    const void* agent_done, const void* action, void* pos_out, void* dir_out,
    void* step_out, void* agent_done_out, void* image, void* reward,
    void* done, void* truncated, int n_env, int W, int H, int v,
    int max_steps, void* stream) {
  if (n_env > 0) {
    multigrid_step_kernel<<<(n_env + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)grid, (const int*)pos, (const int*)dir,
        (const int*)step, (const uint8_t*)agent_done, (const int*)action,
        (int*)pos_out, (int*)dir_out, (int*)step_out,
        (uint8_t*)agent_done_out, (uint8_t*)image, (float*)reward,
        (uint8_t*)done, (uint8_t*)truncated, n_env, W, H, v, max_steps);
  }
  return (int)cudaGetLastError();
}

extern "C" int dcd_multigrid_obs(const void* grid, const void* pos,
                                 const void* dir, void* image, int n_env,
                                 int W, int H, int v, void* stream) {
  if (n_env > 0) {
    multigrid_obs_kernel<<<(n_env + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint8_t*)grid, (const int*)pos, (const int*)dir,
        (uint8_t*)image, n_env, W, H, v);
  }
  return (int)cudaGetLastError();
}
