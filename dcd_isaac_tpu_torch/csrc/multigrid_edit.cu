// Kernel B9: ACCEL's level edits and the domain-randomized levels, one
// thread per level.
//
// Replaces dcd_isaac_tpu/envs/multigrid/adversarial.py:
//   dcd_multigrid_mutate        mutate_level (:284-372) up to its
//                               compute_metrics: num_edits edits applied in
//                               order (a later edit of a cell overwrites an
//                               earlier one), the goal re-placed on a free
//                               cell other than the agent's if an edit
//                               removed it, then the agent on an empty
//                               cell, and the interior walls recounted;
//   dcd_multigrid_reset_random  reset_random (:206-257) up to its
//                               compute_metrics: the goal, then the agent,
//                               on empty cells, a direction, then the walls
//                               one at a time on empty cells other than the
//                               agent's.
// The BFS and the observation that follow are kernel B5's and B1's entry
// points.
//
// Layout is the JAX engine's: grid (N, W, H) uint8 indexed [x, y] with
// flat = x * H + y; positions (N, 2) int32, (-1, -1) for none.  Every
// random choice is an input, float32 uniforms in [0, 1) per level:
//   mutate (N, 2 E + 2): E edit cells, E edit actions, the goal's cell, the
//     agent's cell; an edit cell is the interior cell min(trunc(u (W-2)^2),
//     (W-2)^2 - 1), an action min(trunc(u A), A - 1) of the env's A
//     editor actions;
//   reset_random (N, 4 + max_walls): the goal's cell, the agent's cell,
//     the direction min(trunc(4 u), 3), the wall count (variable-block
//     mode: min(trunc(u n), n - 1), n = max(n_clutter, 1)), one cell per
//     wall.
// A cell is drawn as the k-th candidate cell in flat order,
// k = min(trunc(u * count), count - 1), cell 0 when there is none, as in
// kernel B5 and the plain PyTorch twins (kernels/multigrid_edit.py), so
// kernel and twins agree bit for bit.
//
// Bound on the H100: a level's 225 grid bytes in and out, ~10 KB at the
// main path's N = 32, a few nanoseconds of bandwidth: the kernel is bound
// by its launch and by each thread's sequential scans of its grid (two per
// drawn cell), which it keeps in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1, kWall = 2, kGoal = 8;
constexpr int kLevels = 64;      // levels (threads) per block
constexpr int kMaxCells = 256;

// The editor's action codes; EDITOR_ACTION_SPACES in the JAX package:
// 0 walls_none ('-', '.'), 1 walls_none_goal ('-', '.', 'g'),
// 2 walls_none_agent_goal ('-', '.', 'a', 'g').
enum { kOpWall = 0, kOpNone = 1, kOpGoal = 2, kOpAgent = 3 };

__device__ __forceinline__ int action_count(int set) { return set + 2; }

__device__ __forceinline__ int action_op(int set, int a) {
  if (a <= 1) return a;                        // '-' then '.'
  if (set == 1) return kOpGoal;                // 'g'
  return a == 2 ? kOpAgent : kOpGoal;          // 'a', 'g'
}

__device__ __forceinline__ int scaled(float u, int n) {
  const int k = (int)__fmul_rn(u, (float)n);
  const int last = n > 0 ? n - 1 : 0;
  return k < last ? k : last;
}

// The k-th empty cell of g other than `skip` (flat), k from u; 0 when none.
__device__ int draw_cell(const uint8_t* g, int cells, int skip, float u) {
  int count = 0;
  for (int c = 0; c < cells; ++c) count += (g[c] == kEmpty && c != skip);
  if (count == 0) return 0;
  int k = scaled(u, count);
  for (int c = 0; c < cells; ++c) {
    if (g[c] == kEmpty && c != skip) {
      if (k == 0) return c;
      --k;
    }
  }
  return 0;
}

__device__ int count_interior_walls(const uint8_t* g, int W, int H) {
  int n = 0;
  for (int x = 1; x < W - 1; ++x) {
    for (int y = 1; y < H - 1; ++y) n += g[x * H + y] == kWall;
  }
  return n;
}

__global__ void mutate_kernel(const uint8_t* grid_in, const int* goal_in,
                              const int* agent_in, const float* u,
                              uint8_t* grid_out, int* goal_out,
                              int* agent_out, int* walls_out, int N, int W,
                              int H, int E, int set) {
  __shared__ uint8_t grids[kLevels][kMaxCells];
  const int n = blockIdx.x * kLevels + threadIdx.x;
  if (n >= N) return;
  const int cells = W * H;
  uint8_t* g = grids[threadIdx.x];
  for (int c = 0; c < cells; ++c) g[c] = grid_in[(size_t)n * cells + c];
  const float* un = u + (size_t)n * (2 * E + 2);
  int gx = goal_in[2 * n], gy = goal_in[2 * n + 1];
  int ax = agent_in[2 * n], ay = agent_in[2 * n + 1];
  const int interior = W - 2;
  const int tiles = interior * interior;
  const int A = action_count(set);
  for (int i = 0; i < E; ++i) {
    const int loc = scaled(un[i], tiles);
    const int op = action_op(set, scaled(un[E + i], A));
    const int x = loc % interior + 1, y = loc / interior + 1;
    const int c = x * H + y;
    if (gx == x && gy == y) gx = gy = -1;
    if (ax == x && ay == y) ax = ay = -1;
    g[c] = kEmpty;
    if (op == kOpWall) g[c] = kWall;
    if (op == kOpGoal) {
      if (gx >= 0) g[gx * H + gy] = kEmpty;
      g[c] = kGoal;
      gx = x;
      gy = y;
    }
    if (op == kOpAgent) {
      ax = x;
      ay = y;
    }
  }
  const int gc = draw_cell(g, cells, ax >= 0 ? ax * H + ay : -1, un[2 * E]);
  if (gx < 0) {
    g[gc] = kGoal;
    gx = gc / H;
    gy = gc % H;
  }
  const int ac = draw_cell(g, cells, -1, un[2 * E + 1]);
  if (ax < 0) {
    ax = ac / H;
    ay = ac % H;
  }
  for (int c = 0; c < cells; ++c) grid_out[(size_t)n * cells + c] = g[c];
  goal_out[2 * n] = gx;
  goal_out[2 * n + 1] = gy;
  agent_out[2 * n] = ax;
  agent_out[2 * n + 1] = ay;
  walls_out[n] = count_interior_walls(g, W, H);
}

__global__ void reset_random_kernel(const float* u, uint8_t* grid_out,
                                    int* goal_out, int* agent_out,
                                    int* dir_out, int* walls_out, int N,
                                    int W, int H, int n_clutter,
                                    int resample, int max_walls) {
  __shared__ uint8_t grids[kLevels][kMaxCells];
  const int n = blockIdx.x * kLevels + threadIdx.x;
  if (n >= N) return;
  const int cells = W * H;
  uint8_t* g = grids[threadIdx.x];
  for (int x = 0; x < W; ++x) {
    for (int y = 0; y < H; ++y) {
      g[x * H + y] = (x == 0 || y == 0 || x == W - 1 || y == H - 1) ? kWall
                                                                    : kEmpty;
    }
  }
  const float* un = u + (size_t)n * (4 + max_walls);
  const int gc = draw_cell(g, cells, -1, un[0]);
  g[gc] = kGoal;
  const int ac = draw_cell(g, cells, -1, un[1]);
  const int dir = scaled(un[2], 4);
  const int budget = n_clutter > 1 ? n_clutter : 1;
  const int n_walls = resample ? scaled(un[3], budget) : n_clutter / 2;
  int placed = 0;
  for (int i = 0; i < max_walls; ++i) {
    int free = 0;
    for (int c = 0; c < cells; ++c) free += (g[c] == kEmpty && c != ac);
    const int pc = draw_cell(g, cells, ac, un[4 + i]);
    if (i < n_walls && free > 0) {
      g[pc] = kWall;
      ++placed;
    }
  }
  for (int c = 0; c < cells; ++c) grid_out[(size_t)n * cells + c] = g[c];
  goal_out[2 * n] = gc / H;
  goal_out[2 * n + 1] = gc % H;
  agent_out[2 * n] = ac / H;
  agent_out[2 * n + 1] = ac % H;
  dir_out[n] = dir;
  walls_out[n] = placed;
}

}  // namespace

extern "C" int dcd_multigrid_mutate(const void* grid_in, const void* goal_in,
                                    const void* agent_in, const void* u,
                                    void* grid_out, void* goal_out,
                                    void* agent_out, void* walls_out, int N,
                                    int W, int H, int num_edits,
                                    int action_set, void* stream) {
  if (N > 0) {
    mutate_kernel<<<(N + kLevels - 1) / kLevels, kLevels, 0,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)grid_in, (const int*)goal_in, (const int*)agent_in,
        (const float*)u, (uint8_t*)grid_out, (int*)goal_out, (int*)agent_out,
        (int*)walls_out, N, W, H, num_edits, action_set);
  }
  return (int)cudaGetLastError();
}

extern "C" int dcd_multigrid_reset_random(const void* u, void* grid_out,
                                          void* goal_out, void* agent_out,
                                          void* dir_out, void* walls_out,
                                          int N, int W, int H, int n_clutter,
                                          int resample, int max_walls,
                                          void* stream) {
  if (N > 0) {
    reset_random_kernel<<<(N + kLevels - 1) / kLevels, kLevels, 0,
                          (cudaStream_t)stream>>>(
        (const float*)u, (uint8_t*)grid_out, (int*)goal_out, (int*)agent_out,
        (int*)dir_out, (int*)walls_out, N, W, H, n_clutter, resample,
        max_walls);
  }
  return (int)cudaGetLastError();
}
