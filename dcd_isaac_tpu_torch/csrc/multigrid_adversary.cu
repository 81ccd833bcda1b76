// The teacher's construction step with the level's BFS, one CTA per level.
//
// Replaces dcd_isaac_tpu/envs/multigrid/adversarial.py:step_adversary
// (:102-204) with the encode_grid of its observation (core.py:158) and, on
// the final move, compute_metrics / shortest_path (core.py:369-430).  A
// second entry point, dcd_multigrid_shortest_path, is the BFS alone, for
// compute_metrics on the reset paths.
//
// Layout is the JAX engine's: grid (N, W, H) uint8 indexed [x, y] with
// flat = x * H + y; positions (N, 2) int32 with (-1, -1) for unplaced;
// scalars (N,) int32; bool tensors one byte; the image (N, W, H, 3) uint8
// with channels (type, color, 0) and the agent overlay (AGENT, 0, dir) at
// agent_pos when agent_pos.x >= 0.  A move `loc` in [0, (W-2)^2) is the
// interior cell x = loc % (W-2) + 1, y = loc / (W-2) + 1.
//
// The random draws are inputs, (N, 3) float32 uniforms in [0, 1) per level:
// u[0] the noisy goal's coin, u[1] the noisy goal's cell, u[2] the agent's
// cell when it lands on the goal.  A cell is drawn as the k-th empty cell
// in flat order, k = min(trunc(u * count), count - 1), cell 0 when there is
// none; the plain PyTorch twin draws the same way, so the two agree bit
// for bit.
//
// Per CTA: thread 0 runs the placement logic on the grid held in shared
// memory; the block draws a cell with a prefix count over the cells; on
// the final move the block runs the BFS, one thread per cell, as a Jacobi
// min-relaxation of the distance from the agent over non-wall cells,
// until a __syncthreads_or reports no change.  No host round trip.
//
// Bound on the H100: bytes.  A move reads the level's 225 grid bytes and
// ~50 bytes of state and writes the grid, 675 image bytes and the state.
// At the main path's N = 32 that is ~30 KB, about 0.01 us at 3.35 TB/s:
// the kernel is launch- and latency-bound (the BFS of the final move runs
// up to a few hundred dependent sweeps, each a pair of block barriers).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1, kWall = 2, kGoal = 8, kAgent = 10, kMaxType = 10;
constexpr int kThreads = 256;   // one thread per cell: W * H <= 256

// constants.py TYPE_COLOR.
__constant__ uint8_t kTypeColor[kMaxType + 1] = {0, 0, 5, 2, 2, 2,
                                                 2, 2, 1, 0, 0};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Block-wide: the flat index of the k-th empty cell of g, k from u as in
// the header; 0 when no cell is empty.  All threads return it.
__device__ int draw_empty_cell(const uint8_t* g, int cells, float u,
                               int* scan, int* pick) {
  const int tid = threadIdx.x;
  const int e = (tid < cells && g[tid] == kEmpty) ? 1 : 0;
  scan[tid] = e;
  // Hillis-Steele inclusive prefix sum over the block.
  for (int off = 1; off < kThreads; off <<= 1) {
    __syncthreads();
    const int v = tid >= off ? scan[tid - off] : 0;
    __syncthreads();
    scan[tid] += v;
  }
  __syncthreads();
  const int count = scan[kThreads - 1];
  int k = (int)__fmul_rn(u, (float)count);
  const int last = count > 0 ? count - 1 : 0;
  k = k < last ? k : last;
  if (tid == 0) *pick = 0;
  __syncthreads();
  if (e && scan[tid] - 1 == k) *pick = tid;
  __syncthreads();
  return *pick;
}

// Block-wide BFS distance from (sx, sy) (clamped to >= 0) to (gx, gy) over
// non-wall cells of g; returns it (inf when unreachable) to all threads.
// dist and flag are shared scratch.
__device__ int bfs_distance(const uint8_t* g, int W, int H, int sx, int sy,
                            int gx, int gy, int inf, int* dist) {
  const int tid = threadIdx.x;
  const int cells = W * H;
  const int start = clampi(sx, 0, W - 1) * H + clampi(sy, 0, H - 1);
  const bool mine = tid < cells;
  const bool open = mine && g[tid] != kWall;
  if (mine) dist[tid] = (open && tid == start) ? 0 : inf;
  const int x = tid / H, y = tid % H;
  while (true) {
    __syncthreads();
    int cand = inf;
    if (open) {
      int nb = inf;
      if (x > 0) nb = min(nb, dist[tid - H]);
      if (x < W - 1) nb = min(nb, dist[tid + H]);
      if (y > 0) nb = min(nb, dist[tid - 1]);
      if (y < H - 1) nb = min(nb, dist[tid + 1]);
      cand = min(nb + 1, inf);
    }
    const bool lower = open && cand < dist[tid];
    __syncthreads();
    if (lower) dist[tid] = cand;
    if (!__syncthreads_or(lower)) break;
  }
  return dist[clampi(gx, 0, W - 1) * H + clampi(gy, 0, H - 1)];
}

__device__ void write_image(const uint8_t* g, int cells, int ax, int ay,
                            int adir, int H, uint8_t* img) {
  const int tid = threadIdx.x;
  if (tid >= cells) return;
  const int t = g[tid];
  uint8_t* o = img + 3 * tid;
  if (ax >= 0 && tid == ax * H + (ay > 0 ? ay : 0)) {
    o[0] = kAgent;
    o[1] = 0;
    o[2] = (uint8_t)adir;
  } else {
    o[0] = (uint8_t)t;
    o[1] = kTypeColor[t < kMaxType ? t : kMaxType];
    o[2] = 0;
  }
}

struct StepParams {
  int W, H, n_clutter, max_adv_steps, action_dim, resample, goal_last;
  float goal_noise;
  int inf;
};

__global__ void __launch_bounds__(kThreads) adversary_step_kernel(
    const uint8_t* __restrict__ grid, const int* __restrict__ agent_pos,
    const int* __restrict__ agent_dir, const int* __restrict__ start_pos,
    const int* __restrict__ goal_pos, const int* __restrict__ adv_step,
    const int* __restrict__ adv_max, const int* __restrict__ n_placed,
    const uint8_t* __restrict__ passable, const int* __restrict__ spl,
    const int* __restrict__ dist_goal, const int* __restrict__ loc,
    const float* __restrict__ u, uint8_t* __restrict__ grid_out,
    int* __restrict__ start_pos_out, int* __restrict__ goal_pos_out,
    int* __restrict__ adv_step_out, int* __restrict__ adv_max_out,
    int* __restrict__ n_placed_out, uint8_t* __restrict__ passable_out,
    int* __restrict__ spl_out, int* __restrict__ dist_goal_out,
    uint8_t* __restrict__ image, uint8_t* __restrict__ done_out,
    StepParams p) {
  __shared__ uint8_t g[kThreads];
  __shared__ int scan[kThreads];
  __shared__ int dist[kThreads];
  __shared__ int s_pick, s_mode, s_x, s_y, s_ax, s_ay, s_gx, s_gy, s_done;
  __shared__ float s_u;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = p.W, H = p.H, cells = W * H;
  if (tid < cells) g[tid] = grid[(size_t)n * cells + tid];
  __syncthreads();

  // Thread 0: the move's role, and the agent's clearing of a wall, which
  // precedes its draw (adversarial.py:115-176).
  int t = 0, amax = 0, ncp = 0;
  bool cg = false, ca = false, pw = false, noisy = false;
  if (tid == 0) {
    const int interior = W - 2;
    const int l = loc[n];
    const int x = clampi(l % interior + 1, 0, W - 1);
    const int y = clampi(l / interior + 1, 0, H - 1);
    t = adv_step[n];
    amax = adv_max[n];
    if (p.resample && t == 0) amax = (l * p.n_clutter) / p.action_dim + 2;
    const bool active = t < amax;
    if (p.goal_last) {
      cg = active && t == amax - 2;
      ca = active && t == amax - 1;
    } else {
      cg = active && t == 0;
      ca = active && t == 1;
    }
    pw = active && !cg && !ca;
    ncp = n_placed[n];
    int mode = 0;
    float uu = 0.0f;
    if (cg && p.goal_noise > 0.0f) {
      noisy = u[3 * n] < p.goal_noise;
      if (noisy) {
        mode = 1;
        uu = u[3 * n + 1];
      }
    }
    if (ca) {
      if (g[x * H + y] == kWall) {
        g[x * H + y] = kEmpty;
        ncp -= 1;
      }
      mode = 2;
      uu = u[3 * n + 2];
    }
    s_mode = mode;
    s_u = uu;
    s_x = x;
    s_y = y;
  }
  __syncthreads();

  int pick = 0;
  if (s_mode != 0) pick = draw_empty_cell(g, cells, s_u, scan, &s_pick);

  // Thread 0: goal, agent and wall placement (adversarial.py:147-194).
  if (tid == 0) {
    const int x = s_x, y = s_y, c = x * H + y;
    int gx = goal_pos[2 * n], gy = goal_pos[2 * n + 1];
    int ax = start_pos[2 * n], ay = start_pos[2 * n + 1];
    if (cg) {
      if (noisy) {
        g[pick] = kGoal;
        gx = pick / H;
        gy = pick % H;
      } else {
        if (g[c] == kWall) ncp -= 1;
        g[c] = kGoal;
        gx = x;
        gy = y;
      }
    }
    if (ca) {
      const bool collide = g[c] != kEmpty;
      ax = collide ? pick / H : x;
      ay = collide ? pick % H : y;
    }
    const bool on_agent = ax == x && ay == y && ax >= 0;
    if (pw && g[c] == kEmpty && !on_agent) {
      g[c] = kWall;
      ncp += 1;
    }
    const int t1 = t + 1;
    const bool done = t1 >= p.max_adv_steps;
    start_pos_out[2 * n] = ax;
    start_pos_out[2 * n + 1] = ay;
    goal_pos_out[2 * n] = gx;
    goal_pos_out[2 * n + 1] = gy;
    adv_step_out[n] = t1;
    adv_max_out[n] = amax;
    n_placed_out[n] = ncp;
    done_out[n] = done;
    s_ax = ax;
    s_ay = ay;
    s_gx = gx;
    s_gy = gy;
    s_done = done;
  }
  __syncthreads();

  if (s_done) {
    const int ax = s_ax, ay = s_ay, gx = s_gx, gy = s_gy;
    const int d = bfs_distance(g, W, H, ax, ay, gx, gy, p.inf, dist);
    if (tid == 0) {
      const bool both = ax >= 0 && gx >= 0;
      const bool ok = both && d < p.inf;
      passable_out[n] = ok;
      spl_out[n] = ok ? d : p.inf;
      dist_goal_out[n] = both ? abs(gx - ax) + abs(gy - ay) : -1;
    }
  } else if (tid == 0) {
    passable_out[n] = passable[n];
    spl_out[n] = spl[n];
    dist_goal_out[n] = dist_goal[n];
  }
  if (tid < cells) grid_out[(size_t)n * cells + tid] = g[tid];
  write_image(g, cells, agent_pos[2 * n], agent_pos[2 * n + 1], agent_dir[n],
              H, image + (size_t)n * cells * 3);
}

__global__ void __launch_bounds__(kThreads) shortest_path_kernel(
    const uint8_t* __restrict__ grid, const int* __restrict__ start,
    const int* __restrict__ goal, uint8_t* __restrict__ passable,
    int* __restrict__ spl, int W, int H, int inf) {
  __shared__ uint8_t g[kThreads];
  __shared__ int dist[kThreads];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int cells = W * H;
  if (tid < cells) g[tid] = grid[(size_t)n * cells + tid];
  __syncthreads();
  const int sx = start[2 * n], sy = start[2 * n + 1];
  const int gx = goal[2 * n], gy = goal[2 * n + 1];
  const int d = bfs_distance(g, W, H, sx, sy, gx, gy, inf, dist);
  if (tid == 0) {
    const bool ok = sx >= 0 && gx >= 0 && d < inf;
    passable[n] = ok;
    spl[n] = ok ? d : inf;
  }
}

}  // namespace

extern "C" int dcd_adversary_step(
    const void* grid, const void* agent_pos, const void* agent_dir,
    const void* start_pos, const void* goal_pos, const void* adv_step,
    const void* adv_max, const void* n_placed, const void* passable,
    const void* spl, const void* dist_goal, const void* loc, const void* u,
    void* grid_out, void* start_pos_out, void* goal_pos_out,
    void* adv_step_out, void* adv_max_out, void* n_placed_out,
    void* passable_out, void* spl_out, void* dist_goal_out, void* image,
    void* done_out, int n_env, int W, int H, int n_clutter,
    int max_adv_steps, int action_dim, int resample, int goal_last,
    float goal_noise, int inf, void* stream) {
  if (n_env > 0) {
    const StepParams p{W, H, n_clutter, max_adv_steps, action_dim,
                       resample, goal_last, goal_noise, inf};
    adversary_step_kernel<<<n_env, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)grid, (const int*)agent_pos, (const int*)agent_dir,
        (const int*)start_pos, (const int*)goal_pos, (const int*)adv_step,
        (const int*)adv_max, (const int*)n_placed, (const uint8_t*)passable,
        (const int*)spl, (const int*)dist_goal, (const int*)loc,
        (const float*)u, (uint8_t*)grid_out, (int*)start_pos_out,
        (int*)goal_pos_out, (int*)adv_step_out, (int*)adv_max_out,
        (int*)n_placed_out, (uint8_t*)passable_out, (int*)spl_out,
        (int*)dist_goal_out, (uint8_t*)image, (uint8_t*)done_out, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int dcd_multigrid_shortest_path(const void* grid,
                                           const void* start,
                                           const void* goal, void* passable,
                                           void* spl, int n_env, int W, int H,
                                           int inf, void* stream) {
  if (n_env > 0) {
    shortest_path_kernel<<<n_env, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)grid, (const int*)start, (const int*)goal,
        (uint8_t*)passable, (int*)spl, W, H, inf);
  }
  return (int)cudaGetLastError();
}
