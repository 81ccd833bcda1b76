// Kernel B8: Prioritized Level Replay's score fold, sample weights and
// staged-level promotion, on the level buffer held on the card.
//
// Replaces dcd_isaac_tpu/level_replay/plr.py:
//   dcd_plr_score_fold     update_with_rollout (:345-518) with _step_scores
//                          (:276-338) for the value-loss strategies;
//   dcd_plr_sample_weights sample_weights / _score_transform (:158-207) for
//                          the constant, rank and power transforms;
//   dcd_plr_promote        promote_staged (:525-643): the content-hash
//                          dedup, the targets, the acceptance, the scatter.
// Every one of them is a single block of kBlock threads over the whole
// buffer (the promotion first runs a grid that hashes every level), so the
// sums run in one fixed order: no float atomics, bit-identical runs.
//
// The score fold.  One thread per env walks its T steps twice: first the
// episode returns (the grounded value of a step needs its whole episode's
// return), then the per-step scores, summed per episode in step order.
// Each completed, non-cliffhanger episode is written to an (N, T + 1)
// table with its first step's seed.  The block then lists the working
// episodes (seed < S) and the staged ones (seed >= the staging base) in
// (env, episode) order, the order of the JAX package's stable
// (seed, order) argsort.  The thread holding the last episode of a seed
// folds all of that seed's episodes in order with the weights
// alpha (1 - alpha)^(K - 1 - rank), so each seed is written once.  A
// thread per staged level sums its episodes the same way.
//
// The weights.  The rank of a score is 1 plus the count of larger scores
// and of equal scores at lower slots (argsort(-x, stable)), counted tile by
// tile through shared memory.  The normalisers are block sums: each thread
// sums its strided entries, then the partial sums fold pairwise.
//
// The promotion.  A block per level hashes it into two 32-bit lanes
// (sum of b_j (j M + 1) mod 2^32; plr.py:566-577); b_j is a byte of a
// MultiGrid level or a float32 element of a walker level truncated toward
// zero, as JAX's astype(uint32) casts it by value.  The promotion block
// then finds each valid staged level's duplicate (the lowest filled slot
// with both lanes equal; the highest staged index wins a slot), folds the
// duplicates, computes the weights of the folded buffer, orders the empty
// slots by index and the filled ones by ascending weight (or score), ranks
// the staged levels by descending score, pairs them, accepts, and
// scatters levels, scores and ids.
//
// Every float operation is rounded on its own (__fadd_rn, __fmul_rn,
// __fdiv_rn), in the order of the plain PyTorch twins in
// level_replay/plr.py, which sum in the same order: the two agree to the
// last bit but for powf.
//
// Bound on the H100: the bytes (the rollout's 18 bytes a step, the
// buffer's 2.7 MB of levels for the hashes) take well under a
// microsecond; a single block is bound by its dependent chains (the
// T-step walks, the O(S^2) rank counts over 4000 slots) and its barriers.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kHashThreads = 256;
constexpr float kNegInf = -1e9f;   // the grounded values' "unknown"

// Strategies (kernels/plr.py FOLD_STRATEGIES).
enum { kOnes = 0, kSigned = 1, kAbs = 2, kPositive = 3, kGroundedSigned = 4,
       kGroundedPositive = 5, kTdError = 6 };
// Transforms (kernels/plr.py TRANSFORMS).
enum { kConstant = 0, kRank = 1, kPower = 2 };

struct WeightParams {
  int transform;
  float p;               // 1 / temperature
  int stale_on;          // staleness_coef > 0
  int stale_transform;
  float stale_p;
  float e;               // the power transform's offset
  float coef, one_minus_coef;
};

// x ** p as PyTorch computes a tensor to a scalar power: the exponents it
// special-cases, else powf.
__device__ float pow_scalar(float x, float p) {
  if (p == 0.0f) return 1.0f;
  if (p == 1.0f) return x;
  if (p == 2.0f) return __fmul_rn(x, x);
  if (p == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

// Sum of x[0..n) in the twins' order; all threads return it.
__device__ float block_sum(const float* x, int n, float* red) {
  const int tid = threadIdx.x;
  float acc = 0.0f;
  for (int i = tid; i < n; i += kBlock) acc = __fadd_rn(acc, x[i]);
  red[tid] = acc;
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

// pos[i] = the place of key[i] in a stable sort of key[0..n), ascending or
// descending: the count of keys before it, or equal to it at a lower index.
__device__ void order_positions(const float* key, int n, bool descending,
                                int* pos, float* tile) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < n; i0 += kBlock) {
    const int i = i0 + tid;
    const float ki = i < n ? key[i] : 0.0f;
    int cnt = 0;
    for (int j0 = 0; j0 < n; j0 += kBlock) {
      __syncthreads();
      if (j0 + tid < n) tile[tid] = key[j0 + tid];
      __syncthreads();
      const int lim = min(kBlock, n - j0);
      if (i < n) {
        for (int jj = 0; jj < lim; ++jj) {
          const float kj = tile[jj];
          const bool before = descending ? kj > ki : kj < ki;
          cnt += (before || (kj == ki && j0 + jj < i)) ? 1 : 0;
        }
      }
    }
    if (i < n) pos[i] = cnt;
  }
  __syncthreads();
}

__device__ float transform_value(int transform, float p, float e, float x,
                                 int pos) {
  if (transform == kRank) {
    return __fdiv_rn(1.0f, pow_scalar((float)(pos + 1), p));
  }
  if (transform == kPower) return pow_scalar(__fadd_rn(fmaxf(x, 0.0f), e), p);
  return 1.0f;
}

// sample_weights of (scores, staleness, unseen) into w[0..S); tmp (S
// floats) and pos (S ints) are scratch.  All threads call it.
__device__ void weights_block(const float* scores, const float* staleness,
                              const float* unseen, int S, WeightParams wp,
                              float* w, float* tmp, int* pos, float* red,
                              float* tile) {
  const int tid = threadIdx.x;
  for (int i = tid; i < S; i += kBlock) tmp[i] = __fsub_rn(1.0f, unseen[i]);
  __syncthreads();
  const float seen_total = fmaxf(block_sum(tmp, S, red), 1.0f);
  if (wp.transform == kRank) order_positions(scores, S, true, pos, tile);
  for (int i = tid; i < S; i += kBlock) {
    w[i] = __fmul_rn(transform_value(wp.transform, wp.p, wp.e, scores[i],
                                     pos[i]),
                     tmp[i]);
  }
  __syncthreads();
  const float z = block_sum(w, S, red);
  float sz = 0.0f;
  if (wp.stale_on) {
    if (wp.stale_transform == kRank) {
      order_positions(staleness, S, true, pos, tile);
    }
    for (int i = tid; i < S; i += kBlock) {
      tmp[i] = __fmul_rn(transform_value(wp.stale_transform, wp.stale_p,
                                         wp.e, staleness[i], pos[i]),
                         __fsub_rn(1.0f, unseen[i]));
    }
    __syncthreads();
    sz = block_sum(tmp, S, red);
  }
  for (int i = tid; i < S; i += kBlock) {
    const float uniform = __fdiv_rn(__fsub_rn(1.0f, unseen[i]), seen_total);
    float wi = z > 0.0f ? __fdiv_rn(w[i], fmaxf(z, 1e-12f)) : uniform;
    if (wp.stale_on) {
      const float si = sz > 0.0f ? __fdiv_rn(tmp[i], fmaxf(sz, 1e-12f))
                                 : uniform;
      wi = __fadd_rn(__fmul_rn(wp.one_minus_coef, wi),
                     __fmul_rn(wp.coef, si));
    }
    w[i] = wi;
  }
  __syncthreads();
}

__global__ void sample_weights_kernel(const float* scores,
                                      const float* staleness,
                                      const float* unseen, float* w,
                                      float* tmp, int* pos, int S,
                                      WeightParams wp) {
  __shared__ float red[kBlock], tile[kBlock];
  weights_block(scores, staleness, unseen, S, wp, w, tmp, pos, red, tile);
}

struct FoldParams {
  int T, N, S, base, strategy, dense, staleness_on;
  float alpha, one_minus_alpha, msc, one_minus_msc, gamma;
};

// One step's score s and weight w (plr.py:_step_scores).
__device__ void step_score(const FoldParams& fp, float r, float v, float ret,
                           float grounded, bool done, bool start,
                           float v_next, float* s, float* w) {
  *w = 1.0f;
  switch (fp.strategy) {
    case kSigned: *s = __fsub_rn(ret, v); break;
    case kAbs: *s = fabsf(__fsub_rn(ret, v)); break;
    case kPositive: *s = fmaxf(__fsub_rn(ret, v), 0.0f); break;
    case kGroundedSigned:
    case kGroundedPositive:
      *s = __fsub_rn(grounded, v);
      if (fp.strategy == kGroundedPositive) *s = fmaxf(*s, 0.0f);
      if (fp.dense) *w = start ? 1.0f : 0.0f;
      break;
    case kTdError: {
      const bool single = start && done;
      *s = single ? __fsub_rn(r, v)
                  : fabsf(__fsub_rn(__fadd_rn(r, __fmul_rn(fp.gamma, v_next)),
                                    v));
      *w = single ? 1.0f : (done ? 0.0f : 1.0f);
      break;
    }
    default: *s = 1.0f;
  }
}

__global__ void score_fold_kernel(
    const float* rewards, const float* values, const float* returns,
    const uint8_t* dones, const uint8_t* cliff, const int* seeds,
    float* scores, float* unseen, float* grounded, float* staleness,
    float* staged_scores, float* staged_counts, int* iws, float* fws,
    FoldParams fp) {
  __shared__ int scan_w[kBlock], scan_s[kBlock];
  const int tid = threadIdx.x;
  const int T = fp.T, N = fp.N, S = fp.S, E = fp.T + 1;
  const int NE = N * E;
  int* ep_seed = iws;
  int* ep_kind = iws + NE;     // bit 0 working, bit 1 staged
  int* list_w = iws + 2 * NE;
  int* list_s = iws + 3 * NE;
  int* key_w = iws + 4 * NE;   // the seed of each listed working episode
  int* key_s = iws + 5 * NE;   // the staged index of each staged episode
  int* nseg = iws + 6 * NE;
  int* cnt_w = nseg + N;
  int* cnt_s = cnt_w + N;
  float* ep_total = fws;
  float* ep_ret = fws + NE;
  float* ep_cnt = fws + 2 * NE;

  // 1. each env's episodes, in step order
  for (int n = tid; n < N; n += kBlock) {
    float run = 0.0f;
    int e = 0;
    for (int t = 0; t < T; ++t) {
      const size_t k = (size_t)t * N + n;
      run = __fadd_rn(run, rewards[k]);
      if (dones[k]) {
        ep_ret[n * E + e] = run;
        run = 0.0f;
        ++e;
      }
    }
    if (T > 0 && !dones[(size_t)(T - 1) * N + n]) ep_ret[n * E + e] = run;

    e = 0;
    int nw = 0, ns = 0, first_seed = 0;
    bool start = true;
    float sum = 0.0f, cnt = 0.0f, mx = -INFINITY;
    for (int t = 0; t < T; ++t) {
      const size_t k = (size_t)t * N + n;
      const int seed = seeds[k];
      if (start) first_seed = seed;
      const float old = grounded[(seed >= 0 && seed < S) ? seed : 0];
      const float ret_e = ep_ret[n * E + e];
      const float g = old > -5e8f ? fmaxf(old, ret_e) : ret_e;
      const bool done = dones[k] != 0;
      const float v = values[k];
      const float v_next = t + 1 < T ? values[k + N] : v;
      float s, w;
      step_score(fp, rewards[k], v, returns[k], g, done, start, v_next, &s,
                 &w);
      sum = __fadd_rn(sum, __fmul_rn(s, w));
      cnt = __fadd_rn(cnt, w);
      if (w > 0.0f) mx = fmaxf(mx, s);
      start = false;
      if (done) {
        const int idx = n * E + e;
        const float mean = __fdiv_rn(sum, fmaxf(cnt, 1.0f));
        const float emax = isfinite(mx) ? mx : 0.0f;
        ep_total[idx] = __fadd_rn(__fmul_rn(fp.msc, emax),
                                  __fmul_rn(fp.one_minus_msc, mean));
        ep_cnt[idx] = cnt;
        ep_seed[idx] = first_seed;
        int kind = 0;
        if (!cliff[k]) {
          if (first_seed >= 0 && first_seed < S) { kind |= 1; ++nw; }
          if (first_seed >= fp.base) { kind |= 2; ++ns; }
        }
        ep_kind[idx] = kind;
        ++e;
        sum = 0.0f;
        cnt = 0.0f;
        mx = -INFINITY;
        start = true;
      }
    }
    nseg[n] = e;
    cnt_w[n] = nw;
    cnt_s[n] = ns;
  }
  __syncthreads();

  // 2. the working and staged episodes listed in (env, episode) order
  const int chunk = (N + kBlock - 1) / kBlock;
  const int n0 = min(N, tid * chunk), n1 = min(N, n0 + chunk);
  int lw = 0, ls = 0;
  for (int n = n0; n < n1; ++n) {
    lw += cnt_w[n];
    ls += cnt_s[n];
  }
  scan_w[tid] = lw;
  scan_s[tid] = ls;
  for (int off = 1; off < kBlock; off <<= 1) {
    __syncthreads();
    const int a = tid >= off ? scan_w[tid - off] : 0;
    const int b = tid >= off ? scan_s[tid - off] : 0;
    __syncthreads();
    scan_w[tid] += a;
    scan_s[tid] += b;
  }
  __syncthreads();
  int ow = scan_w[tid] - lw, os = scan_s[tid] - ls;
  const int M = scan_w[kBlock - 1], P = scan_s[kBlock - 1];
  for (int n = n0; n < n1; ++n) {
    for (int e = 0; e < nseg[n]; ++e) {
      const int idx = n * E + e;
      const int kind = ep_kind[idx];
      if (kind & 1) {
        list_w[ow] = idx;
        key_w[ow++] = ep_seed[idx];
      }
      if (kind & 2) {
        list_s[os] = idx;
        key_s[os++] = min(max(ep_seed[idx] - fp.base, 0), N - 1);
      }
    }
  }
  __syncthreads();

  // 3. the EWA fold: the thread of a seed's last episode folds the seed
  for (int j = tid; j < M; j += kBlock) {
    const int s = key_w[j];
    bool last = true;
    for (int i = j + 1; i < M && last; ++i) last = key_w[i] != s;
    if (!last) continue;
    int K = 0;
    for (int i = 0; i <= j; ++i) K += key_w[i] == s;
    float c = 0.0f, gmax = -INFINITY;
    int rank = 0;
    for (int i = 0; i <= j; ++i) {
      if (key_w[i] != s) continue;
      const int idx = list_w[i];
      const float wgt = __fmul_rn(
          fp.alpha, powf(fp.one_minus_alpha, (float)(K - 1 - rank)));
      c = __fadd_rn(c, __fmul_rn(wgt, ep_total[idx]));
      gmax = fmaxf(gmax, ep_ret[idx]);
      ++rank;
    }
    const float decay = powf(fp.one_minus_alpha, (float)K);
    scores[s] = __fadd_rn(__fmul_rn(decay, scores[s]), c);
    unseen[s] = 0.0f;
    grounded[s] = fmaxf(grounded[s], gmax);
    if (fp.staleness_on) staleness[s] = 0.0f;
  }

  // 4. the staged levels' step-weighted mean scores and episode counts
  for (int i = tid; i < N; i += kBlock) {
    float sum = 0.0f, cnt = 0.0f, epi = 0.0f;
    for (int j = 0; j < P; ++j) {
      if (key_s[j] != i) continue;
      const int idx = list_s[j];
      sum = __fadd_rn(sum, __fmul_rn(ep_total[idx], ep_cnt[idx]));
      cnt = __fadd_rn(cnt, ep_cnt[idx]);
      epi = __fadd_rn(epi, 1.0f);
    }
    staged_scores[i] = __fdiv_rn(sum, fmaxf(cnt, 1.0f));
    staged_counts[i] = epi;
  }
}

// Element j of a level as the hash reads it: a byte, or a float32 value
// truncated toward zero (JAX's astype(uint32); the twin's int64 cast).
__device__ __forceinline__ uint32_t level_elem(const uint8_t* p, int j,
                                              int is_float) {
  if (!is_float) return p[j];
  return (uint32_t)(long long)reinterpret_cast<const float*>(p)[j];
}

// Two 32-bit hash lanes of each level: levels a[0..na) then b[0..nb), L
// elements each (bytes, or float32 values with is_float).
__global__ void level_hash_kernel(const uint8_t* a, int na, const uint8_t* b,
                                  int L, int is_float, uint32_t m1,
                                  uint32_t m2, uint32_t* hash) {
  __shared__ uint32_t r1[kHashThreads], r2[kHashThreads];
  const int lv = blockIdx.x, tid = threadIdx.x;
  const size_t bytes = (size_t)L * (is_float ? 4 : 1);
  const uint8_t* p = lv < na ? a + (size_t)lv * bytes
                             : b + (size_t)(lv - na) * bytes;
  uint32_t s1 = 0u, s2 = 0u;
  for (int j = tid; j < L; j += kHashThreads) {
    const uint32_t v = level_elem(p, j, is_float);
    s1 += v * ((uint32_t)j * m1 + 1u);
    s2 += v * ((uint32_t)j * m2 + 1u);
  }
  r1[tid] = s1;
  r2[tid] = s2;
  for (int s = kHashThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (tid < s) {
      r1[tid] += r1[tid + s];
      r2[tid] += r2[tid + s];
    }
  }
  if (tid == 0) {
    hash[2 * lv] = r1[0];
    hash[2 * lv + 1] = r2[0];
  }
}

struct PromoteParams {
  int S, N, L, dedup, reject, replay_support;   // L: bytes a level
  float alpha, one_minus_alpha;
  WeightParams wp;
};

__global__ void promote_kernel(
    const uint32_t* hash, uint8_t* levels, float* scores, float* unseen,
    uint8_t* filled, uint8_t* solvable, float* staleness, float* grounded,
    int* num_edits, int* slot_ids, int* next_id, float* sample_count,
    const uint8_t* st_levels, const float* st_scores, const float* st_counts,
    const uint8_t* st_solvable, const int* st_edits, float* fws, int* iws,
    PromoteParams pp) {
  __shared__ float red[kBlock], tile[kBlock];
  const int tid = threadIdx.x;
  const int S = pp.S, N = pp.N, L = pp.L;
  const int SN = S > N ? S : N;
  float* prio = fws;
  float* key = fws + S;
  float* tmp = fws + S + SN;
  int* pos = iws;
  int* evict = iws + SN;
  int* empty = evict + S;
  int* valid = empty + S;
  int* dup = valid + N;
  int* target = dup + N;
  int* accept = target + N;
  const int id0 = next_id[0];

  // 1. validity and duplicates of filled slots
  for (int i = tid; i < N; i += kBlock) {
    const bool ok = st_counts[i] > 0.0f && (!pp.reject || st_solvable[i]);
    int d = -1;
    if (pp.dedup && ok) {
      const uint32_t h1 = hash[2 * (S + i)], h2 = hash[2 * (S + i) + 1];
      for (int s = 0; s < S; ++s) {
        if (filled[s] && hash[2 * s] == h1 && hash[2 * s + 1] == h2) {
          d = s;
          break;
        }
      }
    }
    dup[i] = d;
    valid[i] = ok && d < 0;
  }
  __syncthreads();

  // 2. fold the duplicates; the highest staged index wins a slot
  for (int i = tid; i < N; i += kBlock) {
    const int d = dup[i];
    if (d < 0) continue;
    bool later = false;
    for (int j = i + 1; j < N && !later; ++j) later = dup[j] == d;
    if (!later) {
      scores[d] = __fadd_rn(__fmul_rn(pp.one_minus_alpha, scores[d]),
                            __fmul_rn(pp.alpha, st_scores[i]));
    }
    unseen[d] = 0.0f;
    staleness[d] = 0.0f;
  }
  __syncthreads();

  // 3. eviction priorities of the folded buffer
  if (pp.replay_support) {
    weights_block(scores, staleness, unseen, S, pp.wp, prio, tmp, pos, red,
                  tile);
  } else {
    for (int i = tid; i < S; i += kBlock) prio[i] = scores[i];
    __syncthreads();
  }

  // 4. empty slots in index order, filled ones by ascending priority
  for (int i = tid; i < S; i += kBlock) tmp[i] = filled[i] ? 0.0f : 1.0f;
  __syncthreads();
  const int n_empty = (int)block_sum(tmp, S, red);
  for (int i = tid; i < S; i += kBlock) key[i] = filled[i] ? 1.0f : 0.0f;
  order_positions(key, S, false, pos, tile);
  for (int i = tid; i < S; i += kBlock) {
    if (!filled[i]) empty[pos[i]] = i;
  }
  __syncthreads();
  for (int i = tid; i < S; i += kBlock) key[i] = filled[i] ? prio[i] : INFINITY;
  order_positions(key, S, false, pos, tile);
  for (int i = tid; i < S; i += kBlock) {
    if (filled[i]) evict[pos[i]] = i;
  }
  __syncthreads();

  // 5. the valid staged levels by descending score, take the targets
  for (int i = tid; i < N; i += kBlock) {
    key[i] = valid[i] ? -st_scores[i] : INFINITY;
  }
  order_positions(key, N, false, pos, tile);
  for (int i = tid; i < N; i += kBlock) {
    const int k = pos[i];
    int t = -1, ok = 0;
    if (valid[i] && k < S) {
      const bool use_empty = k < n_empty;
      t = use_empty ? empty[k] : evict[k - n_empty];
      ok = use_empty || scores[t] <= st_scores[i] || unseen[t] > 0.0f ||
           !filled[t];
    }
    target[i] = t;
    accept[i] = ok;
  }
  __syncthreads();

  // 6. the scatter, with insertion ids in staged order
  for (int i = tid; i < N; i += kBlock) {
    if (!accept[i]) continue;
    int c = 0;
    for (int j = 0; j <= i; ++j) c += accept[j];
    const int t = target[i];
    scores[t] = st_scores[i];
    unseen[t] = 0.0f;
    filled[t] = 1;
    solvable[t] = st_solvable[i];
    staleness[t] = 0.0f;
    grounded[t] = kNegInf;
    num_edits[t] = st_edits[i];
    slot_ids[t] = id0 + c - 1;
  }
  for (int f = tid; f < N * L; f += kBlock) {
    const int i = f / L;
    if (accept[i]) levels[(size_t)target[i] * L + f % L] = st_levels[f];
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int i = 0; i < N; ++i) c += accept[i];
    next_id[0] = id0 + c;
    sample_count[0] = __fadd_rn(sample_count[0], (float)N);
  }
}

WeightParams weight_params(int transform, float p, int stale_on,
                           int stale_transform, float stale_p, float e,
                           float coef, float one_minus_coef) {
  WeightParams wp;
  wp.transform = transform;
  wp.p = p;
  wp.stale_on = stale_on;
  wp.stale_transform = stale_transform;
  wp.stale_p = stale_p;
  wp.e = e;
  wp.coef = coef;
  wp.one_minus_coef = one_minus_coef;
  return wp;
}

}  // namespace

// Workspaces: iws 6 N (T + 1) + 3 N ints, fws 3 N (T + 1) floats.  scores,
// unseen, grounded and staleness are updated in place.
extern "C" int dcd_plr_score_fold(
    const void* rewards, const void* values, const void* returns,
    const void* dones, const void* cliffhangers, const void* seeds,
    void* scores, void* unseen, void* grounded, void* staleness,
    void* staged_scores, void* staged_counts, void* iws, void* fws, int T,
    int N, int S, int base, int strategy, int dense, int staleness_on,
    float alpha, float one_minus_alpha, float msc, float one_minus_msc,
    float gamma, void* stream) {
  FoldParams fp;
  fp.T = T;
  fp.N = N;
  fp.S = S;
  fp.base = base;
  fp.strategy = strategy;
  fp.dense = dense;
  fp.staleness_on = staleness_on;
  fp.alpha = alpha;
  fp.one_minus_alpha = one_minus_alpha;
  fp.msc = msc;
  fp.one_minus_msc = one_minus_msc;
  fp.gamma = gamma;
  score_fold_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)rewards, (const float*)values, (const float*)returns,
      (const uint8_t*)dones, (const uint8_t*)cliffhangers, (const int*)seeds,
      (float*)scores, (float*)unseen, (float*)grounded, (float*)staleness,
      (float*)staged_scores, (float*)staged_counts, (int*)iws, (float*)fws,
      fp);
  return (int)cudaGetLastError();
}

// tmp: S floats, pos: S ints.
extern "C" int dcd_plr_sample_weights(
    const void* scores, const void* staleness, const void* unseen, void* w,
    void* tmp, void* pos, int S, int transform, float p, int stale_on,
    int stale_transform, float stale_p, float e, float coef,
    float one_minus_coef, void* stream) {
  sample_weights_kernel<<<1, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)staleness, (const float*)unseen,
      (float*)w, (float*)tmp, (int*)pos, S,
      weight_params(transform, p, stale_on, stale_transform, stale_p, e, coef,
                    one_minus_coef));
  return (int)cudaGetLastError();
}

// The buffer arrays are updated in place; a level is L bytes, or with
// is_float L float32 values (the walker's).  hash: 2 (S + N) uint32;
// fws: S + 2 max(S, N) floats; iws: max(S, N) + 2 S + 4 N ints.  With
// dedup off the hash kernel does not run.
extern "C" int dcd_plr_promote(
    void* levels, void* scores, void* unseen, void* filled, void* solvable,
    void* staleness, void* grounded, void* num_edits, void* slot_ids,
    void* next_id, void* sample_count, const void* st_levels,
    const void* st_scores, const void* st_counts, const void* st_solvable,
    const void* st_edits, void* hash, void* fws, void* iws, int S, int N,
    int L, int is_float, int dedup, int reject, int replay_support,
    int transform, float p,
    int stale_on, int stale_transform, float stale_p, float e, float coef,
    float one_minus_coef, float alpha, float one_minus_alpha, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dedup) {
    level_hash_kernel<<<S + N, kHashThreads, 0, st>>>(
        (const uint8_t*)levels, S, (const uint8_t*)st_levels, L, is_float,
        0x9E3779B1u, 0x85EBCA77u, (uint32_t*)hash);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  PromoteParams pp;
  pp.S = S;
  pp.N = N;
  pp.L = L * (is_float ? 4 : 1);
  pp.dedup = dedup;
  pp.reject = reject;
  pp.replay_support = replay_support;
  pp.alpha = alpha;
  pp.one_minus_alpha = one_minus_alpha;
  pp.wp = weight_params(transform, p, stale_on, stale_transform, stale_p, e,
                        coef, one_minus_coef);
  promote_kernel<<<1, kBlock, 0, st>>>(
      (const uint32_t*)hash, (uint8_t*)levels, (float*)scores, (float*)unseen,
      (uint8_t*)filled, (uint8_t*)solvable, (float*)staleness,
      (float*)grounded, (int*)num_edits, (int*)slot_ids, (int*)next_id,
      (float*)sample_count, (const uint8_t*)st_levels,
      (const float*)st_scores, (const float*)st_counts,
      (const uint8_t*)st_solvable, (const int*)st_edits, (float*)fws,
      (int*)iws, pp);
  return (int)cudaGetLastError();
}
