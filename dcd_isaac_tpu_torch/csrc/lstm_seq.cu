// The LSTM recurrence of BPTT: forward, and a backward that recomputes the
// gates, each pass one persistent launch.
//
// Replaces dcd_isaac_tpu/models/common.py:RNNCore.sequence_zx (:125-154),
// the scan the PPO update runs through the students' and the teacher's
// LSTM-256 (and the students' remat scan, models/multigrid_models.py
// :154-165), with its VJP.  Per step t, with m_t the (N,) mask, W_h the
// (4H, H) recurrent weight in PyTorch's Linear layout and b its bias:
//   cp = m_t * c_{t-1},  hp = m_t * h_{t-1}
//   z  = (hp @ W_h^T + b) + zx_t                  gates i, f, g, o
//   c_t = sigmoid(f) * cp + sigmoid(i) * tanh(g),  h_t = sigmoid(o) * tanh(c_t)
// The backward, step t from T - 1 down to 0, recomputes z_t from the saved
// carries and takes
//   dh_t = dh_out_t + m_{t+1} * (dz_{t+1} @ W_h)          (K = 4H)
// then the cell's VJP, which writes dz_t into dzx and carries
// dc_{t-1} = m_t * f * (dc_t + dh_t * o * (1 - tanh(c_t)^2)); after step 0
// the carry is d(c0), and one more product gives d(h0) = m_0 * (dz_0 @ W_h).
// dW_h and db are one large matmul over the stored tensors, outside this
// file.
//
// What bounds it on the H100.  Per step the products are 2 N H 4H
// operations (the backward twice that), 256 steps that depend on each
// other: at N = 8192 the forward's 1.10e12 operations take 16.4 ms on the
// CUDA cores in fp32 and about 6.7 ms as three TF32 products on the tensor
// cores; at N = 32 a step is 8.4 M operations, far too few to fill the
// card, so the steps' latency and their synchronisation set the pace.
// The card holds 7 clusters of 16 CTAs at once (112 of its 132 SMs), so
// at N = 8192 the forward runs 37 waves of 256 dependent steps.
//
// Design.  Rows never interact, so a cluster of C = H / 16 CTAs owns a
// block of BM rows for all T steps and clusters never wait for each other:
// one launch a pass, the step loop inside the kernel.  CTA `rank` of the
// cluster owns hidden units 16 rank .. 16 rank + 15, that is 64 gate
// columns (4 gates of 16 units), and loads its slice of W_h (64 x H) from
// device memory once a pass, already split into TF32 hi and lo planes in
// shared memory (128 KB at H = 256).  The products are 3xTF32 on
// mma.sync.m16n8k8, as in teacher_proj.cu: each fp32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and each product taken as
// hi hi + hi lo + lo hi in fp32 accumulators, an error of about 2^-21 of
// the product's scale; only the step's own operand (h_{t-1}, or the
// backward's dz_{t+1}) is split each step, in registers.  A warp's
// accumulators collect at most 128 reduction terms before they are folded
// with rounded adds.
//
// Row groups.  A CTA's BM rows are G = BM / 16 groups of 16 rows, each
// run by 8 / G warps on its own: its own buffers, mbarriers and named
// barrier, so that while one group waits for its exchange the other's
// products run.  A group's warps split the gate product's K (H) in KS
// parts of whole 16-blocks (KS = 4 at BM = 16, 2 at BM = 32), summed in a
// fixed order through shared memory; then every warp runs the cell for
// 4 / KS of its lanes' accumulator cells (rows g, g + 8, units u, u + 1),
// with c (and the backward's dc) in registers across steps.  The W planes'
// rows are swizzled (swz) so that both products' 16-byte fragment loads
// are free of bank conflicts without padding.
//
// Forward: after step t every CTA needs the whole (masked) h_t of its rows.
// Each CTA writes its slice into its own double buffer of h and copies it
// into every other CTA's with one bulk copy each (cp.async.bulk between
// the cluster's shared memories), counted by the receiver's mbarrier
// (complete_tx): a CTA waits for the bytes of all C - 1 slices, so there
// is no cluster barrier in the step loop.  The double buffer needs no
// signal back: a CTA sends h_{t+1} only after it has received h_t from
// every CTA, that is after every CTA has finished reading buffer t + 1
// mod 2 (h_{t-1}).
//
// Backward: each CTA recomputes z_t for its 64 gate columns from h_{t-1},
// which it copies (cp.async, one step ahead) from the saved h_all, and
// forms its part of dz_{t+1} @ W_h from the dz_{t+1} of its own columns and
// the W_h slice it already holds: a (BM, H) partial.  Unit u's partials go
// by st.async (16 bytes a lane) to the CTA that owns u, which sums the C
// partials in rank order, so the run is deterministic (no float atomics).
// A second mbarrier in each CTA counts the C CTAs that have read their
// partials of a step (a 4-byte st.async token from each), and a CTA waits
// for it before it sends the next step's.
//
// N need not be a multiple of BM: rows past N are zeros that are computed
// but never written.  BM is chosen by N (dcd_lstm_seq_plan): 16 (one
// group of 8 warps) while the clusters fit on the card at once, else 32
// (two groups of 4 warps), whose exchanges overlap the other group's
// products.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kUnits = 16;        // hidden units of a CTA
constexpr int kCols = 4 * kUnits; // gate columns of a CTA
constexpr int kMaxH = 256;        // C = H / 16 <= 16 CTAs a cluster
constexpr int kLdz = kCols + 4;   // row stride of the backward's dz tile
// A group's h buffers are slice-major: the 16 x 16 block of units
// 16 r .. 16 r + 15 at [r][row][0..15], so that a CTA's slice is one
// contiguous bulk copy of 16 * kSlice floats, and a quarter-warp's 16-byte
// fragment loads (rows g, g + 1, k 4t .. 4t + 3) hit 32 banks.
constexpr int kSlice = 16;

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// Tensor cores, as in teacher_proj.cu.

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// d += a b for one 16 x 8 x 8 TF32 tile (a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0, d1
// (g, 2t, 2t + 1), d2, d3 (g + 8, ...), for lane 4 g + t).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// The A fragment of a 16 x 8 tile at p (row stride ld floats), split.
__device__ __forceinline__ void load_a(const float* p, int ld,
                                      uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h = tf32_rna(v[i]);
    hi[i] = bits(h);
    lo[i] = bits(tf32_rna(v[i] - h));
  }
}

// The three products of one tile: big += ah bh, small += ah bl + al bh.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(big, ah, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(small, al, bh);
}

// ---------------------------------------------------------------------------
// Clusters and mbarriers.

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared variable in the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t remote(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// This CTA's one arrival at `bar`, and the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of `bar` with this parity has completed; what the
// cluster wrote before it completed is visible after.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// A 4-byte token into CTA `rank`'s shared memory at p's offset, counted by
// that CTA's barrier at bar's offset: a signal without a memory fence.
__device__ __forceinline__ void send_token(float* p, uint64_t* bar,
                                          uint32_t rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n"
      :: "r"(remote(smem_addr(p), rank)), "r"(0u),
         "r"(remote(smem_addr(bar), rank))
      : "memory");
}

// (x, y, z, w) into CTA `rank`'s shared memory at p's offset (16-byte
// aligned), counted by that CTA's barrier at bar's offset.
__device__ __forceinline__ void send4(float* p, uint64_t* bar, uint32_t rank,
                                     float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(remote(smem_addr(p), rank)), "f"(v.x), "f"(v.y), "f"(v.z),
         "f"(v.w), "r"(remote(smem_addr(bar), rank))
      : "memory");
}

// `bytes` (a multiple of 16) of this CTA's shared memory at p copied to
// the same offset in CTA `rank`, counted by that CTA's barrier at bar's
// offset: one bulk copy.  The writes to p must precede it through
// fence.proxy.async.
__device__ __forceinline__ void send_bulk(float* p, uint64_t* bar,
                                          uint32_t rank, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n"
      :: "r"(remote(smem_addr(p), rank)), "r"(smem_addr(p)), "r"(bytes),
         "r"(remote(smem_addr(bar), rank))
      : "memory");
}

// The generic proxy's writes to shared memory made visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The pieces both passes share.

// Shared memory of a CTA, in floats from the dynamic base: W_h's two
// planes, then one region for each of the G = BM / 16 row groups.  A group
// is 16 rows and 8 / G warps, which run the steps of those rows on their
// own (their own buffers, mbarriers and named barrier), so that one
// group's exchange overlaps another's products.
template <int BM>
struct Layout {
  static constexpr int G = BM / 16;             // row groups
  static constexpr int WG = 8 / G;              // warps of a group
  static constexpr int KS = WG / 2;             // K parts of its warps
  static constexpr int kRed = KS * 2 * 32 * 16;
  int ldw, w, group, h, dz, red, recv, tok, bars, floats;
  __host__ __device__ Layout(int H, bool backward) {
    ldw = H;               // rows swizzled (swz): no padding
    w = kCols * ldw;       // floats of a plane; the groups follow the two
    // within a group: the forward's double buffer of h, the backward's
    // single one, its dz tile, the K parts, the dh parts received and the
    // tokens that signal they were read
    h = 0;
    dz = h + (backward ? 1 : 2) * 16 * H;
    red = dz + (backward ? 16 * kLdz : 0);
    recv = red + kRed;
    tok = recv + (backward ? (H / kUnits) * 16 * kUnits : 0);
    bars = tok + (backward ? kMaxH / kUnits : 0);
    group = bars + 4;      // two mbarriers
    floats = 2 * w + G * group;
  }
};

// Which group, unit group and K part a warp takes: warp w is in group
// w / WG; within it, unit group s = w % 2 (units 8 s .. 8 s + 7 of the
// CTA's 16) and K part ks = (w % WG) / 2.  A lane (g, t) of a warp of
// part 0 runs the cell for rows g, g + 8 of its group and units u, u + 1.
template <int BM>
struct Role {
  int grp, wl, s, ks, g, t, u, gtid;   // gtid: thread index in the group
  __device__ Role() {
    constexpr int WG = Layout<BM>::WG;
    const int warp = threadIdx.x / 32;
    grp = warp / WG;
    wl = warp % WG;
    s = wl % 2;
    ks = wl / 2;
    g = (threadIdx.x % 32) / 4;
    t = threadIdx.x % 4;
    u = 8 * s + 2 * t;
    gtid = threadIdx.x % (WG * 32);
  }
};

// The named barrier of the group's warps.
template <int BM>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n"
               :: "r"(1 + grp), "r"(Layout<BM>::WG * 32) : "memory");
}

// Row j of a W plane keeps element k at column k ^ swz(j), the 8-float
// blocks of each 32 permuted by j's two low bits.  Both products read a
// plane with 16-byte loads, 8 lanes a shared-memory wavefront: the gate
// product rows 8 s + g, g = 0, 1 (or 2, 3), columns k .. k + 15; the dh
// product rows k + t, t = 0..3, columns 4 g .. 4 g + 7 of a 32-block.  With
// the swizzle each wavefront's 8 loads hit all 32 banks.
__device__ __forceinline__ int swz(int j) {
  return ((j & 1) << 4) | ((j & 2) << 2);
}

// The CTA's slice of W_h, rows (gate q, unit 16 rank + u) for
// q * 16 + u, split into the hi and lo planes.
__device__ __forceinline__ void load_w(const float* __restrict__ w_h,
                                       float* whi, float* wlo, int ldw, int H,
                                       int u0) {
  const int per_row = H / 4;
  for (int i = threadIdx.x; i < kCols * per_row; i += kThreads) {
    const int j = i / per_row, k = (i % per_row) * 4;
    const int grow = (j / kUnits) * H + u0 + j % kUnits;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        w_h + (size_t)grow * H + k));
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                                 tf32_rna(v.w));
    const int o = j * ldw + (k ^ swz(j));
    *reinterpret_cast<float4*>(whi + o) = h;
    *reinterpret_cast<float4*>(wlo + o) =
        make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                    tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
  }
}

// v's TF32 parts, lane by lane, after scaling by m.
__device__ __forceinline__ void split4(float4 v, float m, float4& h,
                                       float4& l) {
  v = make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
  h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  l = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                  tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
}

// z (16 rows x 64 columns) = (m * A) @ W_slice^T over the warp's K part:
// the 4 gates' n-tiles of unit group s (units 8 s .. 8 s + 7), k in
// [k0, k1), k1 - k0 a multiple of 16; A slice-major.  For each 16-deep
// block a lane (g, t) loads k = 4t .. 4t + 3 of its rows of A and of W_h
// with one 16-byte load each: the k-slots t and t + 4 of the block's step
// j are k = 4t + 2j and 4t + 2j + 1, the same permutation of the block's
// k for both operands.  The three products go to three accumulator sets,
// so that no mma waits on the one before it.  Result per gate q in
// z[q][0..3], the accumulator layout (rows g, g + 8; units 8 s + 2 t,
// + 1).
__device__ __forceinline__ void gate_product(const float* a, int ldw,
                                             const float* whi,
                                             const float* wlo, int s, int k0,
                                             int k1, float mg, float mg8,
                                             float (&z)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float acc[3][4][4];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[p][q][r] = 0.0f;
  const float* ap = a + g * kSlice + 4 * t;
  const int wrow = (8 * s + g) * ldw, wsw = swz(g);
#pragma unroll 2
  for (int k = k0; k < k1; k += 16) {
    const float* ak = ap + (k >> 4) * 16 * kSlice;
    float4 xh, xl, yh, yl;
    split4(*reinterpret_cast<const float4*>(ak), mg, xh, xl);
    split4(*reinterpret_cast<const float4*>(ak + 8 * kSlice), mg8, yh, yl);
    float4 wh[4], wl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = q * kUnits * ldw + wrow + ((k + 4 * t) ^ wsw);
      wh[q] = *reinterpret_cast<const float4*>(whi + o);
      wl[q] = *reinterpret_cast<const float4*>(wlo + o);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t ah[4] = {bits(j ? xh.z : xh.x), bits(j ? yh.z : yh.x),
                              bits(j ? xh.w : xh.y), bits(j ? yh.w : yh.y)};
      const uint32_t al[4] = {bits(j ? xl.z : xl.x), bits(j ? yl.z : yl.x),
                              bits(j ? xl.w : xl.y), bits(j ? yl.w : yl.y)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bh[2] = {bits(j ? wh[q].z : wh[q].x),
                                bits(j ? wh[q].w : wh[q].y)};
        mma_tf32(acc[0][q], ah, bh);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bl[2] = {bits(j ? wl[q].z : wl[q].x),
                                bits(j ? wl[q].w : wl[q].y)};
        mma_tf32(acc[1][q], ah, bl);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bh[2] = {bits(j ? wh[q].z : wh[q].x),
                                bits(j ? wh[q].w : wh[q].y)};
        mma_tf32(acc[2][q], al, bh);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      z[q][r] = __fadd_rn(acc[0][q][r], __fadd_rn(acc[1][q][r],
                                                  acc[2][q][r]));
}

// The K parts' z of a group: every warp stores its own, and after the
// group's barrier each lane adds, in the order of the parts, the z of its
// cells: NC = 4 / KS of the accumulator layout's 4 (rows g, g + 8; units
// u, u + 1), cells d0 .. d0 + NC - 1 with d0 = ks * NC, so that every warp
// of the group runs a share of the cells.
template <int BM>
struct Cells {
  static constexpr int KS = Layout<BM>::KS, NC = 4 / KS;
  int d0, ri, lr, u;   // first cell, its row (0: g, 1: g + 8), the local
                       // row and the first unit of the cells
  __device__ explicit Cells(const Role<BM>& R) {
    d0 = R.ks * NC;
    ri = d0 / 2;
    lr = R.g + 8 * ri;
    u = R.u + d0 % 2;
  }
};

__device__ __forceinline__ void store_part(float* red, int slot,
                                           const float (&z)[4][4]) {
  float4* p = reinterpret_cast<float4*>(red) + slot * 4 * 32 +
              threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    p[q * 32] = make_float4(z[q][0], z[q][1], z[q][2], z[q][3]);
}

template <int BM>
__device__ __forceinline__ void sum_parts(const float* red, int s, int d0,
                                          float (&zs)[4][Cells<BM>::NC]) {
  constexpr int KS = Layout<BM>::KS, NC = Cells<BM>::NC;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* p = red + ((((ks * 2 + s) * 4 + q) * 32) +
                              threadIdx.x % 32) * 4 + d0;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        zs[q][j] = ks ? __fadd_rn(zs[q][j], p[j]) : p[j];
    }
  }
}

// NC consecutive floats from / to p (8-byte aligned when NC is 2).
template <int NC>
__device__ __forceinline__ void load_n(const float* p, float (&v)[NC]) {
  if constexpr (NC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int NC>
__device__ __forceinline__ void store_n(float* p, const float (&v)[NC]) {
  if constexpr (NC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// ---------------------------------------------------------------------------
// Forward.

template <int BM>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(
    const float* __restrict__ zx, const float* __restrict__ masks,
    const float* __restrict__ w_h, const float* __restrict__ b,
    const float* __restrict__ c0, const float* __restrict__ h0,
    float* __restrict__ c_all, float* __restrict__ h_all, int T, int N,
    int H) {
  extern __shared__ __align__(16) float sm[];
  const Layout<BM> L(H, false);
  constexpr int KS = Layout<BM>::KS, GT = Layout<BM>::WG * 32;
  constexpr int NC = Cells<BM>::NC;
  const Role<BM> R;
  const Cells<BM> E(R);
  float* whi = sm;
  float* wlo = sm + L.w;
  float* gb = sm + 2 * L.w + R.grp * L.group;
  float* hbuf = gb + L.h;
  float* red = gb + L.red;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gb + L.bars);
  const int C = H / kUnits;
  const uint32_t rank = cluster_rank();
  const int row0 = cluster_id() * BM + 16 * R.grp, u0 = rank * kUnits;
  // the warp's K part: whole 16-blocks, the H / 16 split as evenly as they go
  const int k0 = 16 * (R.ks * (H / 16) / KS),
            k1 = 16 * ((R.ks + 1) * (H / 16) / KS);
  const size_t NH = (size_t)N * H, N4H = 4 * NH;
  // a step's bytes from the C - 1 other CTAs' slices
  const uint32_t slice_bytes = 16u * kSlice * 4;
  const uint32_t step_bytes = (C - 1) * slice_bytes;

  if (R.gtid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_w(w_h, whi, wlo, L.ldw, H, u0);
  for (int i = R.gtid; i < 16 * H; i += GT) {
    const int r = i / H, k = i % H, row = row0 + r;
    hbuf[((k >> 4) * 16 + r) * kSlice + (k & 15)] =
        row < N ? h0[(size_t)row * H + k] * masks[row] : 0.f;
  }
  // The lane's cells: row `row`, units u0 + E.u .. + NC - 1.
  const int row = row0 + E.lr;
  const bool in = row < N;
  const size_t cell = (size_t)row * H + u0 + E.u;
  float c[NC], bias[4][NC];
  float m_cur = in ? masks[row] : 0.f;
  if (in) {
    load_n(c0 + cell, c);
  } else {
#pragma unroll
    for (int j = 0; j < NC; ++j) c[j] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) load_n(b + q * H + u0 + E.u, bias[q]);
  cluster_sync();

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (R.gtid == 0 && t + 1 < T) mbar_expect(&bars[buf ^ 1], step_bytes);
    // This step's zx and the next step's mask, in flight over the product.
    float zxv[4][NC];
    const float m_nxt = in && t + 1 < T ? masks[(size_t)(t + 1) * N + row]
                                        : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (in) {
        load_n(zx + t * N4H + (size_t)row * 4 * H + q * H + u0 + E.u,
               zxv[q]);
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) zxv[q][j] = 0.f;
      }
    }
    if (t > 0) mbar_wait(&bars[buf], ((t - 1) >> 1) & 1);
    float z[4][4];
    // hbuf holds m_t * h_{t-1}: the sender masked it.
    gate_product(hbuf + buf * 16 * H, L.ldw, whi, wlo, R.s, k0, k1,
                 1.f, 1.f, z);
    store_part(red, R.ks * 2 + R.s, z);
    group_sync<BM>(R.grp);
    float zs[4][NC], hv[NC], hm[NC];
    sum_parts<BM>(red, R.s, E.d0, zs);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float gi = sigm((zs[0][j] + bias[0][j]) + zxv[0][j]);
      const float gf = sigm((zs[1][j] + bias[1][j]) + zxv[1][j]);
      const float gg = tanhf((zs[2][j] + bias[2][j]) + zxv[2][j]);
      const float go = sigm((zs[3][j] + bias[3][j]) + zxv[3][j]);
      c[j] = gf * (c[j] * m_cur) + gi * gg;
      hv[j] = go * tanhf(c[j]);
      hm[j] = hv[j] * m_nxt;
    }
    if (in) {
      store_n(c_all + t * NH + cell, c);
      store_n(h_all + t * NH + cell, hv);
    }
    if (t + 1 < T) {
      // m_{t+1} * h_t: this CTA's slice of buffer t + 1 mod 2, then one
      // bulk copy of it into each other CTA's
      float* slice = hbuf + (buf ^ 1) * 16 * H + rank * 16 * kSlice;
      store_n(slice + E.lr * kSlice + E.u, hm);
      fence_proxy_async();
      group_sync<BM>(R.grp);
      if (R.gtid < C && R.gtid != (int)rank)
        send_bulk(slice, &bars[buf ^ 1], R.gtid, slice_bytes);
    }
    m_cur = m_nxt;
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// Backward.

// The group's part of dz @ W_h: P (16 x H) = dz_own (16 x 64) @ W_slice
// (64 x H), warp wl of the group taking the 32-unit blocks wl + j * WG of
// the H / 32.  A block is four n-tiles: tile e's column n is unit 4 n + e
// of the block, so that a lane's B fragments of all four (units 4 g ..
// 4 g + 3 of W rows k + t and k + t + 4) are two 16-byte loads a plane,
// and its accumulators hold units 8 t .. 8 t + 7 of rows g and g + 8.
// Once ready() has returned, each lane sends those as four 16-byte
// stores to the CTA that owns the units, into its recv[rank] (16 x 16) of
// the same group.
template <int BM, typename Ready>
__device__ __forceinline__ void send_dh_parts(const float* dzb,
                                              const float* whi,
                                              const float* wlo, int ldw,
                                              int H, float* recv,
                                              uint64_t* bar, uint32_t rank,
                                              int wl, Ready&& ready) {
  constexpr int WG = Layout<BM>::WG, NB = 8 / WG;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int blocks = H / 32;
  float big[NB][4][4], small[NB][4][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int r = 0; r < 4; ++r) big[j][e][r] = small[j][e][r] = 0.0f;
  const float* ap = dzb + g * kLdz + t;
  const int wsw = swz(t);   // rows k + t and k + t + 4, k a multiple of 8
#pragma unroll
  for (int k = 0; k < kCols; k += 8) {
    uint32_t ah[4], al[4];
    load_a(ap + k, kLdz, ah, al);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int n = wl + j * WG;
      if (n < blocks) {
        const int o = (k + t) * ldw + ((32 * n + 4 * g) ^ wsw);
        const float4 h0 = *reinterpret_cast<const float4*>(whi + o);
        const float4 h1 = *reinterpret_cast<const float4*>(whi + o + 4 * ldw);
        const float4 l0 = *reinterpret_cast<const float4*>(wlo + o);
        const float4 l1 = *reinterpret_cast<const float4*>(wlo + o + 4 * ldw);
        const float hv[2][4] = {{h0.x, h0.y, h0.z, h0.w},
                                {h1.x, h1.y, h1.z, h1.w}};
        const float lv[2][4] = {{l0.x, l0.y, l0.z, l0.w},
                                {l1.x, l1.y, l1.z, l1.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bh[2] = {bits(hv[0][e]), bits(hv[1][e])};
          const uint32_t bl[2] = {bits(lv[0][e]), bits(lv[1][e])};
          mma3(big[j][e], small[j][e], ah, al, bh, bl);
        }
      }
    }
  }
  ready();
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int n = wl + j * WG;
    if (n < blocks) {
      // units 32 n + 8 t .. + 7 belong to CTA 2 n + t / 2, at its 8 (t % 2)
      float v[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[r][e] = __fadd_rn(big[j][e][r], small[j][e][r]);
      const uint32_t to = 2 * n + t / 2;
      float* dst = recv + (rank * 16 + g) * kUnits + 8 * (t % 2);
      send4(dst, bar, to, make_float4(v[0][0], v[0][1], v[0][2], v[0][3]));
      send4(dst + 4, bar, to,
            make_float4(v[1][0], v[1][1], v[1][2], v[1][3]));
      send4(dst + 8 * kUnits, bar, to,
            make_float4(v[2][0], v[2][1], v[2][2], v[2][3]));
      send4(dst + 8 * kUnits + 4, bar, to,
            make_float4(v[3][0], v[3][1], v[3][2], v[3][3]));
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_kernel(
    const float* __restrict__ zx, const float* __restrict__ masks,
    const float* __restrict__ w_h, const float* __restrict__ b,
    const float* __restrict__ c0, const float* __restrict__ h0,
    const float* __restrict__ c_all, const float* __restrict__ h_all,
    const float* __restrict__ dh_all, float* __restrict__ dc,
    float* __restrict__ dzx, float* __restrict__ dh0, int T, int N, int H) {
  extern __shared__ __align__(16) float sm[];
  const Layout<BM> L(H, true);
  constexpr int KS = Layout<BM>::KS, GT = Layout<BM>::WG * 32;
  constexpr int NC = Cells<BM>::NC;
  const Role<BM> R;
  const Cells<BM> E(R);
  float* whi = sm;
  float* wlo = sm + L.w;
  float* gb = sm + 2 * L.w + R.grp * L.group;
  float* hp = gb + L.h;
  float* dzb = gb + L.dz;
  float* red = gb + L.red;
  float* recv = gb + L.recv;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gb + L.bars);
  float* tok = gb + L.tok;
  uint64_t* got = &bars[0];    // all C partials of an exchange arrived
  uint64_t* freed = &bars[1];  // all C CTAs have read an exchange's
  const int C = H / kUnits;
  const uint32_t rank = cluster_rank();
  const int row0 = cluster_id() * BM + 16 * R.grp, u0 = rank * kUnits;
  // the warp's K part: whole 16-blocks, the H / 16 split as evenly as they go
  const int k0 = 16 * (R.ks * (H / 16) / KS),
            k1 = 16 * ((R.ks + 1) * (H / 16) / KS);
  const size_t NH = (size_t)N * H, N4H = 4 * NH;
  const uint32_t step_bytes = 16u * H * 4;
  const int chunks = H / 4;

  // h_{s-1} rows of the group into hp by cp.async (rows past N stay 0).
  auto fetch_h = [&](int s) {
    const float* src = s ? h_all + (size_t)(s - 1) * NH : h0;
    for (int i = R.gtid; i < 16 * chunks; i += GT) {
      const int r = i / chunks, k = (i % chunks) * 4;
      if (row0 + r < N)
        cp_async16(hp + ((k >> 4) * 16 + r) * kSlice + (k & 15),
                   src + (size_t)(row0 + r) * H + k);
    }
    cp_async_commit();
  };

  if (R.gtid == 0) {
    mbar_init(got, 1);
    mbar_init(freed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(got, step_bytes);
    mbar_expect(freed, 4 * C);
  }
  load_w(w_h, whi, wlo, L.ldw, H, u0);
  for (int i = R.gtid; i < 16 * H; i += GT) {
    if (row0 + i / H >= N)
      hp[((i % H >> 4) * 16 + i / H) * kSlice + (i & 15)] = 0.f;
  }
  fetch_h(T - 1);
  // The masks of rows g, g + 8 (the gate product's A operand) and the
  // lane's cells: row `row`, units u0 + E.u .. + NC - 1.
  const int rows[2] = {row0 + R.g, row0 + R.g + 8};
  const int row = row0 + E.lr;
  const bool in = row < N;
  const size_t cell = (size_t)row * H + u0 + E.u;
  float dcv[NC], bias[4][NC], m_cur[2], m_next = 0.f;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
    m_cur[ri] = rows[ri] < N ? masks[(size_t)(T - 1) * N + rows[ri]] : 0.f;
  if (in) {
    load_n(dc + cell, dcv);
  } else {
#pragma unroll
    for (int j = 0; j < NC; ++j) dcv[j] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) load_n(b + q * H + u0 + E.u, bias[q]);
  cluster_sync();

  int e = 0;              // exchanges of dh parts so far
  bool read_parts = false;
  // dh parts of exchange e: their products, then, once every CTA has read
  // exchange e - 1's (the C tokens of freed's phase e - 1), this CTA's
  // sent; the group's first thread arms the phase of exchange e's tokens.
  auto exchange = [&]() {
    send_dh_parts<BM>(dzb, whi, wlo, L.ldw, H, recv, got, rank, R.wl, [&] {
      if (e == 0) return;
      mbar_wait(freed, (e - 1) & 1);
      if (R.gtid == 0 && e + 1 < T) mbar_expect(freed, 4 * C);
    });
  };
  // The sums of the lane's cells in exchange e, in rank order; the group's
  // first thread arms the next.
  auto receive = [&](float (&dhr)[NC]) {
    mbar_wait(got, e & 1);
    if (R.gtid == 0 && e + 1 < T) mbar_expect(got, step_bytes);
    for (int r = 0; r < C; ++r) {
      float v[NC];
      load_n(recv + (r * 16 + E.lr) * kUnits + E.u, v);
#pragma unroll
      for (int j = 0; j < NC; ++j) dhr[j] = r ? dhr[j] + v[j] : v[j];
    }
  };
  auto release = [&]() {
    if (read_parts && R.gtid < C) send_token(tok + rank, freed, R.gtid);
    read_parts = false;
  };

  for (int t = T - 1; t >= 0; --t) {
    cp_async_wait_all();
    group_sync<BM>(R.grp);  // hp holds h_{t-1}, dzb dz_{t+1}; recv was read
    release();
    const bool has_next = t + 1 < T;
    float zxv[4][NC], cprev[NC], dho[NC], m_pre[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
      m_pre[ri] = rows[ri] < N && t > 0
                      ? masks[(size_t)(t - 1) * N + rows[ri]] : 0.f;
    if (in) {
      load_n((t ? c_all + (t - 1) * NH : c0) + cell, cprev);
      load_n(dh_all + t * NH + cell, dho);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        load_n(zx + t * N4H + (size_t)row * 4 * H + q * H + u0 + E.u,
               zxv[q]);
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        cprev[j] = dho[j] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) zxv[q][j] = 0.f;
      }
    }
    float z[4][4];
    // the masks of the lane's rows g, g + 8
    gate_product(hp, L.ldw, whi, wlo, R.s, k0, k1, m_cur[0],
                 m_cur[1], z);
    store_part(red, R.ks * 2 + R.s, z);
    if (has_next) exchange();
    group_sync<BM>(R.grp);  // hp and dzb read, the parts stored
    if (t > 0) fetch_h(t - 1);
    float zs[4][NC], dhr[NC];
    sum_parts<BM>(red, R.s, E.d0, zs);
    if (has_next) {
      receive(dhr);
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) dhr[j] = 0.f;
    }
    const float mc = E.ri ? m_cur[1] : m_cur[0];
    float dzv[4][NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float i = sigm((zs[0][j] + bias[0][j]) + zxv[0][j]);
      const float f = sigm((zs[1][j] + bias[1][j]) + zxv[1][j]);
      const float g = tanhf((zs[2][j] + bias[2][j]) + zxv[2][j]);
      const float o = sigm((zs[3][j] + bias[3][j]) + zxv[3][j]);
      const float cp = cprev[j] * mc;
      const float tc = tanhf(f * cp + i * g);
      const float dh = dho[j] + m_next * dhr[j];
      const float dct = dcv[j] + dh * o * (1.0f - tc * tc);
      dzv[0][j] = dct * g * i * (1.0f - i);
      dzv[1][j] = dct * cp * f * (1.0f - f);
      dzv[2][j] = dct * i * (1.0f - g * g);
      dzv[3][j] = dh * tc * o * (1.0f - o);
      dcv[j] = mc * (dct * f);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      store_n(dzb + E.lr * kLdz + q * kUnits + E.u, dzv[q]);
      if (in)
        store_n(dzx + t * N4H + (size_t)row * 4 * H + q * H + u0 + E.u,
                dzv[q]);
    }
    if (has_next) {
      ++e;
      read_parts = true;
    }
    m_next = mc;
    m_cur[0] = m_pre[0];
    m_cur[1] = m_pre[1];
  }

  // d(h0) = m_0 * (dz_0 @ W_h), and the carry's d(c0).
  group_sync<BM>(R.grp);   // dzb holds dz_0; recv has been read
  release();
  exchange();
  float dhr[NC];
  receive(dhr);
  if (in) {
#pragma unroll
    for (int j = 0; j < NC; ++j) dhr[j] *= m_next;
    store_n(dh0 + cell, dhr);
    store_n(dc + cell, dcv);
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// Plans and launches.

cudaLaunchConfig_t launch_config(int clusters, int C, size_t smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C CTAs of this kernel with `smem` bytes each that the card
// holds at once (0 if none fits).  Sets the kernel's attributes for every
// launch: the shared memory it may take is `smem_max`, its need at
// H = kMaxH, and not `smem`, so that a plan made for a narrower H cannot
// lower the limit under a wider H's launch.
template <typename Kern>
int max_clusters(Kern kern, int C, size_t smem, size_t smem_max) {
  if (cudaFuncSetAttribute((const void*)kern,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_max) != cudaSuccess ||
      cudaFuncSetAttribute((const void*)kern,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, C, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

struct Plan {
  int bm, cluster, max_active, smem;
};

template <int BM>
size_t smem_bytes(int H, bool backward) {
  return (size_t)Layout<BM>(H, backward).floats * sizeof(float);
}

template <int BM>
int occupancy(int H, bool backward) {
  const int C = H / kUnits;
  const size_t smem = smem_bytes<BM>(H, backward);
  const size_t smem_max = smem_bytes<BM>(kMaxH, backward);
  return backward ? max_clusters(lstm_bwd_kernel<BM>, C, smem, smem_max)
                  : max_clusters(lstm_fwd_kernel<BM>, C, smem, smem_max);
}

// BM = 16 while its clusters all fit on the card at once, else 32.
Plan plan(int N, int H, bool backward) {
  static int cache[2][2][kMaxH / 32 + 1] = {};   // [backward][bm 16/32][H/32]
  int* o16 = &cache[backward][0][H / 32];
  int* o32 = &cache[backward][1][H / 32];
  if (*o16 == 0) *o16 = occupancy<16>(H, backward) + 1;
  if (*o32 == 0) *o32 = occupancy<32>(H, backward) + 1;
  const int n16 = *o16 - 1, n32 = *o32 - 1;
  const bool small = n16 > 0 && ((N + 15) / 16 <= n16 || n32 == 0);
  Plan p;
  p.bm = small ? 16 : 32;
  p.cluster = H / kUnits;
  p.max_active = small ? n16 : n32;
  p.smem = (int)(small ? smem_bytes<16>(H, backward)
                       : smem_bytes<32>(H, backward));
  return p;
}

bool supported(int N, int H, const void* const* ptrs, int n_ptrs) {
  if (N < 0 || H <= 0 || H % 32 != 0 || H > kMaxH) return false;
  for (int i = 0; i < n_ptrs; ++i) {
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  }
  return true;
}

template <typename Kern, typename... Args>
int launch(Kern kern, const Plan& p, int N, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  const int clusters = (N + p.bm - 1) / p.bm;
  cudaLaunchConfig_t cfg =
      launch_config(clusters, p.cluster, p.smem, s, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan at (N, H): out[0] BM, out[1] the cluster's CTAs, out[2]
// cudaOccupancyMaxActiveClusters of that kernel, out[3] its shared memory
// in bytes.  Returns cudaErrorInvalidValue for a shape the kernels do not
// take, or when no cluster fits.
extern "C" int dcd_lstm_seq_plan(int N, int H, int backward, void* out) {
  if (N < 0 || H <= 0 || H % 32 != 0 || H > kMaxH)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(N, H, backward != 0);
  int* o = (int*)out;
  o[0] = p.bm;
  o[1] = p.cluster;
  o[2] = p.max_active;
  o[3] = p.smem;
  return p.max_active > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// zx (T, N, 4H), masks (T, N), w_h (4H, H), b (4H,), c0/h0 (N, H)
// -> c_all, h_all (T, N, H): one launch.
extern "C" int dcd_lstm_seq_forward(const void* zx, const void* masks,
                                    const void* w_h, const void* b,
                                    const void* c0, const void* h0,
                                    void* c_all, void* h_all, int T, int N,
                                    int H, void* stream) {
  const void* ptrs[] = {zx, w_h, c0, h0, c_all, h_all};
  if (!supported(N, H, ptrs, 6)) return (int)cudaErrorInvalidValue;
  if (T <= 0 || N == 0) return (int)cudaGetLastError();
  const Plan p = plan(N, H, false);
  if (p.max_active <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fzx = (const float*)zx, *fm = (const float*)masks,
              *fw = (const float*)w_h, *fb = (const float*)b,
              *fc0 = (const float*)c0, *fh0 = (const float*)h0;
  float *fc = (float*)c_all, *fh = (float*)h_all;
  return p.bm == 16 ? launch(lstm_fwd_kernel<16>, p, N, s, fzx, fm, fw, fb,
                             fc0, fh0, fc, fh, T, N, H)
                    : launch(lstm_fwd_kernel<32>, p, N, s, fzx, fm, fw, fb,
                             fc0, fh0, fc, fh, T, N, H);
}

// The forward's inputs and c_all, h_all; dh_all (T, N, H) the gradient of
// h_all; dc (N, H) the gradient of c_T on entry and d(c0) on return; dzx
// (T, N, 4H) and dh0 (N, H) written.  One launch.
extern "C" int dcd_lstm_seq_backward(
    const void* zx, const void* masks, const void* w_h, const void* b,
    const void* c0, const void* h0, const void* c_all, const void* h_all,
    const void* dh_all, void* dc, void* dzx, void* dh0, int T, int N, int H,
    void* stream) {
  const void* ptrs[] = {zx, w_h, c0, h0, c_all, h_all, dh_all, dc, dzx, dh0};
  if (!supported(N, H, ptrs, 10)) return (int)cudaErrorInvalidValue;
  if (T <= 0 || N == 0) return (int)cudaGetLastError();
  const Plan p = plan(N, H, true);
  if (p.max_active <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fzx = (const float*)zx, *fm = (const float*)masks,
              *fw = (const float*)w_h, *fb = (const float*)b,
              *fc0 = (const float*)c0, *fh0 = (const float*)h0,
              *fca = (const float*)c_all, *fha = (const float*)h_all,
              *fdh = (const float*)dh_all;
  float *fdc = (float*)dc, *fdz = (float*)dzx, *fdh0 = (float*)dh0;
  return p.bm == 16
             ? launch(lstm_bwd_kernel<16>, p, N, s, fzx, fm, fw, fb, fc0,
                      fh0, fca, fha, fdh, fdc, fdz, fdh0, T, N, H)
             : launch(lstm_bwd_kernel<32>, p, N, s, fzx, fm, fw, fb, fc0,
                      fh0, fca, fha, fdh, fdc, fdz, fdh0, T, N, H);
}
