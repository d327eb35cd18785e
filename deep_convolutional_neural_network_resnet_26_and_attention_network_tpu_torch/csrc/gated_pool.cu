// Gated-attention MIL pooling, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ops/pallas_pool.py:_pool_kernel (launched by
// _pool_call, public entry gated_attention_pool) of the JAX package, and its
// closed-form custom VJP _pool_bwd (ops/pallas_pool.py:118-149, jnp that XLA
// compiled). For A_raw [T,K], B [T,O], mask [T] and gate w [K], all float32
// and row-major, the forward is:
//
//   act    = softplus(A_raw)
//   gated  = (sigmoid(-10 w) * act + sigmoid(10 w)) * mask
//   A1     = gated / max(sum_T |gated|, 1e-12)
//   M      = A1^T B                  [K, O]
//   A1T    = A1^T                    [K, T]
//   wROIs  = A1^T * B[:, 0]^T        [K, T]
//
// Bound on an H100 SXM: 20 bytes in (A_raw row of 3, B, mask) and 24 bytes
// out (A1T and wROIs for 3 maps) per tile, 44 B/tile: 0.66 us at T = 50000
// at 3.35 TB/s. The arithmetic is a few dozen operations per tile. So the
// kernel is bound by latency: its launch, the loads each tile waits for,
// its exponentials and logarithms, and the sums over T (the L1 denominator
// and M), which every output waits for. No single PyTorch call computes
// this function, so there is no library yardstick.
//
// Forward design (gated_pool_fwd_kernel): one kernel serves the three
// forward entries through a mode (FwdMode), each entry one launch. A block
// has 512 threads and owns tiles [rank * tiles, min(T, (rank + 1) * tiles))
// (the wrapper's partition, ops/gated_pool.py:pool_fwd_partition).
// - A thread owns a tile for all the maps of a pass (kMapGroup at a time, so
//   any K works). It issues all of the tile's loads at once (the A_raw row,
//   so that neighbouring threads read neighbouring rows; B[t, 0]; the mask),
//   takes each map's softplus once (its exponentials, then its
//   logarithms), and keeps gated in registers (kFwdHeld tiles a thread)
//   across the wait for the denominator; a thread with more tiles reloads
//   and recomputes them, from L2.
// - The sums. A map's sums are sum |gated| and sum gated * B[:, o], the
//   columns of its row of the [K, 1+O] table; a pass takes kSlots of them,
//   a few columns of every map of the group (kCols, so any O works; K = 3,
//   O = 1 is one pass). Each thread adds its tiles' terms in tile order,
//   each warp reduce-scatters its sums into shared memory, and the block's
//   last warp sums them over the warps in a fixed order (warp_partials,
//   control_totals: the backward's reduction). Across blocks the sums are
//   taken in rank order 0..C-1 as one sequence of float adds, so that every
//   path gives the same bits from the same blocks:
//   (i)  a thread-block cluster of C <= 16 blocks (C = 1 a plain launch):
//        the blocks read each other's sums through distributed shared
//        memory, so every block holds the totals with no scratch;
//   (ii) a cooperative launch (cudaLaunchCooperativeKernel) of as many
//        blocks as the tiles need, up to kMaxGrid, all co-resident: each
//        block writes its sums to its row of a scratch table, the grid
//        synchronises (cg::this_grid().sync()), and every block (the
//        partials: block 0) stages the rows in shared memory and sums
//        them, so that the one-call entry stays one launch and writes its
//        outputs from registers. A
//        cluster is not used here: at most 16 SMs, and a 16-block cluster
//        made the backward slower at T = 50000 on an H100 (17.4 us against
//        12.6 us for its earlier design of independent blocks).
//   The wrapper picks the path and C by T, from a sweep on an H100. A
//   ticket was measured too, for the partials (a plain launch whose last
//   block, told by an integer counter after __threadfence(), sums the
//   rows): no faster than the cluster or the grid on the H100, and it
//   needs a zeroed integer that outlives a call, which launches on two
//   streams of a device would share. So the cooperative grid was taken.
// - Modes. The one-call entry (kFused) writes M (rank 0), then A1T and wROIs
//   from the gated values it kept. The partials entry (kSums) writes the
//   shard's [K, 1+O] table (rank 0). The finish entry (kOut) is a pure elementwise pass, one tile a thread in
//   blocks of `tiles` threads (the wrapper's 128: a 512-thread block is
//   bound by its SM's issue rate): its denominators and M come from the
//   all-reduced totals with no sum. A1 and
//   M are products with 1 / denom, one reciprocal a map as the backward
//   takes it, not a division a tile; the plain version divides, and the two
//   differ by a rounding (1.2e-7 of A1 at most).
// - Bits. Every product, sum and reciprocal is written with explicit
//   round-to-nearest intrinsics, so the compiler contracts nothing by
//   context: the finish's recomputed gated has the bits of the one kept in
//   registers, and the partials entry sums in the one-call entry's order
//   (both cut T by pool_fwd_partition). So one shard of the split pair gives
//   the one-call entry's outputs bit for bit, and two calls on the same
//   inputs are bit-identical. sum |gated| keeps its fabsf: JAX's L1 norm.
//
// Backward (gated_pool_backward; replaces ops/pallas_pool.py:118 _pool_bwd),
// given the forward's A1T and the cotangents dM [K,O], dA1T [K,T], dwROIs
// [K,T] (each may be absent, a null pointer, which counts as zero and is
// never read):
//
//   da1     = B dM^T + dA1T^T + dwROIs^T * B[:, 0]          [T, K]
//   denom   = max(sum_T gated, 1e-12)   (recomputed; gated >= 0)
//   dgated  = (da1 - sum_T(da1 * A1)) / denom
//   dA_raw  = dgated * sigmoid(-10 w) * mask * sigmoid(A_raw)
//   dB      = A1 dM, plus sum_K dwROIs^T * A1 in column 0
//   dw      = sum_T(dgated act mask) (-10) g1 (1 - g1)
//             + sum_T(dgated mask) 10 g0 (1 - g0)
//
// The mask gets no gradient. Bound: 48 bytes a tile on the training path
// (K = 3, O = 1, dM only: A_raw, B, mask and A1T in, dA_raw and dB out),
// 0.72 us at T = 50000 and 7 ns at the training bags' T <= 500; the floor is
// one launch, about 1 us. So the backward is bound by latency: the launch,
// the loads each tile waits for, the exponentials, logarithms and
// divisions of each tile, and the two sums over T that stand between the
// loads and dA_raw (denom and sum da1 * A1 of each map) and between dA_raw
// and dw (the two dw sums).
//
// Design (gated_pool_bwd_kernel): every entry is one launch of C blocks of
// 512 threads; with C > 1 the C blocks are one thread-block cluster
// (cudaLaunchKernelEx with a cluster dimension), and C = 1 is a plain
// launch of the same kernel, whose cluster is its one block. Block r owns
// tiles [r * tiles, min(T, (r + 1) * tiles)) for every map (the wrapper's
// partition, ops/gated_pool.py:pool_bwd_partition, which keeps every bag
// the training path pools on one block), one tile a thread a round.
// - Phase 1. Each thread issues all of its tile's loads at once (the whole
//   A_raw row, so that neighbouring threads read neighbouring rows; B, the
//   mask, the A1T column, and dM once a pass), then computes everything no
//   sum over T decides (softplus, expf(-A_raw), da1), writes its dB row and
//   adds its terms to the pass's 2K + 1 sums: sum act * mask and sum da1 *
//   A1 of each map, and sum mask (sum gated = g1 sum(act * mask) + g0
//   sum(mask)). The math is staged across the maps (their exponentials,
//   then their logarithms) so that the maps' chains overlap.
// - The sums. Each warp reduce-scatters its sums (9 shuffles for 8 values)
//   into shared memory; the block's last warp, its control warp, sums them
//   over the warps in a fixed order. With C blocks its lanes publish the
//   block's sums in the block's own shared memory, the cluster syncs, and
//   they read the C blocks' sums through distributed shared memory in rank
//   order 0..C-1, so every block holds the same totals with no scratch, no
//   second launch and no float atomics. The control warp's lanes j < K
//   own map j: they compute its gate (its loads issued first), 1 / denom
//   and the table of the split entries, and hand them to the block through
//   shared memory. A bag of at most 480 tiles a block leaves the control
//   warp no tile, so its work runs beside the tile warps'.
// - Phase 2. While the control warp reduces, the tile warps finish
//   sigmoid(A_raw) (the divisions); then each writes dA_raw from the values
//   it kept in registers (kHeld tiles a thread; a thread with more tiles
//   reloads and recomputes them, from L2, which holds the whole input) and
//   adds its terms to the two dw sums of each map, which reduce the same
//   way except that the warps' sums are added over the warps and the
//   cluster in double (see warp_partials); rank 0's owners write dw. With
//   C > 1 a last cluster sync keeps each block's shared memory alive until
//   its peers have read it.
// Maps are taken kMapGroup at a time, each pass compiled for its exact map
// count, so any K works with the values in registers; the main path has K
// = 3. Every product and sum of the backward is written with explicit
// round-to-nearest intrinsics, so the compiler fuses nothing by context: a
// value recomputed in phase 2 (or in the split finish) has the bits of the
// one kept in registers, and the three entries sum in one order.
//
// Split at the reduction (the multi-card mesh, ROADMAP B.1 (b)). When the
// tile axis of a bag is split across ranks, the sums over T become sums
// across ranks. Each kernel is cut where its sums over T meet, one launch
// an entry: gated_pool_forward_partials returns a shard's [K, 1+O] sums,
// the caller all-reduces them, and gated_pool_forward_finish writes M and
// the shard's A1T and wROIs from the totals; gated_pool_backward_partials
// runs phase 1 (the shard's [K, 2] table of denom and sum da1 * A1, its dB)
// and gated_pool_backward_finish phase 2 from the all-reduced table (dA_raw,
// and the shard's part of dw, which the parameter all-reduce sums). With
// the one-call entry's partition and code, a split call on a single shard
// gives the one-call entry's outputs bit for bit. The tables are K * (1+O)
// and K * 2 floats, so an all-reduce moves a few dozen bytes.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch, 0 on success; an entry returns kClusterUnfit (-1) if no
// cluster of its C blocks fits on the card, and a forward entry returns
// kGridUnfit (-2) if its cooperative grid cannot be co-resident.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

// softplus_f(x) from e = expf(-|x|), so that a caller can take the
// exponentials of several values before their logarithms
__device__ __forceinline__ float softplus_of_exp(float x, float e) {
  return log1pf(e) + fmaxf(x, 0.0f);
}

struct Gate {
  float g1, g0;  // sigmoid(-10 w), sigmoid(10 w)
  __device__ explicit Gate(float wk)
      : g1(1.0f / (1.0f + expf(10.0f * wk))),
        g0(1.0f / (1.0f + expf(-10.0f * wk))) {}
};

// ------------------------------------------------------------- backward

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
// maps a pass over the tiles takes at once (a larger K takes more passes);
// each pass is compiled for its exact map count, so a tile's maps are
// straight-line code whose chains the scheduler interleaves
constexpr int kMapGroup = 3;
// Tiles a thread keeps in registers between phase 1 and phase 2: one tile
// of 10 floats (da1, act and expf(-A_raw) of three maps, the mask). 512
// threads may hold 128 registers each; with two tiles held (and their
// loads in flight) ptxas spilled on the H100 build, and the spill cost
// more than it saved. One tile a thread is 512 tiles a block, which covers
// every bag the training path pools (T <= 500, one block); above that
// phase 2 reloads and recomputes a thread's further tiles, whose inputs L2
// holds (T = 50000 is 2.4 MB against its 50 MB).
constexpr int kHeld = 1;
constexpr int kMaxCluster = 16;
constexpr int kClusterUnfit = -1;

enum BwdMode { kBoth = 0, kPartials = 1, kFinish = 2 };

struct BwdArgs {
  const float* a_raw;   // [T, K]
  const float* b;       // [T, O]
  const float* mask;    // [T]
  const float* w;       // [K]
  const float* a1t;     // [K, T]; null in the finish
  const float* dm;      // [K, O], may be null
  const float* da1t;    // [K, T], may be null
  const float* dwr;     // [K, T], may be null
  const float* totals;  // [K, 2], the finish's all-reduced sums
  float* da_raw;        // [T, K]
  float* db;            // [T, O]
  float* dw;            // [K]
  float* stats;         // [K, 2], the partials' output
  int T, K, O, tiles, mode;
};

// sigmoid(x) = 1 / (1 + expf(-x)) from en = expf(-x), as softplus_of_exp
__device__ __forceinline__ float sigmoid_of_exp(float en) {
  return 1.0f / (1.0f + en);
}

// dw[k] from the two sums over T of dgated * act * mask and dgated * mask
// (doubles; see warp_partials)
__device__ __forceinline__ float gate_grad(float g1, float g0, double p_act,
                                           double p_mask) {
  const double a = g1, b = g0;
  return static_cast<float>(p_act * (-10.0) * a * (1.0 - a) +
                            p_mask * 10.0 * b * (1.0 - b));
}

// What phase 2 needs of one tile for the NK maps of a pass; no sum over T
// decides any of it. en = expf(-A_raw), the sigmoid's exponential: the
// division that finishes sigmoid(A_raw) waits for phase 2 (tile_sig).
template <int NK>
struct TileVals {
  float da1[NK];
  float act[NK];
  float en[NK];
  float m;
};

// One tile's loads for maps k0 .. k0 + NK - 1: the A_raw row, the mask, and
// da1[t, k] = B[t] . dM[k] + dA1T[k, t] + dwROIs[k, t] * B[t, 0]; with
// kA1, also A1T's column (for phase 1). Every load is issued before the
// first value is used, so a tile waits for memory once.
template <int NK>
struct TileLoads {
  float x[NK], da1[NK], a1[NK];
  float m;
};

template <int NK, bool kA1>
__device__ __forceinline__ void tile_loads(const BwdArgs& a, int t, int k0,
                                           const float (&dm0)[NK],
                                           TileLoads<NK>& l) {
  const float* row = a.a_raw + (size_t)t * a.K + k0;
  const float* brow = a.b + (size_t)t * a.O;
  float dt[NK], wr[NK];
  l.m = __ldg(a.mask + t);
  const float b0 = __ldg(brow);
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const size_t kt = (size_t)(k0 + j) * a.T + t;
    l.x[j] = __ldg(row + j);
    l.a1[j] = kA1 ? __ldg(a.a1t + kt) : 0.0f;
    dt[j] = a.da1t != nullptr ? __ldg(a.da1t + kt) : 0.0f;
    wr[j] = a.dwr != nullptr ? __ldg(a.dwr + kt) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    float v = 0.0f;
    if (a.dm != nullptr) {
      const float* dmk = a.dm + (size_t)(k0 + j) * a.O;
      v = __fmul_rn(b0, dm0[j]);
#pragma unroll 1
      for (int o = 1; o < a.O; ++o)
        v = __fmaf_rn(__ldg(brow + o), __ldg(dmk + o), v);
    }
    if (a.da1t != nullptr) v = __fadd_rn(v, dt[j]);
    if (a.dwr != nullptr) v = __fmaf_rn(wr[j], b0, v);
    l.da1[j] = v;
  }
}

// act = softplus_f(x) of the NK maps and the sigmoid's exponential, their
// steps taken a stage at a time across the maps (the exponentials, then
// the logarithms), so that the maps' chains overlap
template <int NK>
__device__ __forceinline__ void tile_vals(const TileLoads<NK>& l,
                                          TileVals<NK>& v) {
  float e[NK];
  v.m = l.m;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    e[j] = expf(-fabsf(l.x[j]));
    v.en[j] = expf(-l.x[j]);
    v.da1[j] = l.da1[j];
  }
#pragma unroll
  for (int j = 0; j < NK; ++j) v.act[j] = softplus_of_exp(l.x[j], e[j]);
}

// sigmoid(A_raw) of the NK maps from the tile's exponentials. Its
// divisions (each with a slow-path branch that ends the compiler's
// scheduling block) run after phase 1, where the tile warps wait for the
// control warp's totals anyway.
template <int NK>
__device__ __forceinline__ void tile_sig(const TileVals<NK>& v,
                                         float (&sig)[NK]) {
#pragma unroll
  for (int j = 0; j < NK; ++j) sig[j] = sigmoid_of_exp(v.en[j]);
}

// Phase 1 for tile t from its loads: its values (into v), its terms of the
// pass's sums (s[j] += act * mask, s[NK + j] += da1 * A1 of map j, and
// s[2 NK] += mask; sum gated = g1 sum(act * mask) + g0 sum(mask)), counted
// only if `live`, and, if `live`, this pass's terms of its dB row, added
// to the earlier passes' (A1 dM, plus sum_K dwROIs^T * A1 in column 0)
template <int NK>
__device__ __forceinline__ void phase1_tile(const BwdArgs& a, int t, int k0,
                                            bool live,
                                            const TileLoads<NK>& l,
                                            const float (&dm0)[NK],
                                            TileVals<NK>& v,
                                            float (&s)[2 * NK + 1]) {
  tile_vals(l, v);
  const float m = live ? v.m : 0.0f;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    s[j] = __fmaf_rn(v.act[j], m, s[j]);
    s[NK + j] = __fmaf_rn(live ? v.da1[j] : 0.0f, l.a1[j], s[NK + j]);
  }
  s[2 * NK] = __fadd_rn(s[2 * NK], m);
  if (!live) return;
#pragma unroll 1
  for (int o = 0; o < a.O; ++o) {
    float* dst = a.db + (size_t)t * a.O + o;
    float d = k0 == 0 ? 0.0f : *dst;
    if (a.dm != nullptr) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
        d = __fmaf_rn(l.a1[j],
                      o == 0 ? dm0[j]
                             : __ldg(a.dm + (size_t)(k0 + j) * a.O + o),
                      d);
    }
    if (o == 0 && a.dwr != nullptr) {
      float u = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        u = __fmaf_rn(__ldg(a.dwr + (size_t)(k0 + j) * a.T + t), l.a1[j], u);
      d = __fadd_rn(d, u);
    }
    *dst = d;
  }
}

// Phase 2 for tile t, if `live`: dA_raw from the totals (sum da1 * A1 in
// `sda`, 1 / denom in `inv`), and its terms of sum dgated * act * mask
// (p[j]) and sum dgated * mask (p[NK + j])
template <int NK>
__device__ __forceinline__ void phase2_tile(const BwdArgs& a, int t, int k0,
                                            bool live, const TileVals<NK>& v,
                                            const float (&sig)[NK],
                                            const float (&g1)[NK],
                                            const float (&sda)[NK],
                                            const float (&inv)[NK],
                                            float (&p)[2 * NK]) {
  float dga[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    // dgated * mask, dgated = (da1 - sum da1 * A1) / denom
    const float dgm =
        __fmul_rn(__fmul_rn(__fsub_rn(v.da1[j], sda[j]), inv[j]), v.m);
    const float d = live ? dgm : 0.0f;
    dga[j] = __fmul_rn(__fmul_rn(d, g1[j]), sig[j]);
    p[j] = __fmaf_rn(d, v.act[j], p[j]);
    p[NK + j] = __fadd_rn(p[NK + j], d);
  }
  if (live) {
    float* out = a.da_raw + (size_t)t * a.K + k0;
#pragma unroll
    for (int j = 0; j < NK; ++j) out[j] = dga[j];
  }
}

// The warp's sums of v[0..N), N <= kSlots, as a reduce-scatter: at each
// step a lane sends its partner the half of its values it does not keep,
// so lane l ends with the warp's sum of v[l >> 2] (kSlots = 8 values in 9
// shuffles, where a shuffle tree per value takes 40), in a fixed order.
constexpr int kSlots = 8;

template <int N>
__device__ __forceinline__ float warp_scatter_sum(const float (&v)[N]) {
  const unsigned int full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float x[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) x[i] = i < N ? v[i] : 0.0f;
  float y[4], z[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = (h16 ? x[4 + i] : x[i]) +
           __shfl_xor_sync(full, h16 ? x[i] : x[4 + i], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = (h8 ? y[2 + i] : y[i]) +
           __shfl_xor_sync(full, h8 ? y[i] : y[2 + i], 8);
  float w = (h4 ? z[1] : z[0]) + __shfl_xor_sync(full, h4 ? z[0] : z[1], 4);
  w += __shfl_xor_sync(full, w, 2);
  w += __shfl_xor_sync(full, w, 1);
  return w;
}

// The block's part of a reduction: each warp's sums of v[0..N) into its
// row of `partial` (a warp with no tile writes its zeros unshuffled), then
// a block barrier. The rows are floats (R) for phase 1's sums and doubles
// for phase 2's: dw is the difference of those two sums, whose terms cancel
// to a small fraction of their magnitudes, and with float rows dw was
// 1.2e-5 of max|dw| from the plain version in float64 at T = 3585 (the
// float32 plain version 1.0e-6) on an H100, with double rows 4.8e-6 at
// worst over chip_smoke.py's cases (the float32 plain version 2.3e-6).
template <int N, typename R>
__device__ __forceinline__ void warp_partials(const float (&v)[N],
                                              bool live_warp,
                                              R (*partial)[kSlots]) {
  const int lane = threadIdx.x & 31;
  const float w = live_warp ? warp_scatter_sum(v) : 0.0f;
  if ((lane & 3) == 0 && (lane >> 2) < N)
    partial[threadIdx.x >> 5][lane >> 2] = w;
  __syncthreads();
}

// After warp_partials, in the control warp (every lane calls it): lane
// i < N returns the cluster's sum of slot i. Lane i first sums slot i over
// the block's warps (four runs of four warps, then the runs, in a fixed
// order). With C blocks, lanes i < N publish the block's sums in `pub`
// (this block's shared memory) before the cluster sync that the block's
// other warps meet in cluster_sync_others, then read the C blocks' sums of
// slot i in rank order 0..C-1 through distributed shared memory. A pass
// reduces twice, into two buffers (the phase-1 floats, the phase-2
// doubles), and passes alternate between two pairs of them: a block
// rewrites a buffer only after a later cluster sync, which its peers reach
// once they have read it.
template <int N, typename R>
__device__ __forceinline__ R control_totals(const R (*partial)[kSlots], R* pub,
                                            unsigned int n) {
  static_assert(kBwdWarps == 16, "four runs of four warps");
  const int lane = threadIdx.x & 31;
  R s = R(0);
  if (lane < N) {
    R x[kBwdWarps];
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) x[w] = partial[w][lane];
    R run[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      run[r] = ((x[4 * r] + x[4 * r + 1]) + x[4 * r + 2]) + x[4 * r + 3];
    s = (run[0] + run[1]) + (run[2] + run[3]);
  }
  if (n == 1) return s;
  cg::cluster_group cluster = cg::this_cluster();
  if (lane < N) pub[lane] = s;
  cluster.sync();
  if (lane < N) {
    // the peers' values four at a time in flight, summed in rank order
    s = *cluster.map_shared_rank(pub + lane, 0);
#pragma unroll 1
    for (int r0 = 1; r0 < (int)n; r0 += 4) {
      R peer[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        peer[i] = r0 + i < (int)n
                      ? *cluster.map_shared_rank(pub + lane, r0 + i)
                      : R(0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < (int)n) s += peer[i];
    }
  }
  return s;
}

// The cluster sync of control_totals, for the block's other warps
__device__ __forceinline__ void cluster_sync_others(unsigned int n) {
  if (n > 1) cg::this_cluster().sync();
}

// The shared memory of the reductions (see control_totals)
struct Reduction {
  float partial_f[2][kBwdWarps][kSlots];
  double partial_d[2][kBwdWarps][kSlots];
  float pub_f[2][kSlots];
  double pub_d[2][kSlots];
};

// Per-map scalars shared through shared memory: the control warp's lane
// j < NK computes map j's and the block reads them after a barrier
struct MapScalars {
  float g1[kMapGroup], sda[kMapGroup], inv[kMapGroup];
};

// One pass over the block's tiles [t0, t1) for maps k0 .. k0 + NK - 1.
// Every load of the held tiles (clamped to the last tile, so that every
// load is in range and no thread branches on its own tile) and of the
// owners' scalars is issued before any value is used. `pass` numbers the
// passes (see control_totals). The block's last warp is its control
// warp: its lanes j < NK own map k0 + j's scalars (the gate, the totals,
// rank 0's writes); a bag of at most 480 tiles a block leaves it no tile,
// so that its work runs beside the tiles'.
template <int NK>
__device__ __forceinline__ void bwd_pass(const BwdArgs& a, int k0, int rank,
                                         unsigned int n, int t0, int t1,
                                         Reduction& red, MapScalars& ms,
                                         int pass) {
  const unsigned int full = 0xffffffffu;
  const int tid = threadIdx.x;
  const bool control = (tid >> 5) == kBwdWarps - 1;
  // block-uniform: the rounds of kBwdThreads tiles the block takes
  const int rounds = (t1 - t0 + kBwdThreads - 1) / kBwdThreads;
  // warp-uniform: the warp's first tile of a round; a warp with no tile in
  // a round skips it, and its lanes past t1 take the last tile's loads
  const int warp_t0 = t0 + (tid & ~31);
  const bool live_warp = warp_t0 < t1;
  // the rounds in which the warp has a tile
  const int warp_rounds =
      live_warp ? min(rounds, (t1 - warp_t0 + kBwdThreads - 1) / kBwdThreads)
                : 0;
  const bool owner = control && (tid & 31) < NK;
  const int j_own = owner ? (tid & 31) : 0;
  const bool phase1 = a.mode != kFinish;
  // the owners' loads first: they wait for nothing else
  float w_own = 0.0f, tot_own[2] = {0.0f, 0.0f};
  if (owner) {
    w_own = __ldg(a.w + k0 + j_own);
    if (!phase1) {
      tot_own[0] = __ldg(a.totals + 2 * (k0 + j_own));
      tot_own[1] = __ldg(a.totals + 2 * (k0 + j_own) + 1);
    }
  }
  float dm0[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j)
    dm0[j] = a.dm != nullptr ? __ldg(a.dm + (size_t)(k0 + j) * a.O) : 0.0f;
  TileLoads<NK> ld[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int t = min(t0 + tid + i * kBwdThreads, t1 - 1);
    if (i < warp_rounds) {
      if (phase1)
        tile_loads<NK, true>(a, t, k0, dm0, ld[i]);
      else
        tile_loads<NK, false>(a, t, k0, dm0, ld[i]);
    }
  }
  TileVals<NK> held[kHeld];
  float sig[kHeld][NK];  // the held tiles' sigmoid(A_raw)
  float gate_g1 = 0.0f, gate_g0 = 0.0f;  // the owner's gate sigmoids
  if (owner) {
    const Gate gate(w_own);
    gate_g1 = gate.g1;
    gate_g0 = gate.g0;
  }
  if (phase1) {
    float s[2 * NK + 1];
#pragma unroll
    for (int j = 0; j <= 2 * NK; ++j) s[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int t = t0 + tid + i * kBwdThreads;
      if (i < warp_rounds)
        phase1_tile(a, t, k0, t < t1, ld[i], dm0, held[i], s);
    }
#pragma unroll 1
    for (int i = kHeld; i < warp_rounds; ++i) {
      const int t = t0 + tid + i * kBwdThreads;
      TileLoads<NK> l;
      TileVals<NK> v;
      tile_loads<NK, true>(a, min(t, t1 - 1), k0, dm0, l);
      phase1_tile(a, t, k0, t < t1, l, dm0, v, s);
    }
    warp_partials(s, live_warp, red.partial_f[pass & 1]);
    // the owner of map j: sum act * mask, sum da1 * A1, sum mask
    if (control) {
      const float c = control_totals<2 * NK + 1>(red.partial_f[pass & 1],
                                                 red.pub_f[pass & 1], n);
      const float act_m = __shfl_sync(full, c, j_own);
      const float da1_a1 = __shfl_sync(full, c, NK + j_own);
      const float m_sum = __shfl_sync(full, c, 2 * NK);
      const float gsum =  // sum gated
          __fmaf_rn(gate_g1, act_m, __fmul_rn(gate_g0, m_sum));
      if (owner && a.mode == kPartials && rank == 0) {
        a.stats[(size_t)(k0 + j_own) * 2] = gsum;
        a.stats[(size_t)(k0 + j_own) * 2 + 1] = da1_a1;
      }
      if (owner) {
        ms.g1[j_own] = gate_g1;
        ms.sda[j_own] = da1_a1;
        ms.inv[j_own] = 1.0f / fmaxf(gsum, 1e-12f);
      }
    } else {
      cluster_sync_others(n);
    }
    if (a.mode == kPartials) return;
  } else {
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (i < warp_rounds) tile_vals(ld[i], held[i]);
    if (owner) {
      ms.g1[j_own] = gate_g1;
      ms.sda[j_own] = tot_own[1];
      ms.inv[j_own] = 1.0f / fmaxf(tot_own[0], 1e-12f);
    }
  }
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
    if (i < warp_rounds) tile_sig(held[i], sig[i]);
  __syncthreads();  // ms
  float g1[NK], sda[NK], inv[NK], p[2 * NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    g1[j] = ms.g1[j];
    sda[j] = ms.sda[j];
    inv[j] = ms.inv[j];
  }
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) p[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int t = t0 + tid + i * kBwdThreads;
    if (i < warp_rounds)
      phase2_tile(a, t, k0, t < t1, held[i], sig[i], g1, sda, inv, p);
  }
#pragma unroll 1
  for (int i = kHeld; i < warp_rounds; ++i) {
    const int t = t0 + tid + i * kBwdThreads;
    TileLoads<NK> l;
    TileVals<NK> v;
    float sg[NK];
    tile_loads<NK, false>(a, min(t, t1 - 1), k0, dm0, l);
    tile_vals(l, v);
    tile_sig(v, sg);
    phase2_tile(a, t, k0, t < t1, v, sg, g1, sda, inv, p);
  }
  warp_partials(p, live_warp, red.partial_d[pass & 1]);
  // rank 0's owner of map j: sum dgated * act * mask, sum dgated * mask
  if (control) {
    const double c = control_totals<2 * NK>(red.partial_d[pass & 1],
                                            red.pub_d[pass & 1], n);
    const double p_act = __shfl_sync(full, c, j_own);
    const double p_mask = __shfl_sync(full, c, NK + j_own);
    if (owner && rank == 0)
      a.dw[k0 + j_own] = gate_grad(gate_g1, gate_g0, p_act, p_mask);
  } else {
    cluster_sync_others(n);
  }
}

// One launch, one cluster: see the note at the top. `mode` picks the entry:
// both phases (the one-call entry), phase 1 (the split partials) or phase
// 2 from the all-reduced totals (the split finish).
__global__ void __launch_bounds__(kBwdThreads, 1)
gated_pool_bwd_kernel(const BwdArgs a) {
  __shared__ Reduction red;
  __shared__ MapScalars ms;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int n = cluster.num_blocks();
  const int rank = cluster.block_rank();  // the grid is one cluster
  const int t0 = rank * a.tiles;
  const int t1 = min(a.T, t0 + a.tiles);
  for (int k0 = 0, pass = 0; k0 < a.K; k0 += kMapGroup, ++pass) {
    switch (min(kMapGroup, a.K - k0)) {
      case 1: bwd_pass<1>(a, k0, rank, n, t0, t1, red, ms, pass); break;
      case 2: bwd_pass<2>(a, k0, rank, n, t0, t1, red, ms, pass); break;
      default: bwd_pass<3>(a, k0, rank, n, t0, t1, red, ms, pass);
    }
  }
  if (n > 1) cluster.sync();  // peers may still be reading this block's pub
}

// Launch gated_pool_bwd_kernel as one cluster of C blocks. The first launch
// of each C checks that such a cluster fits on the card
// (cudaOccupancyMaxActiveClusters), and refuses with kClusterUnfit if none
// does; C is never shrunk to fit. C above 8 is a non-portable cluster size.
int launch_bwd(const BwdArgs& args, int C, void* stream) {
  static bool fits[kMaxCluster + 1] = {};
  if (C < 1 || C > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (!fits[C]) {
    if (C > 8) {
      err = cudaFuncSetAttribute(gated_pool_bwd_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, gated_pool_bwd_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return kClusterUnfit;
    fits[C] = true;
  }
  if (C == 1) {
    // one block: a plain launch (a cluster launch of one block costs about
    // 1.4 us more on the H100)
    gated_pool_bwd_kernel<<<1, kBwdThreads, 0, cfg.stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaLaunchKernelEx(&cfg, gated_pool_bwd_kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(const void* a_raw, const void* b, const void* mask,
                 const void* w, const void* dm, const void* da1t,
                 const void* dwr, int T, int K, int O, int tiles, int mode) {
  BwdArgs a = {};
  a.a_raw = static_cast<const float*>(a_raw);
  a.b = static_cast<const float*>(b);
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const float*>(w);
  a.dm = static_cast<const float*>(dm);
  a.da1t = static_cast<const float*>(da1t);
  a.dwr = static_cast<const float*>(dwr);
  a.T = T;
  a.K = K;
  a.O = O;
  a.tiles = tiles;
  a.mode = mode;
  return a;
}

// -------------------------------------------------------------- forward

constexpr int kFwdThreads = 512;
static_assert(kFwdThreads == kBwdThreads, "control_totals' 16 warps");
// Tiles a thread keeps in registers between its sums and its writes: a
// tile is kMapGroup gated values and B[t, 0], 4 floats at K = 3, O = 1,
// with their loads in flight before. Three tiles (1536 a block) built with
// 127-128 registers and no spill for the H100; four spilled (128
// registers, 76 bytes of spill stores). A thread with more tiles
// recomputes them.
constexpr int kFwdHeld = 3;
// the largest grid of path (ii): one block an SM of the H100's 132 fits
// under __launch_bounds__(kFwdThreads, 1), and the staged rows fit in
// shared memory (4 KB)
constexpr int kMaxGrid = 128;
constexpr int kGridUnfit = -2;

enum FwdMode { kFused = 0, kSums = 1, kOut = 2 };

struct FwdArgs {
  const float* a_raw;   // [T, K]
  const float* b;       // [T, O]
  const float* mask;    // [T]
  const float* w;       // [K]
  const float* totals;  // [K, 1+O], the finish's all-reduced sums
  float* m;             // [K, O]
  float* a1t;           // [K, T]
  float* wrois;         // [K, T]
  float* sums;          // [K, 1+O], the partials' output
  float* rows;          // [blocks, K, 1+O], path (ii)'s blocks' sums
  int T, K, O, tiles, mode, grid;  // grid: 1 on path (ii)
};

struct FwdShared {
  float partial[2][kBwdWarps][kSlots];
  float pub[2][kSlots];
  float stage[kMaxGrid][kSlots];  // path (ii)'s rows of one pass
  float g1[kMapGroup], g0[kMapGroup], inv[kMapGroup];  // inv: 1 / denom
};

// One tile's loads for maps k0 .. k0 + NK - 1, all issued before any is
// used
template <int NK>
struct FwdTile {
  float x[NK];  // A_raw[t, k0 + j]
  float b0;     // B[t, 0]
  float m;      // mask[t]
};

template <int NK>
__device__ __forceinline__ void fwd_loads(const FwdArgs& a, int t, int k0,
                                          FwdTile<NK>& l) {
  const float* row = a.a_raw + (size_t)t * a.K + k0;
#pragma unroll
  for (int j = 0; j < NK; ++j) l.x[j] = __ldg(row + j);
  l.b0 = __ldg(a.b + (size_t)t * a.O);
  l.m = __ldg(a.mask + t);
}

// gated of the NK maps (0 for a tile that is not `live`): the exponentials
// of the maps first, then their logarithms, so that their chains overlap
template <int NK>
__device__ __forceinline__ void fwd_gated(const FwdTile<NK>& l,
                                          const float (&g1)[NK],
                                          const float (&g0)[NK], bool live,
                                          float (&g)[NK]) {
  float e[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) e[j] = expf(-fabsf(l.x[j]));
  const float m = live ? l.m : 0.0f;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float act = __fadd_rn(log1pf(e[j]), fmaxf(l.x[j], 0.0f));
    g[j] = __fmul_rn(__fadd_rn(__fmul_rn(g1[j], act), g0[j]), m);
  }
}

// A pass takes kCols<NK> columns of the maps' rows of the [K, 1+O] table
// (column 0 sum |gated|, column 1 + o sum gated * B[:, o]), starting at
// column c0: slot q holds map q % NK's column c0 + q / NK, so that a
// slot's map is known at compile time. A column past O is no slot's.
template <int NK>
constexpr int kCols = kSlots / NK;

// tile t's terms of the pass's sums, added in tile order
template <int NK>
__device__ __forceinline__ void add_terms(const FwdArgs& a, int t,
                                          const float (&g)[NK], float b0,
                                          int c0, float (&s)[kSlots]) {
  const float* brow = a.b + (size_t)t * a.O;
#pragma unroll
  for (int cc = 0; cc < kCols<NK>; ++cc) {
    const int c = c0 + cc;
    if (c > a.O) break;
    const float bv = c <= 1 ? b0 : __ldg(brow + c - 1);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float term = c == 0 ? fabsf(g[j]) : __fmul_rn(g[j], bv);
      s[cc * NK + j] = __fadd_rn(s[cc * NK + j], term);
    }
  }
}

// tile t's A1T and wROIs of the NK maps
template <int NK>
__device__ __forceinline__ void fwd_write(const FwdArgs& a, int t, int k0,
                                          const float (&g)[NK], float b0,
                                          const float (&inv)[NK]) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float a1 = __fmul_rn(g[j], inv[j]);
    const size_t kt = (size_t)(k0 + j) * a.T + t;
    a.a1t[kt] = a1;
    a.wrois[kt] = __fmul_rn(a1, b0);
  }
}

// The [K, 1+O] table's entry of slot q of a pass over maps k0.. of NK
// from column c0, or -1 if the slot holds none
template <int NK>
__device__ __forceinline__ int slot_entry(int q, int k0, int c0, int W) {
  const int c = c0 + q / NK;
  return q < NK * kCols<NK> && c < W ? (k0 + q % NK) * W + c : -1;
}

// Path (ii), after the grid barrier: each slot's entry of the blocks' rows
// (rows [B, K * (1+O)]) summed over the rows in rank order 0..B-1, one
// float add at a time, as control_totals sums a cluster's. The block
// stages the rows in shared memory, all its loads at once (from L2: other
// SMs wrote them); the control warp's lane q < kSlots returns slot q's.
template <int NK>
__device__ __forceinline__ float grid_totals(const FwdArgs& a, int k0, int c0,
                                             int B, float (*stage)[kSlots]) {
  const int W = 1 + a.O;
  for (int i = threadIdx.x; i < B * kSlots; i += blockDim.x) {
    const int r = i / kSlots, q = i % kSlots;
    const int e = slot_entry<NK>(q, k0, c0, W);
    stage[r][q] = e >= 0 ? __ldcg(a.rows + (size_t)r * a.K * W + e) : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  if ((int)(threadIdx.x >> 5) == kBwdWarps - 1 && lane < kSlots) {
    s = stage[0][lane];
#pragma unroll 8
    for (int r = 1; r < B; ++r) s = __fadd_rn(s, stage[r][lane]);
  }
  return s;
}

// The control warp after a pass: lane q holds slot q's total. The
// partials' rank 0 writes its entry of the table; the one-call entry keeps
// 1 / denom of each map (column 0, all in the first pass) in shared
// memory, and its rank 0 writes M from them.
template <int NK>
__device__ __forceinline__ void fwd_pass_out(const FwdArgs& a, int k0, int c0,
                                             int rank, float tot,
                                             FwdShared& sh) {
  const int W = 1 + a.O;
  const int q = threadIdx.x & 31;
  const int e = q < kSlots ? slot_entry<NK>(q, k0, c0, W) : -1;
  const int j = q % NK, c = c0 + q / NK;
  if (a.mode == kSums) {
    if (e >= 0 && rank == 0) a.sums[e] = tot;
    return;
  }
  if (e >= 0 && c == 0) sh.inv[j] = __frcp_rn(fmaxf(tot, 1e-12f));
  __syncwarp();
  if (e >= 0 && c > 0 && rank == 0)
    a.m[(size_t)(k0 + j) * a.O + c - 1] = __fmul_rn(tot, sh.inv[j]);
}

// Maps k0 .. k0 + NK - 1 over the block's tiles [t0, t1): see the note at
// the top. `pass` numbers the passes (see control_totals).
template <int NK>
__device__ __forceinline__ void fwd_group(const FwdArgs& a, int k0, int rank,
                                          unsigned int n, int t0, int t1,
                                          FwdShared& sh, int& pass) {
  const int tid = threadIdx.x;
  const bool control = (tid >> 5) == kBwdWarps - 1;
  const int W = 1 + a.O;
  // kFwdThreads, or the finish's block of one tile a thread
  const int nthr = blockDim.x;
  // block-uniform: the rounds of nthr tiles the block takes
  const int rounds = t1 > t0 ? (t1 - t0 + nthr - 1) / nthr : 0;
  // warp-uniform: the rounds in which the warp has a tile; its lanes past
  // t1 take the last tile's loads and add zeros
  const int warp_t0 = t0 + (tid & ~31);
  const bool live_warp = warp_t0 < t1;
  const int warp_rounds =
      live_warp
          ? min(rounds, (t1 - warp_t0 + nthr - 1) / nthr)
          : 0;
  // every load first: the gate's weights, the finish's denominators, the
  // held tiles
  float w_own = 0.0f, tot_own = 0.0f;
  if (tid < NK) {
    w_own = __ldg(a.w + k0 + tid);
    if (a.mode == kOut) tot_own = __ldg(a.totals + (k0 + tid) * W);
  }
  FwdTile<NK> held[kFwdHeld];
#pragma unroll
  for (int i = 0; i < kFwdHeld; ++i)
    if (i < warp_rounds)
      fwd_loads(a, min(t0 + tid + i * nthr, t1 - 1), k0, held[i]);
  if (tid < NK) {
    const Gate gate(w_own);
    sh.g1[tid] = gate.g1;
    sh.g0[tid] = gate.g0;
    if (a.mode == kOut) sh.inv[tid] = __frcp_rn(fmaxf(tot_own, 1e-12f));
  }
  __syncthreads();  // sh.g1, sh.g0 (and the finish's sh.inv)
  float g1[NK], g0[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    g1[j] = sh.g1[j];
    g0[j] = sh.g0[j];
  }
  float gated[kFwdHeld][NK];
#pragma unroll
  for (int i = 0; i < kFwdHeld; ++i)
    if (i < warp_rounds)
      fwd_gated(held[i], g1, g0, t0 + tid + i * nthr < t1, gated[i]);

  if (a.mode != kOut) {
    for (int c0 = 0; c0 < W; c0 += kCols<NK>, ++pass) {
      float s[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) s[q] = 0.0f;
#pragma unroll
      for (int i = 0; i < kFwdHeld; ++i)
        if (i < warp_rounds)
          add_terms(a, min(t0 + tid + i * nthr, t1 - 1), gated[i],
                    held[i].b0, c0, s);
#pragma unroll 1
      for (int i = kFwdHeld; i < warp_rounds; ++i) {
        const int t = t0 + tid + i * nthr;
        FwdTile<NK> l;
        float g[NK];
        fwd_loads(a, min(t, t1 - 1), k0, l);
        fwd_gated(l, g1, g0, t < t1, g);
        add_terms(a, min(t, t1 - 1), g, l.b0, c0, s);
      }
      warp_partials(s, live_warp, sh.partial[pass & 1]);
      float tot = 0.0f;  // the control warp's lane q: slot q's
      if (a.grid) {
        if (control) {
          const float mine =
              control_totals<kSlots>(sh.partial[pass & 1], sh.pub[pass & 1],
                                     1u);
          const int q = tid & 31;
          const int e = q < kSlots ? slot_entry<NK>(q, k0, c0, W) : -1;
          if (e >= 0) {
            a.rows[(size_t)rank * a.K * W + e] = mine;
            __threadfence();
          }
        }
        cg::this_grid().sync();
        if (a.mode == kFused || rank == 0)
          tot = grid_totals<NK>(a, k0, c0, gridDim.x, sh.stage);
      } else if (control) {
        tot = control_totals<kSlots>(sh.partial[pass & 1], sh.pub[pass & 1],
                                     n);
      } else {
        cluster_sync_others(n);
      }
      if (control) fwd_pass_out<NK>(a, k0, c0, rank, tot, sh);
    }
    if (a.mode == kSums) return;
    __syncthreads();  // sh.inv
  } else if (rank == 0) {
    // the finish: M from the totals
    for (int i = tid; i < NK * a.O; i += nthr) {
      const int j = i / a.O, o = i - j * a.O;
      a.m[(size_t)(k0 + j) * a.O + o] =
          __fmul_rn(__ldg(a.totals + (k0 + j) * W + 1 + o), sh.inv[j]);
    }
  }
  float inv[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) inv[j] = sh.inv[j];
#pragma unroll
  for (int i = 0; i < kFwdHeld; ++i) {
    const int t = t0 + tid + i * nthr;
    if (i < warp_rounds && t < t1)
      fwd_write(a, t, k0, gated[i], held[i].b0, inv);
  }
#pragma unroll 1
  for (int i = kFwdHeld; i < warp_rounds; ++i) {
    const int t = t0 + tid + i * nthr;
    FwdTile<NK> l;
    float g[NK];
    fwd_loads(a, min(t, t1 - 1), k0, l);
    fwd_gated(l, g1, g0, t < t1, g);
    if (t < t1) fwd_write(a, t, k0, g, l.b0, inv);
  }
}

// One launch: see the note at the top. Block r owns tiles [r * tiles,
// min(T, (r + 1) * tiles)); on path (i) the grid is one cluster, so r is
// the block's rank in it.
__global__ void __launch_bounds__(kFwdThreads, 1)
gated_pool_fwd_kernel(const FwdArgs a) {
  __shared__ FwdShared sh;
  const int rank = blockIdx.x;
  const unsigned int n = (a.grid || a.mode == kOut) ? 1u : gridDim.x;
  const int t0 = rank * a.tiles;
  const int t1 = min(a.T, t0 + a.tiles);
  for (int k0 = 0, pass = 0; k0 < a.K; k0 += kMapGroup) {
    if (k0 > 0) __syncthreads();  // the last group's readers of sh
    switch (min(kMapGroup, a.K - k0)) {
      case 1: fwd_group<1>(a, k0, rank, n, t0, t1, sh, pass); break;
      case 2: fwd_group<2>(a, k0, rank, n, t0, t1, sh, pass); break;
      default: fwd_group<3>(a, k0, rank, n, t0, t1, sh, pass);
    }
  }
  if (n > 1) cg::this_cluster().sync();  // peers may still read sh.pub
}

// Launch gated_pool_fwd_kernel: the finish, and path (i) with one block,
// as a plain launch; path (i) as one cluster of `blocks` (the first launch
// of each size checks that such a cluster fits, as launch_bwd does); path
// (ii) as a cooperative launch, refused with kGridUnfit above kMaxGrid or
// above what can be co-resident on the card. Nothing is shrunk to fit.
int launch_fwd(const FwdArgs& args, int blocks, void* stream) {
  static bool fits[kMaxCluster + 1] = {};
  static int co_resident = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (args.mode == kOut) {
    // one tile a thread: whole warps, at most kFwdThreads
    if (args.tiles < 32 || args.tiles > kFwdThreads || args.tiles % 32)
      return static_cast<int>(cudaErrorInvalidValue);
    gated_pool_fwd_kernel<<<blocks, args.tiles, 0, s>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  if (!args.grid && blocks == 1) {
    gated_pool_fwd_kernel<<<1, kFwdThreads, 0, s>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  if (args.grid) {
    if (blocks > kMaxGrid) return kGridUnfit;
    if (co_resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, gated_pool_fwd_kernel, kFwdThreads, 0)) !=
              cudaSuccess)
        return static_cast<int>(err);
      co_resident = sms * per_sm;
    }
    if (blocks > co_resident) return kGridUnfit;
    void* params[] = {const_cast<FwdArgs*>(&args)};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(gated_pool_fwd_kernel), dim3(blocks),
        dim3(kFwdThreads), params, 0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (blocks > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (!fits[blocks]) {
    if (blocks > 8) {
      err = cudaFuncSetAttribute(gated_pool_fwd_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, gated_pool_fwd_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return kClusterUnfit;
    fits[blocks] = true;
  }
  err = cudaLaunchKernelEx(&cfg, gated_pool_fwd_kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

FwdArgs fwd_args(const void* a_raw, const void* b, const void* mask,
                 const void* w, int T, int K, int O, int tiles, int mode,
                 int grid) {
  FwdArgs a = {};
  a.a_raw = static_cast<const float*>(a_raw);
  a.b = static_cast<const float*>(b);
  a.mask = static_cast<const float*>(mask);
  a.w = static_cast<const float*>(w);
  a.T = T;
  a.K = K;
  a.O = O;
  a.tiles = tiles;
  a.mode = mode;
  a.grid = grid;
  return a;
}

}  // namespace

// One launch of `blocks` blocks of `tiles` tiles (pool_fwd_partition): one
// cluster (grid = 0) or a cooperative grid whose blocks write their sums
// to rows [blocks, K, 1+O] (grid = 1; rows unused otherwise).
extern "C" int gated_pool_forward(const void* a_raw, const void* b,
                                  const void* mask, const void* w, void* m,
                                  void* a1t, void* wrois, void* rows, int T,
                                  int K, int O, int tiles, int blocks,
                                  int grid, void* stream) {
  FwdArgs a = fwd_args(a_raw, b, mask, w, T, K, O, tiles, kFused, grid);
  a.m = static_cast<float*>(m);
  a.a1t = static_cast<float*>(a1t);
  a.wrois = static_cast<float*>(wrois);
  a.rows = static_cast<float*>(rows);
  return launch_fwd(a, blocks, stream);
}

// da1t and dwr may be null, dm too; each is then a zero cotangent. One
// launch of C blocks, each owning `tiles` tiles (pool_bwd_partition).
extern "C" int gated_pool_backward(const void* a_raw, const void* b,
                                   const void* mask, const void* w,
                                   const void* a1t, const void* dm,
                                   const void* da1t, const void* dwr,
                                   void* da_raw, void* db, void* dw, int T,
                                   int K, int O, int tiles, int C,
                                   void* stream) {
  BwdArgs a = bwd_args(a_raw, b, mask, w, dm, da1t, dwr, T, K, O, tiles,
                       kBoth);
  a.a1t = static_cast<const float*>(a1t);
  a.da_raw = static_cast<float*>(da_raw);
  a.db = static_cast<float*>(db);
  a.dw = static_cast<float*>(dw);
  return launch_bwd(a, C, stream);
}

// ------------------------------------------------- split at the reduction
//
// The entries below are the one-call entries cut where their sums over T
// meet. A bag whose tile axis is split across ranks (parallel/mesh.py)
// calls the partials entry on its shard, all-reduces the small table it
// returns across the ranks, and calls the finish entry with the totals.
// Each is one launch of the one-call entry's kernel; the partials entry
// cuts T as the one-call entry does and sums in its order, so a split call
// on a single shard gives the one-call entry's outputs bit for bit.

// partials [K, 1+O] = (sum_T |gated|, sum_T gated * B[:, o]) over this
// shard, in one launch of the one-call entry's partition; rows as there.
extern "C" int gated_pool_forward_partials(const void* a_raw, const void* b,
                                           const void* mask, const void* w,
                                           void* partials, void* rows, int T,
                                           int K, int O, int tiles,
                                           int blocks, int grid,
                                           void* stream) {
  FwdArgs a = fwd_args(a_raw, b, mask, w, T, K, O, tiles, kSums, grid);
  a.sums = static_cast<float*>(partials);
  a.rows = static_cast<float*>(rows);
  return launch_fwd(a, blocks, stream);
}

// From the all-reduced totals [K, 1+O], in one elementwise launch of
// `blocks` blocks of `tiles` tiles (one a thread): M [K, O], and this
// shard's A1T and wROIs columns [K, T].
extern "C" int gated_pool_forward_finish(const void* a_raw, const void* b,
                                         const void* mask, const void* w,
                                         const void* totals, void* m,
                                         void* a1t, void* wrois, int T, int K,
                                         int O, int tiles, int blocks,
                                         void* stream) {
  FwdArgs a = fwd_args(a_raw, b, mask, w, T, K, O, tiles, kOut, 0);
  a.totals = static_cast<const float*>(totals);
  a.m = static_cast<float*>(m);
  a.a1t = static_cast<float*>(a1t);
  a.wrois = static_cast<float*>(wrois);
  return launch_fwd(a, blocks, stream);
}

// stats [K, 2] = (sum_T gated, sum_T da1 * A1) over this shard, and this
// shard's dB rows (no sum over T), in one launch. dm is the cotangent of
// the replicated M, the same on every rank; da1t and dwr are this shard's
// columns. Each may be null.
extern "C" int gated_pool_backward_partials(
    const void* a_raw, const void* b, const void* mask, const void* w,
    const void* a1t, const void* dm, const void* da1t, const void* dwr,
    void* db, void* stats, int T, int K, int O, int tiles, int C,
    void* stream) {
  BwdArgs a = bwd_args(a_raw, b, mask, w, dm, da1t, dwr, T, K, O, tiles,
                       kPartials);
  a.a1t = static_cast<const float*>(a1t);
  a.db = static_cast<float*>(db);
  a.stats = static_cast<float*>(stats);
  return launch_bwd(a, C, stream);
}

// From the all-reduced stats [K, 2], in one launch: this shard's dA_raw
// rows and its part of dw (linear in the shard's sums, so the ranks' parts
// add up to dw).
extern "C" int gated_pool_backward_finish(
    const void* a_raw, const void* b, const void* mask, const void* w,
    const void* dm, const void* da1t, const void* dwr, const void* totals,
    void* da_raw, void* dw, int T, int K, int O, int tiles, int C,
    void* stream) {
  BwdArgs a = bwd_args(a_raw, b, mask, w, dm, da1t, dwr, T, K, O, tiles,
                       kFinish);
  a.totals = static_cast<const float*>(totals);
  a.da_raw = static_cast<float*>(da_raw);
  a.dw = static_cast<float*>(dw);
  return launch_bwd(a, C, stream);
}
