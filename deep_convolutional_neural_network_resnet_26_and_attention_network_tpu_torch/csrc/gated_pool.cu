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
// kernel is bound by latency: its launches, its passes over T and the
// reduction of the L1 denominator, which every output waits for. No single
// PyTorch call computes this function, so there is no library yardstick.
//
// Design. The tile axis is cut into nblk ranges of `range` tiles (the
// wrapper's partition, ops/gated_pool.py:pool_partition), and block (j, k)
// owns range j of attention map k, so K * nblk blocks share the work; the
// TPU kernel held the whole bag in VMEM and capped it at 2560 tiles, here
// there is no cap. Pass 1 (gated_pool_partial_kernel) computes sum |gated|
// and sum gated * B[:, o] over its range, reduced across the block with warp
// shuffles and shared memory, and writes them to scratch [K, nblk, 1+O].
// Pass 2 (gated_pool_finish_kernel), the next launch on the same stream,
// sums map k's nblk partials in a fixed order in every block (a few loads),
// recomputes gated for its range (cheaper than storing it) and writes A1T
// and wROIs; block (0, k) writes M[k]. When T fits one range (nblk = 1) the
// first launch does both passes itself and there is no second launch and no
// scratch. No float atomics: every sum has a fixed order, so two calls on
// the same inputs give bit-identical outputs. Output columns o are taken in
// groups of MAX_O so that any O works with the sums in registers; the main
// path has O = 1.
//
// Backward (gated_pool_backward), given the forward's A1T and the cotangents
// dM [K,O], dA1T [K,T], dwROIs [K,T] (each may be absent, a null pointer,
// which counts as zero):
//
//   da1     = B dM^T + dA1T^T + dwROIs^T * B[:, 0]          [T, K]
//   denom   = max(sum_T gated, 1e-12)   (recomputed; gated >= 0)
//   dgated  = (da1 - sum_T(da1 * A1)) / denom
//   dA_raw  = dgated * sigmoid(-10 w) * mask * sigmoid(A_raw)
//   dB      = A1 dM, plus sum_K dwROIs^T * A1 in column 0
//   dw      = sum_T(dgated act mask) (-10) g1 (1 - g1)
//             + sum_T(dgated mask) 10 g0 (1 - g0)
//
// The mask gets no gradient. Bound: about 36 bytes a tile on the training
// path (A_raw, B, mask, A1T in; dA_raw, dB out; K = 3, O = 1, dM only): 0.54
// us at T = 50000, so again launches and the passes over T set the time.
// Each map needs two sums over T before dA_raw can be written (denom and
// sum da1 * A1) and two more after it (the dw sums). With one range
// (nblk = 1) one launch does it all: block k makes its two passes over the
// bag. Above one range the partial kernel writes each range's denom and
// sum da1 * A1 to scratch [K, nblk, 2]; the middle kernel sums them in a
// fixed order, writes dA_raw for its range and its range's two dw sums to a
// second scratch [K, nblk, 2]; a one-block-per-map finish kernel sums those
// in a fixed order and writes dw. dB needs no sum over T: the blocks of map 0
// of the first launch write it for their ranges. No float atomics, so two
// calls give bit-identical gradients.
//
// Split at the reduction (the multi-card mesh, ROADMAP B.1 (b)). When the
// tile axis of a bag is split across ranks, the sums over T become sums
// across ranks. The same kernels serve, cut where their passes meet:
// gated_pool_forward_partials returns a shard's [K, 1+O] sums (pass 1, then
// gated_pool_reduce_kernel over its ranges), the caller all-reduces them,
// and gated_pool_forward_finish runs pass 2 from the totals.
// gated_pool_backward_partials and gated_pool_backward_finish do the same
// with the backward's [K, 2] table (denom and sum da1 * A1); the finish
// leaves the shard's part of dw, which the parameter all-reduce sums. The
// tables are K * (1+O) and K * 2 floats, so an all-reduce moves a few
// dozen bytes.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launches, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int MAX_O = 8;

__device__ __forceinline__ float softplus_f(float x) {
  // the form of jax.nn.softplus (logaddexp(x, 0)), with no threshold
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Gate {
  float g1, g0;  // sigmoid(-10 w), sigmoid(10 w)
  __device__ explicit Gate(float wk)
      : g1(1.0f / (1.0f + expf(10.0f * wk))),
        g0(1.0f / (1.0f + expf(-10.0f * wk))) {}
  __device__ float operator()(const float* a_raw, const float* mask, int t,
                              int K, int k) const {
    return (g1 * softplus_f(a_raw[(size_t)t * K + k]) + g0) * mask[t];
  }
};

// The block's sums over [t0, t1) of |gated| (s[0]) and gated * B[:, o0 + j]
// (s[1 + j], j < n_o), in a fixed order; every thread gets them.
__device__ void range_sums(const float* __restrict__ a_raw,
                           const float* __restrict__ b,
                           const float* __restrict__ mask, const Gate& gate,
                           int t0, int t1, int K, int k, int O, int o0,
                           int n_o, float (&s)[MAX_O + 1]) {
  __shared__ float partial[kWarps][MAX_O + 1];
  __shared__ float total[MAX_O + 1];
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j <= MAX_O; ++j) s[j] = 0.0f;
#pragma unroll 4
  for (int t = t0 + tid; t < t1; t += kThreads) {
    const float gated = gate(a_raw, mask, t, K, k);
    s[0] += fabsf(gated);
    const float* brow = b + (size_t)t * O + o0;
#pragma unroll
    for (int j = 0; j < MAX_O; ++j)
      if (j < n_o) s[j + 1] += gated * brow[j];
  }
#pragma unroll
  for (int j = 0; j <= MAX_O; ++j) s[j] = warp_sum(s[j]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j <= MAX_O; ++j) partial[tid >> 5][j] = s[j];
  }
  __syncthreads();
  if (tid <= MAX_O) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) v += partial[i][tid];
    total[tid] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j <= MAX_O; ++j) s[j] = total[j];
  __syncthreads();  // partial/total are reused by the next call
}

// A1T and wROIs for tiles [t0, t1) of map k
__device__ void write_range(const float* __restrict__ a_raw,
                            const float* __restrict__ b,
                            const float* __restrict__ mask, const Gate& gate,
                            float denom, int t0, int t1, int T, int K, int k,
                            int O, float* __restrict__ a1t,
                            float* __restrict__ wrois) {
  float* a1t_row = a1t + (size_t)k * T;
  float* w_row = wrois + (size_t)k * T;
#pragma unroll 4
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const float a1 = gate(a_raw, mask, t, K, k) / denom;
    a1t_row[t] = a1;
    w_row[t] = a1 * b[(size_t)t * O];
  }
}

// Pass 1 over range blockIdx.x of map blockIdx.y. With `finish` (the
// one-call entry with one range) it also finishes: M[k], then A1T and wROIs.
// Otherwise it writes the range's sums to scratch[k][j][0..O].
__global__ void __launch_bounds__(kThreads)
gated_pool_partial_kernel(const float* __restrict__ a_raw,
                          const float* __restrict__ b,
                          const float* __restrict__ mask,
                          const float* __restrict__ w, float* __restrict__ m,
                          float* __restrict__ a1t, float* __restrict__ wrois,
                          float* __restrict__ scratch, int T, int K, int O,
                          int range, int finish) {
  const int j = blockIdx.x;
  const int k = blockIdx.y;
  const int nblk = gridDim.x;
  const int t0 = j * range;
  const int t1 = min(T, t0 + range);
  const Gate gate(w[k]);
  float s[MAX_O + 1];
  float denom = 1.0f;
  for (int o0 = 0; o0 < O; o0 += MAX_O) {
    const int n_o = min(MAX_O, O - o0);
    range_sums(a_raw, b, mask, gate, t0, t1, K, k, O, o0, n_o, s);
    if (finish) {
      denom = fmaxf(s[0], 1e-12f);
      if ((int)threadIdx.x < n_o)
        m[(size_t)k * O + o0 + threadIdx.x] = s[threadIdx.x + 1] / denom;
    } else {
      float* dst = scratch + ((size_t)k * nblk + j) * (1 + O);
      if (o0 == 0 && threadIdx.x == 0) dst[0] = s[0];
      if ((int)threadIdx.x < n_o) dst[1 + o0 + threadIdx.x] = s[threadIdx.x + 1];
    }
  }
  if (finish)
    write_range(a_raw, b, mask, gate, denom, t0, t1, T, K, k, O, a1t, wrois);
}

// The sum over the nblk ranges of column c of map k's partials (rows of
// `width` floats), in a fixed order (a thread's strided share, then the
// block reduction); every thread gets it.
__device__ float sum_partials(const float* __restrict__ scratch, int k,
                              int nblk, int width, int c) {
  __shared__ float part[kWarps];
  const int tid = threadIdx.x;
  float v = 0.0f;
  for (int i = tid; i < nblk; i += kThreads)
    v += scratch[((size_t)k * nblk + i) * width + c];
  v = warp_sum(v);
  if ((tid & 31) == 0) part[tid >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += part[i];
  __syncthreads();  // part is reused by the next call
  return total;
}

// Pass 2 over range blockIdx.x of map blockIdx.y: the denominator from the
// n_part rows of partials of map k (the nblk ranges' in the one-call entry,
// one row of totals in the split one), M[k] (block 0), then A1T and wROIs
// for the range.
__global__ void __launch_bounds__(kThreads)
gated_pool_finish_kernel(const float* __restrict__ a_raw,
                         const float* __restrict__ b,
                         const float* __restrict__ mask,
                         const float* __restrict__ w, float* __restrict__ m,
                         float* __restrict__ a1t, float* __restrict__ wrois,
                         const float* __restrict__ scratch, int T, int K,
                         int O, int range, int n_part) {
  const int j = blockIdx.x;
  const int k = blockIdx.y;
  const float denom =
      fmaxf(sum_partials(scratch, k, n_part, 1 + O, 0), 1e-12f);
  if (j == 0) {
    for (int o = 0; o < O; ++o) {
      const float s = sum_partials(scratch, k, n_part, 1 + O, 1 + o);
      if (threadIdx.x == 0) m[(size_t)k * O + o] = s / denom;
    }
  }
  const int t0 = j * range;
  write_range(a_raw, b, mask, Gate(w[k]), denom, t0, min(T, t0 + range), T, K,
              k, O, a1t, wrois);
}

// One block per map: row k of `out` [K, width] is the sum over the nblk
// ranges of map k's partials (scratch [K, nblk, width]), in sum_partials'
// fixed order, the order in which the one-call entries sum them.
__global__ void __launch_bounds__(kThreads)
gated_pool_reduce_kernel(const float* __restrict__ scratch,
                         float* __restrict__ out, int nblk, int width) {
  const int k = blockIdx.x;
  for (int c = 0; c < width; ++c) {
    const float v = sum_partials(scratch, k, nblk, width, c);
    if (threadIdx.x == 0) out[(size_t)k * width + c] = v;
  }
}

// ------------------------------------------------------------- backward

// The block's sums of v[0..N), in a fixed order; every thread gets them.
template <int N>
__device__ void block_sums(float (&v)[N]) {
  __shared__ float partial[kWarps][N];
  __shared__ float total[N];
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) partial[tid >> 5][j] = v[j];
  }
  __syncthreads();
  if (tid < N) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += partial[i][tid];
    total[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = total[j];
  __syncthreads();  // partial/total are reused by the next call
}

// The cotangents of (M, A1T, wROIs); a null pointer is a zero cotangent.
struct Cotangents {
  const float* dm;    // [K, O]
  const float* da1t;  // [K, T]
  const float* dwr;   // [K, T]

  // da1[t, k] = B[t] . dM[k] + dA1T[k, t] + dwROIs[k, t] * B[t, 0]
  __device__ float da1(const float* __restrict__ b, int t, int T, int k,
                       int O) const {
    float v = 0.0f;
    if (dm != nullptr) {
      const float* brow = b + (size_t)t * O;
      const float* dmk = dm + (size_t)k * O;
      for (int o = 0; o < O; ++o) v += brow[o] * dmk[o];
    }
    if (da1t != nullptr) v += da1t[(size_t)k * T + t];
    if (dwr != nullptr) v += dwr[(size_t)k * T + t] * b[(size_t)t * O];
    return v;
  }
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// dw[k] from the two sums over T of dgated * act * mask and dgated * mask
__device__ __forceinline__ float gate_grad(const Gate& g, float p_act,
                                           float p_mask) {
  return p_act * (-10.0f) * g.g1 * (1.0f - g.g1) +
         p_mask * 10.0f * g.g0 * (1.0f - g.g0);
}

// The sums over [t0, t1) of map k that dgated needs: gated (p[0]) and
// da1 * A1 (p[1]).
__device__ void range_stats(const float* __restrict__ a_raw,
                            const float* __restrict__ b,
                            const float* __restrict__ mask,
                            const float* __restrict__ a1t,
                            const Cotangents& cot, const Gate& gate, int t0,
                            int t1, int T, int K, int k, int O,
                            float (&p)[2]) {
  const float* a1_row = a1t + (size_t)k * T;
  p[0] = 0.0f;
  p[1] = 0.0f;
#pragma unroll 4
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    p[0] += gate(a_raw, mask, t, K, k);
    p[1] += cot.da1(b, t, T, k, O) * a1_row[t];
  }
  block_sums(p);
}

// dA_raw for tiles [t0, t1) of map k, and the range's dw sums: dgated * act
// * mask (p[0]) and dgated * mask (p[1]), reduced over the block.
__device__ void range_grads(const float* __restrict__ a_raw,
                            const float* __restrict__ b,
                            const float* __restrict__ mask,
                            const Cotangents& cot, const Gate& gate,
                            float denom, float s_da1_a1, int t0, int t1,
                            int T, int K, int k, int O,
                            float* __restrict__ da_raw, float (&p)[2]) {
  p[0] = 0.0f;
  p[1] = 0.0f;
#pragma unroll 4
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const float x = a_raw[(size_t)t * K + k];
    const float m = mask[t];
    const float dgated = (cot.da1(b, t, T, k, O) - s_da1_a1) / denom;
    da_raw[(size_t)t * K + k] = dgated * gate.g1 * m * sigmoid_f(x);
    p[0] += dgated * softplus_f(x) * m;
    p[1] += dgated * m;
  }
  block_sums(p);
}

// dB for tiles [t0, t1): A1 dM, plus sum_K dwROIs^T * A1 in column 0
__device__ void write_db(const float* __restrict__ a1t, const Cotangents& cot,
                         int t0, int t1, int T, int K, int O,
                         float* __restrict__ db) {
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    for (int o = 0; o < O; ++o) {
      float v = 0.0f;
      if (cot.dm != nullptr)
        for (int k = 0; k < K; ++k)
          v += a1t[(size_t)k * T + t] * cot.dm[(size_t)k * O + o];
      if (o == 0 && cot.dwr != nullptr) {
        float u = 0.0f;
        for (int k = 0; k < K; ++k)
          u += cot.dwr[(size_t)k * T + t] * a1t[(size_t)k * T + t];
        v += u;
      }
      db[(size_t)t * O + o] = v;
    }
  }
}

// Launch 1 over range blockIdx.x of map blockIdx.y. With `finish` (the
// one-call entry with one range) it finishes the map: dA_raw and dw[k].
// Otherwise it writes the range's denom and sum da1 * A1 to
// scratch[k][j][0..1]. The blocks of map 0 write dB for their range.
__global__ void __launch_bounds__(kThreads)
gated_pool_bwd_partial_kernel(const float* __restrict__ a_raw,
                              const float* __restrict__ b,
                              const float* __restrict__ mask,
                              const float* __restrict__ w,
                              const float* __restrict__ a1t, Cotangents cot,
                              float* __restrict__ da_raw,
                              float* __restrict__ db, float* __restrict__ dw,
                              float* __restrict__ scratch, int T, int K, int O,
                              int range, int finish) {
  const int j = blockIdx.x;
  const int k = blockIdx.y;
  const int nblk = gridDim.x;
  const int t0 = j * range;
  const int t1 = min(T, t0 + range);
  const Gate gate(w[k]);
  float s[2];
  range_stats(a_raw, b, mask, a1t, cot, gate, t0, t1, T, K, k, O, s);
  if (finish) {
    float p[2];
    range_grads(a_raw, b, mask, cot, gate, fmaxf(s[0], 1e-12f), s[1], t0, t1,
                T, K, k, O, da_raw, p);
    if (threadIdx.x == 0) dw[k] = gate_grad(gate, p[0], p[1]);
  } else if (threadIdx.x == 0) {
    float* dst = scratch + ((size_t)k * nblk + j) * 2;
    dst[0] = s[0];
    dst[1] = s[1];
  }
  if (k == 0) write_db(a1t, cot, t0, t1, T, K, O, db);
}

// Launch 2: denom and sum da1 * A1 from the n_part rows of partials of map k
// (the nblk ranges' in the one-call entry, one row of totals in the split
// one), dA_raw for the range, and the range's dw sums into
// dw_scratch[k][j][0..1].
__global__ void __launch_bounds__(kThreads)
gated_pool_bwd_middle_kernel(const float* __restrict__ a_raw,
                             const float* __restrict__ b,
                             const float* __restrict__ mask,
                             const float* __restrict__ w, Cotangents cot,
                             float* __restrict__ da_raw,
                             const float* __restrict__ scratch,
                             float* __restrict__ dw_scratch, int T, int K,
                             int O, int range, int n_part) {
  const int j = blockIdx.x;
  const int k = blockIdx.y;
  const int nblk = gridDim.x;
  const float denom = fmaxf(sum_partials(scratch, k, n_part, 2, 0), 1e-12f);
  const float s_da1_a1 = sum_partials(scratch, k, n_part, 2, 1);
  const int t0 = j * range;
  float p[2];
  range_grads(a_raw, b, mask, cot, Gate(w[k]), denom, s_da1_a1, t0,
              min(T, t0 + range), T, K, k, O, da_raw, p);
  if (threadIdx.x == 0) {
    float* dst = dw_scratch + ((size_t)k * nblk + j) * 2;
    dst[0] = p[0];
    dst[1] = p[1];
  }
}

// Launch 3, one block per map: dw[k] from the ranges' dw sums.
__global__ void __launch_bounds__(kThreads)
gated_pool_bwd_finish_kernel(const float* __restrict__ w,
                             const float* __restrict__ dw_scratch,
                             float* __restrict__ dw, int nblk) {
  const int k = blockIdx.x;
  const float p_act = sum_partials(dw_scratch, k, nblk, 2, 0);
  const float p_mask = sum_partials(dw_scratch, k, nblk, 2, 1);
  if (threadIdx.x == 0) dw[k] = gate_grad(Gate(w[k]), p_act, p_mask);
}

}  // namespace

extern "C" int gated_pool_forward(const void* a_raw, const void* b,
                                  const void* mask, const void* w, void* m,
                                  void* a1t, void* wrois, void* scratch, int T,
                                  int K, int O, int range, int nblk,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, K);
  gated_pool_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<float*>(m), static_cast<float*>(a1t),
      static_cast<float*>(wrois), static_cast<float*>(scratch), T, K, O,
      range, nblk == 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return static_cast<int>(err);
  gated_pool_finish_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<float*>(m), static_cast<float*>(a1t),
      static_cast<float*>(wrois), static_cast<const float*>(scratch), T, K, O,
      range, nblk);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 4 * K * nblk floats when nblk > 1 (unused otherwise); dm, da1t
// and dwr may be null.
extern "C" int gated_pool_backward(const void* a_raw, const void* b,
                                   const void* mask, const void* w,
                                   const void* a1t, const void* dm,
                                   const void* da1t, const void* dwr,
                                   void* da_raw, void* db, void* dw,
                                   void* scratch, int T, int K, int O,
                                   int range, int nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, K);
  const Cotangents cot{static_cast<const float*>(dm),
                       static_cast<const float*>(da1t),
                       static_cast<const float*>(dwr)};
  const float* a = static_cast<const float*>(a_raw);
  const float* bb = static_cast<const float*>(b);
  const float* mk = static_cast<const float*>(mask);
  const float* ww = static_cast<const float*>(w);
  float* stats = static_cast<float*>(scratch);
  float* dw_stats = stats == nullptr ? nullptr : stats + (size_t)2 * K * nblk;
  gated_pool_bwd_partial_kernel<<<grid, kThreads, 0, s>>>(
      a, bb, mk, ww, static_cast<const float*>(a1t), cot,
      static_cast<float*>(da_raw), static_cast<float*>(db),
      static_cast<float*>(dw), stats, T, K, O, range, nblk == 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return static_cast<int>(err);
  gated_pool_bwd_middle_kernel<<<grid, kThreads, 0, s>>>(
      a, bb, mk, ww, cot, static_cast<float*>(da_raw), stats, dw_stats, T, K,
      O, range, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gated_pool_bwd_finish_kernel<<<K, kThreads, 0, s>>>(
      ww, dw_stats, static_cast<float*>(dw), nblk);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- split at the reduction
//
// The entries below are the one-call entries cut where their passes meet:
// at the sums over T. A bag whose tile axis is split across ranks
// (parallel/mesh.py) calls the partials entry on its shard, all-reduces the
// small table it returns across the ranks, and calls the finish entry with
// the totals. The ranges of a shard are summed in sum_partials' fixed order
// (gated_pool_reduce_kernel), as the one-call entries sum them, so a split
// call on a single shard gives the one-call entry's outputs bit for bit.

// partials [K, 1+O] = (sum_T gated, sum_T gated * B[:, o]) over this shard;
// scratch: K * nblk * (1+O) floats when nblk > 1 (unused otherwise).
extern "C" int gated_pool_forward_partials(const void* a_raw, const void* b,
                                           const void* mask, const void* w,
                                           void* partials, void* scratch,
                                           int T, int K, int O, int range,
                                           int nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partials);
  float* rows = nblk == 1 ? out : static_cast<float*>(scratch);
  gated_pool_partial_kernel<<<dim3(nblk, K), kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w), nullptr,
      nullptr, nullptr, rows, T, K, O, range, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return static_cast<int>(err);
  gated_pool_reduce_kernel<<<K, kThreads, 0, s>>>(rows, out, nblk, 1 + O);
  return static_cast<int>(cudaGetLastError());
}

// From the all-reduced totals [K, 1+O]: M [K, O], and this shard's A1T and
// wROIs columns [K, T].
extern "C" int gated_pool_forward_finish(const void* a_raw, const void* b,
                                         const void* mask, const void* w,
                                         const void* totals, void* m,
                                         void* a1t, void* wrois, int T, int K,
                                         int O, int range, int nblk,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  gated_pool_finish_kernel<<<dim3(nblk, K), kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<float*>(m), static_cast<float*>(a1t),
      static_cast<float*>(wrois), static_cast<const float*>(totals), T, K, O,
      range, 1);
  return static_cast<int>(cudaGetLastError());
}

// stats [K, 2] = (sum_T gated, sum_T da1 * A1) over this shard, and this
// shard's dB rows (no sum over T). scratch: 2 * K * nblk floats when
// nblk > 1. dm is the cotangent of the replicated M, the same on every
// rank; da1t and dwr are this shard's columns. Each may be null.
extern "C" int gated_pool_backward_partials(
    const void* a_raw, const void* b, const void* mask, const void* w,
    const void* a1t, const void* dm, const void* da1t, const void* dwr,
    void* db, void* stats, void* scratch, int T, int K, int O, int range,
    int nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cotangents cot{static_cast<const float*>(dm),
                       static_cast<const float*>(da1t),
                       static_cast<const float*>(dwr)};
  float* out = static_cast<float*>(stats);
  float* rows = nblk == 1 ? out : static_cast<float*>(scratch);
  gated_pool_bwd_partial_kernel<<<dim3(nblk, K), kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<const float*>(a1t), cot, nullptr, static_cast<float*>(db),
      nullptr, rows, T, K, O, range, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return static_cast<int>(err);
  gated_pool_reduce_kernel<<<K, kThreads, 0, s>>>(rows, out, nblk, 2);
  return static_cast<int>(cudaGetLastError());
}

// From the all-reduced stats [K, 2]: this shard's dA_raw rows and its part
// of dw (linear in the shard's sums, so the ranks' parts add up to dw).
// dw_scratch: 2 * K * nblk floats.
extern "C" int gated_pool_backward_finish(
    const void* a_raw, const void* b, const void* mask, const void* w,
    const void* dm, const void* da1t, const void* dwr, const void* totals,
    void* da_raw, void* dw, void* dw_scratch, int T, int K, int O, int range,
    int nblk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cotangents cot{static_cast<const float*>(dm),
                       static_cast<const float*>(da1t),
                       static_cast<const float*>(dwr)};
  const float* ww = static_cast<const float*>(w);
  float* dw_rows = static_cast<float*>(dw_scratch);
  gated_pool_bwd_middle_kernel<<<dim3(nblk, K), kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), ww, cot, static_cast<float*>(da_raw),
      static_cast<const float*>(totals), dw_rows, T, K, O, range, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gated_pool_bwd_finish_kernel<<<K, kThreads, 0, s>>>(
      ww, dw_rows, static_cast<float*>(dw), nblk);
  return static_cast<int>(cudaGetLastError());
}
