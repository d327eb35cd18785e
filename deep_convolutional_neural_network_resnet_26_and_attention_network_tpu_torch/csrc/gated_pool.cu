// Gated-attention MIL pooling, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ops/pallas_pool.py:_pool_kernel (launched by
// _pool_call, public entry gated_attention_pool) of the JAX package. For
// A_raw [T,K], B [T,O], mask [T] and gate w [K], all float32 and row-major:
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
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launches, 0 on success.

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

// Pass 1 over range blockIdx.x of map blockIdx.y. With one range (gridDim.x
// == 1) it also finishes: M[k], then A1T and wROIs. Otherwise it writes the
// range's sums to scratch[k][j][0..O].
__global__ void __launch_bounds__(kThreads)
gated_pool_partial_kernel(const float* __restrict__ a_raw,
                          const float* __restrict__ b,
                          const float* __restrict__ mask,
                          const float* __restrict__ w, float* __restrict__ m,
                          float* __restrict__ a1t, float* __restrict__ wrois,
                          float* __restrict__ scratch, int T, int K, int O,
                          int range) {
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
    if (nblk == 1) {
      denom = fmaxf(s[0], 1e-12f);
      if ((int)threadIdx.x < n_o)
        m[(size_t)k * O + o0 + threadIdx.x] = s[threadIdx.x + 1] / denom;
    } else {
      float* dst = scratch + ((size_t)k * nblk + j) * (1 + O);
      if (o0 == 0 && threadIdx.x == 0) dst[0] = s[0];
      if ((int)threadIdx.x < n_o) dst[1 + o0 + threadIdx.x] = s[threadIdx.x + 1];
    }
  }
  if (nblk == 1)
    write_range(a_raw, b, mask, gate, denom, t0, t1, T, K, k, O, a1t, wrois);
}

// The sum over the nblk ranges of column c of map k's partials, in a fixed
// order (a thread's strided share, then the block reduction); every thread
// gets it.
__device__ float sum_partials(const float* __restrict__ scratch, int k,
                              int nblk, int O, int c) {
  __shared__ float part[kWarps];
  const int tid = threadIdx.x;
  float v = 0.0f;
  for (int i = tid; i < nblk; i += kThreads)
    v += scratch[((size_t)k * nblk + i) * (1 + O) + c];
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
// partials, M[k] (block 0), then A1T and wROIs for the range.
__global__ void __launch_bounds__(kThreads)
gated_pool_finish_kernel(const float* __restrict__ a_raw,
                         const float* __restrict__ b,
                         const float* __restrict__ mask,
                         const float* __restrict__ w, float* __restrict__ m,
                         float* __restrict__ a1t, float* __restrict__ wrois,
                         const float* __restrict__ scratch, int T, int K,
                         int O, int range) {
  const int j = blockIdx.x;
  const int k = blockIdx.y;
  const int nblk = gridDim.x;
  const float denom = fmaxf(sum_partials(scratch, k, nblk, O, 0), 1e-12f);
  if (j == 0) {
    for (int o = 0; o < O; ++o) {
      const float s = sum_partials(scratch, k, nblk, O, 1 + o);
      if (threadIdx.x == 0) m[(size_t)k * O + o] = s / denom;
    }
  }
  const int t0 = j * range;
  write_range(a_raw, b, mask, Gate(w[k]), denom, t0, min(T, t0 + range), T, K,
              k, O, a1t, wrois);
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
      range);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 1) return static_cast<int>(err);
  gated_pool_finish_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<float*>(m), static_cast<float*>(a1t),
      static_cast<float*>(wrois), static_cast<const float*>(scratch), T, K, O,
      range);
  return static_cast<int>(cudaGetLastError());
}
