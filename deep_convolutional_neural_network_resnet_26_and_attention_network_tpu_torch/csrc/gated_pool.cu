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
// Design. One block of 256 threads per attention map k. The block loops over
// the whole tile axis, so there is no cap on T (the TPU kernel held the bag
// in VMEM and capped it at 2560 tiles; the streaming pool hands this kernel
// slides of 50k tiles). Pass 1 accumulates sum_t |gated| and
// sum_t gated * B[t, o] per thread, then reduces them across the block with
// warp shuffles and shared memory. Pass 2 recomputes gated (cheaper than
// storing it) and writes A1T and wROIs. M[k, o] = sum(gated * B) / denom.
// Output columns o are taken in groups of MAX_O so that any O works with the
// accumulators in registers; the main path has O = 1.
//
// Bound on an H100 SXM: 20 bytes in (A_raw row of 3, B, mask) and 24 bytes
// out (A1T and wROIs for 3 maps) per tile, 44 B/tile: about 90 KB at
// T = 2048, about 27 ns at 3.35 TB/s. The arithmetic is a few dozen
// operations per tile. In practice the kernel is bound by its launch and by
// the two serial passes of only K blocks; a later PR may split T across
// blocks. No single PyTorch call computes this function, so there is no
// library yardstick.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(kThreads)
gated_pool_kernel(const float* __restrict__ a_raw, const float* __restrict__ b,
                  const float* __restrict__ mask, const float* __restrict__ w,
                  float* __restrict__ m, float* __restrict__ a1t,
                  float* __restrict__ wrois, int T, int K, int O) {
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float wk = w[k];
  const float g1 = 1.0f / (1.0f + expf(10.0f * wk));   // sigmoid(-10 w)
  const float g0 = 1.0f / (1.0f + expf(-10.0f * wk));  // sigmoid(10 w)

  __shared__ float partial[kWarps][MAX_O + 1];
  __shared__ float total[MAX_O + 1];

  float denom = 0.0f;
  for (int o0 = 0; o0 < O; o0 += MAX_O) {
    const int n_o = min(MAX_O, O - o0);
    float s_abs = 0.0f;
    float s_gb[MAX_O];
#pragma unroll
    for (int j = 0; j < MAX_O; ++j) s_gb[j] = 0.0f;

#pragma unroll 4
    for (int t = tid; t < T; t += kThreads) {
      const float act = softplus_f(a_raw[(size_t)t * K + k]);
      const float gated = (g1 * act + g0) * mask[t];
      s_abs += fabsf(gated);
      const float* brow = b + (size_t)t * O + o0;
#pragma unroll
      for (int j = 0; j < MAX_O; ++j)
        if (j < n_o) s_gb[j] += gated * brow[j];
    }

    s_abs = warp_sum(s_abs);
#pragma unroll
    for (int j = 0; j < MAX_O; ++j) s_gb[j] = warp_sum(s_gb[j]);
    if (lane == 0) {
      partial[warp][0] = s_abs;
#pragma unroll
      for (int j = 0; j < MAX_O; ++j) partial[warp][j + 1] = s_gb[j];
    }
    __syncthreads();
    if (tid <= MAX_O) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += partial[i][tid];
      total[tid] = s;
    }
    __syncthreads();
    denom = fmaxf(total[0], 1e-12f);
    if (tid < n_o) m[(size_t)k * O + o0 + tid] = total[tid + 1] / denom;
    __syncthreads();  // partial/total are reused by the next group
  }

  float* a1t_row = a1t + (size_t)k * T;
  float* w_row = wrois + (size_t)k * T;
#pragma unroll 4
  for (int t = tid; t < T; t += kThreads) {
    const float act = softplus_f(a_raw[(size_t)t * K + k]);
    const float gated = (g1 * act + g0) * mask[t];
    const float a1 = gated / denom;
    a1t_row[t] = a1;
    w_row[t] = a1 * b[(size_t)t * O];
  }
}

}  // namespace

extern "C" int gated_pool_forward(const void* a_raw, const void* b,
                                  const void* mask, const void* w, void* m,
                                  void* a1t, void* wrois, int T, int K, int O,
                                  void* stream) {
  gated_pool_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_raw), static_cast<const float*>(b),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<float*>(m), static_cast<float*>(a1t),
      static_cast<float*>(wrois), T, K, O);
  return static_cast<int>(cudaGetLastError());
}
