// Fused uint8 ResNet stem for Hopper (sm_90a): normalize, then the 7x7
// stride-2 pad-3 convolution from 3 to 20 channels, plus the bias.
//
// Replaces the Pallas TPU kernel ops/pallas_stem.py:_stem_kernel (launched by
// _stem_pallas_call, public entry stem_u8_conv) of the JAX package. For uint8
// tiles x [B,300,300,3] (NHWC), OIHW float32 weights W [20,3,7,7] and bias
// [20], with bf16() rounding to bfloat16 (nearest even):
//
//   out[b,i,j,o] = bias[o] + sum_{u,v,c} bf16(W[o,c,u,v])
//                                      * bf16(alpha * x[b, 2i+u-3, 2j+v-3, c] + beta)
//
// summed in float32; a tap outside the image contributes 0, so this is the
// zero-padded convolution of the normalized image. out is float32 NHWC
// [B,150,150,20]. The TPU kernel's space-to-depth planes with a 256-lane row
// stride, its f32 lane rotate, its padding to 16 channels and its
// beta * (S - C1) boundary correction all existed for Mosaic; here
// out-of-range taps are zeros in shared memory and no correction is needed.
// The products of two bf16 values are exact in float32, so this kernel and
// its plain version (ops/u8_stem.py) differ only in the order of the sums.
//
// Bound on an H100 SXM: per tile 270 KB of uint8 in and 150*150*20*4 B =
// 1.8 MB of float32 out; 22,500 * 20 * 147 * 2 = 132 MFLOP. At the serving
// chunk of 1024 tiles that is 2.1 GB, 0.63 ms at 3.35 TB/s, against 0.14 ms
// on bf16 tensor cores or about 2 ms at the float32 rate of the CUDA cores.
// So the bound is the bytes, and the float32 output is most of them.
//
// Design (a simple, correct first version; mma/wgmma and TMA are later
// work). One block of 160 threads per (tile, band of kRows = 4 output rows).
// The band's 13 input rows, normalized and bf16-rounded once, sit in shared
// memory with a 3-pixel zero border on each side (13 x 306 x 3 floats), and
// so do the 20 x 147 bf16-rounded weights, laid out [tap][channel] so that a
// tap's 20 weights are five broadcast float4 loads. Thread j owns output
// column j (150 of the 160 threads) for all four rows of the band: each
// tap's weights are loaded once into registers and used for four pixels, so
// the inner loop is 80 FMAs for 9 shared-memory loads. The 4 x 20
// accumulators stay in registers; each pixel's 20 channels go out as five
// float4 stores, so a warp writes one contiguous 2.5 KB run of the NHWC
// output. The last band of a tile (rows 148-149) masks its stores; all
// offsets into x and out are 64-bit. The kernel is compute-bound on the
// CUDA cores, a few times above the byte bound.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 300;                     // tile side, the only shape
constexpr int kOut = 150;                    // output side
constexpr int kCin = 3;
constexpr int kCout = 20;
constexpr int kTaps = 7 * 7 * kCin;          // 147
constexpr int kRows = 4;                     // output rows per block
constexpr int kBands = (kOut + kRows - 1) / kRows;  // 38; the last has 2 rows
constexpr int kInRows = 2 * kRows + 5;       // 13 input rows per band
constexpr int kInCols = kIn + 6;             // 306: 3-pixel border each side
constexpr int kThreads = 160;                // 150 columns, rounded to warps
constexpr int kWFloats = kTaps * kCout;      // 2940
constexpr int kXFloats = kInRows * kInCols * kCin;  // 11934
constexpr size_t kSmemBytes = sizeof(float) * (kWFloats + kXFloats);

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads, 3)
u8_stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               float alpha, float beta) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // [kTaps][kCout], tap = (u*7 + v)*3 + c
  float* xs = smem + kWFloats;   // [kInRows][kInCols][kCin]

  const int band = blockIdx.x % kBands;
  const int64_t b = blockIdx.x / kBands;
  const int r0 = band * kRows;
  const int tid = threadIdx.x;

  // weights: OIHW in, [tap][o] out, rounded to bf16 once
  for (int idx = tid; idx < kWFloats; idx += kThreads) {
    const int o = idx / kTaps;
    const int r = idx - o * kTaps;   // c*49 + u*7 + v
    const int c = r / 49;
    const int uv = r - c * 49;
    ws[(uv * kCin + c) * kCout + o] = bf16_round(w[idx]);
  }

  // the band's input rows 2*r0-3 .. 2*r0+9, columns -3 .. 302; taps that
  // fall outside the image read zeros. mul then add, unfused, as in the
  // plain version's x * alpha + beta.
  const int row0 = 2 * r0 - 3;
  const uint8_t* xb = x + b * (int64_t)(kIn * kIn * kCin);
  for (int idx = tid; idx < kXFloats; idx += kThreads) {
    const int rr = idx / (kInCols * kCin);
    const int rem = idx - rr * (kInCols * kCin);
    const int gr = row0 + rr;
    const int gc = rem / kCin - 3;
    float v = 0.0f;
    if (gr >= 0 && gr < kIn && gc >= 0 && gc < kIn) {
      const float q = static_cast<float>(
          xb[(int64_t)gr * (kIn * kCin) + rem - 3 * kCin]);
      v = bf16_round(__fadd_rn(__fmul_rn(q, alpha), beta));
    }
    xs[idx] = v;
  }
  __syncthreads();

  const int j = tid;
  if (j >= kOut) return;

  float acc[kRows][kCout];
#pragma unroll
  for (int p = 0; p < kRows; ++p)
#pragma unroll
    for (int o = 0; o < kCout; ++o) acc[p][o] = 0.0f;

#pragma unroll 1
  for (int u = 0; u < 7; ++u) {
#pragma unroll 1
    for (int v = 0; v < 7; ++v) {
      const float* xcol = xs + (u * kInCols + 2 * j + v) * kCin;
#pragma unroll
      for (int c = 0; c < kCin; ++c) {
        const float4* wp = reinterpret_cast<const float4*>(
            ws + ((u * 7 + v) * kCin + c) * kCout);
        float wr[kCout];
#pragma unroll
        for (int q = 0; q < kCout / 4; ++q) {
          const float4 t = wp[q];
          wr[4 * q] = t.x;
          wr[4 * q + 1] = t.y;
          wr[4 * q + 2] = t.z;
          wr[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          // output row r0+p reads input row 2*(r0+p)+u-3 = row0 + 2p + u
          const float xv = xcol[2 * p * kInCols * kCin + c];
#pragma unroll
          for (int o = 0; o < kCout; ++o) acc[p][o] = fmaf(xv, wr[o], acc[p][o]);
        }
      }
    }
  }

  float bs[kCout];
#pragma unroll
  for (int o = 0; o < kCout; ++o) bs[o] = bias[o];
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int i = r0 + p;
    if (i >= kOut) break;
    float4* dst = reinterpret_cast<float4*>(
        out + ((b * kOut + i) * kOut + j) * kCout);
#pragma unroll
    for (int q = 0; q < kCout / 4; ++q)
      dst[q] = make_float4(acc[p][4 * q] + bs[4 * q],
                           acc[p][4 * q + 1] + bs[4 * q + 1],
                           acc[p][4 * q + 2] + bs[4 * q + 2],
                           acc[p][4 * q + 3] + bs[4 * q + 3]);
  }
}

}  // namespace

extern "C" int u8_stem_forward(const void* x, const void* w, const void* bias,
                               void* out, long long batch, float alpha,
                               float beta, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      u8_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = batch * kBands;
  u8_stem_kernel<<<static_cast<unsigned int>(blocks), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
