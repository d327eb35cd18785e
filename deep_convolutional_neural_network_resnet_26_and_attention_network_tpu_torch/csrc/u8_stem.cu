// Fused uint8 ResNet stem for Hopper (sm_90a): normalize, then the 7x7
// stride-2 pad-3 convolution from 3 to 20 channels, plus the bias, as an
// implicit GEMM on the bf16 tensor cores.
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
// [B,150,150,20]. The products of two bf16 values are exact in float32, so
// the kernel and its plain version (ops/u8_stem.py) differ only in the order
// (and the tensor cores' internal rounding) of the sums.
//
// Bound on an H100 SXM: per tile 270 KB of uint8 in and 150*150*20*4 B =
// 1.8 MB of float32 out. At the serving chunk of 1024 tiles that is 2.1 GB,
// 0.63 ms at 3.35 TB/s. The 147-tap products are 0.14 ms on the bf16 tensor
// cores but about 2 ms as float32 FMAs on the CUDA cores. So the bytes bound
// the kernel only when the products run on the tensor cores; the float32
// output is most of the bytes.
//
// Design. The GEMM is M = output pixels, N = 20 channels padded to 24 (three
// n8 tiles), K = 256. K is the TPU kernel's space-to-depth order: the padded
// image's 2x2 pixel blocks are folded pixels P[R][C] of 12 channels
// (rp*6 + cp*3 + c, padded to 16), the 7x7/s2 conv is a 4x4/s1 conv over P,
// and k = (a*4 + b)*16 + ch. One tap (a, b) is then one k16 step of
// mma.sync.m16n8k16 (bf16 in, float32 accumulate), and its A operand, 16
// output pixels of one row, is 16 consecutive folded pixels of 32 bytes each:
// one ldmatrix.x4 straight from shared memory, no im2col gather. mma.sync is
// enough: the whole GEMM (K = 256 with the padding, N = 24) is about 0.3 ms
// at the dense bf16 peak, under the byte bound, so wgmma's higher rate would
// buy nothing here and its 64-row tiles fit a 150-pixel row badly.
//
// Work is an item per (tile, band of 8 output rows): 19 bands a tile, the
// last with rows 144-149. The kernel is persistent: as many blocks of 8
// warps as fit on the card at once (two an SM) walk the items, so each block
// packs the weights into shared memory once, and the uint8 rows of its next
// item arrive by cp.async while it computes the current one. An item's 22
// image rows come in by 4-byte copies, all in flight at once (a row is 900
// bytes, so every row starts 4-byte aligned; 900 is not a multiple of 16,
// which rules out a 2-D TMA map). The block normalizes them once into the
// band's 11 folded rows, bf16 [11][163][16] in shared memory (columns 152-162
// and channels 12-15 are zeros, so the last 16-pixel M tile of a row reads
// zeros and out-of-image taps need no correction); a thread builds two
// adjacent folded pixels from four 32-bit shared loads a row, so no pass
// zeroes the band first. The two 16-byte halves of folded pixel C are swapped
// when bit 2 of C is set: ldmatrix's 8 row addresses at a 32-byte stride
// would otherwise hit the same banks two ways. The packed weights [24][256]
// bf16, packed by the wrapper, sit in shared memory with a 528-byte row
// stride (also conflict-free) and are loaded as B fragments with ldmatrix
// once per tap for five M tiles. Warp w owns output row 8*band + w: its ten
// M tiles, five at a time (60 float32 accumulators a thread), the 16 taps
// unrolled so that every ldmatrix address is a per-lane base plus a
// constant. Each M tile's 16 x 20 sums plus the bias go through a
// 1280-byte shared staging buffer of the warp, so the output leaves as
// contiguous 16-byte stores: one M tile is 1280 contiguous bytes of the NHWC
// output (6 pixels, 480 bytes, for the last). All offsets into x and out
// are 64-bit. 100,088 bytes of shared memory and at most 128 registers a
// thread let two blocks share an SM, so one block's normalize overlaps the
// other's products and stores.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kIn = 300;                      // tile side, the only shape
constexpr int kOut = 150;                     // output side
constexpr int kCout = 20;                     // live output channels
constexpr int kN = 24;                        // channels padded to 3 n8 tiles
constexpr int kK = 256;                       // 16 taps x 16 folded channels
constexpr int kRows = 8;                      // output rows per block
constexpr int kWarps = kRows;                 // one output row per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBands = (kOut + kRows - 1) / kRows;   // 19
constexpr int kMTiles = 10;                   // 16-pixel M tiles a row: 160
constexpr int kGroup = 5;                     // M tiles summed at once
constexpr int kBandRows = kRows + 3;          // folded rows a band reads: 11
constexpr int kCols = kMTiles * 16 + 3;       // 163 folded columns
constexpr int kWStride = kK + 8;              // bf16 a weight row: 528 B
constexpr int kBandBytes = kBandRows * kCols * 32;       // 57,376
constexpr int kWBytes = kN * kWStride * 2;               // 12,672
constexpr int kStageFloats = 16 * kCout;                 // one M tile
constexpr int kStageBytes = kWarps * kStageFloats * 4;   // 10,240
constexpr int kRowBytes = kIn * 3;                       // 900
constexpr int kRawRows = 2 * kBandRows;                  // 22 image rows
constexpr int kRawBytes = kRawRows * kRowBytes;          // 19,800
constexpr int kSmemBytes = kBandBytes + kWBytes + kStageBytes + kRawBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte half `half` (channels 8*half..8*half+7) of folded
// pixel (r, C) in the band; halves swap when bit 2 of C is set
__device__ __forceinline__ uint32_t band_off(int r, int C, int half) {
  return static_cast<uint32_t>(((r * kCols + C) * 2 + (half ^ ((C >> 2) & 1))) * 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Start the 4-byte asynchronous copies of the image rows that item's band
// reads (2*i0-3 .. 2*i0+18, those in the image) into raw, all in flight at
// once: a row is 900 bytes, so every row starts 4-byte aligned.
__device__ __forceinline__ void copy_rows(const uint8_t* __restrict__ x,
                                          int64_t item, uint8_t* raw) {
  const int64_t b = item / kBands;
  const int y0 = 2 * static_cast<int>(item % kBands) * kRows - 3;
  const int ylo = max(y0, 0);
  const int yhi = min(y0 + kRawRows, kIn);
  const uint8_t* src = x + b * static_cast<int64_t>(kIn * kRowBytes) +
                       static_cast<int64_t>(y0) * kRowBytes;
  for (int idx = threadIdx.x; idx < (yhi - ylo) * (kRowBytes / 4);
       idx += kThreads) {
    const int off = (ylo - y0) * kRowBytes + 4 * idx;
    cp_async4(raw + off, src + off);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The band's folded pixels from output row i0, two at a time: folded pixels
// (r, 2p) and (r, 2p+1) are image rows 2*(i0+r)-3+rp (raw row 2r+rp),
// columns 4p-3 .. 4p (cp = column & 1), channel rp*6 + cp*3 + c: 12 bytes of
// each row, inside the four aligned 32-bit words from byte 12p-12, read
// with four shared loads instead of 12 byte loads. Out-of-image taps are
// zeros. mul then add, unfused, as in the plain version's x * alpha + beta.
__device__ __forceinline__ void normalize_band(const uint8_t* raw,
                                               uint8_t* band, int i0,
                                               float alpha, float beta) {
  constexpr int kPairs = (kCols + 1) / 2;  // 82
  constexpr int kWords = kRowBytes / 4;    // 225
  for (int idx = threadIdx.x; idx < kBandRows * kPairs; idx += kThreads) {
    const int r = idx / kPairs;
    const int p = idx - r * kPairs;
    float v[2][16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[0][k] = v[1][k] = 0.0f;
#pragma unroll
    for (int rp = 0; rp < 2; ++rp) {
      const int y = 2 * (i0 + r) - 3 + rp;
      if (y < 0 || y >= kIn) continue;
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(raw + (2 * r + rp) * kRowBytes);
      uint32_t wd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int wi = 3 * (p - 1) + q;
        wd[q] = (wi >= 0 && wi < kWords) ? row[wi] : 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // image column 4p - 3 + j
        const int xx = 4 * p - 3 + j;
        if (xx < 0 || xx >= kIn) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int pos = 3 + 3 * j + c;  // byte in the 16-byte window
          const float q =
              static_cast<float>((wd[pos >> 2] >> (8 * (pos & 3))) & 0xffu);
          v[j >> 1][rp * 6 + (j & 1) * 3 + c] =
              __fadd_rn(__fmul_rn(q, alpha), beta);
        }
      }
    }
#pragma unroll
    for (int pix = 0; pix < 2; ++pix) {
      const int C = 2 * p + pix;
      if (C >= kCols) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* h = v[pix] + 8 * half;
        *reinterpret_cast<uint4*>(band + band_off(r, C, half)) =
            make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]),
                       pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
      }
    }
  }
}

// Persistent: block walks items (tile, band) blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 2)
u8_stem_kernel(const uint8_t* __restrict__ x, const uint4* __restrict__ w2,
               const float* __restrict__ bias, float* __restrict__ out,
               int64_t items, float alpha, float beta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* band = smem;                                    // folded input, bf16
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + kBandBytes);
  float* stage = reinterpret_cast<float*>(smem + kBandBytes + kWBytes);
  uint8_t* raw = smem + kBandBytes + kWBytes + kStageBytes;  // uint8 rows

  const int tid = threadIdx.x;
  int64_t item = blockIdx.x;
  copy_rows(x, item, raw);

  // packed weights [24][256] bf16 -> rows of kWStride, once for all items
  for (int idx = tid; idx < kN * kK / 8; idx += kThreads) {
    const int n = idx / (kK / 8);
    const int q = idx - n * (kK / 8);
    *reinterpret_cast<uint4*>(wsm + n * kWStride + q * 8) = w2[idx];
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t band_s = smem_u32(band);
  // B fragments: x4 gives n-tiles 0 and 1 (rows n = (lane>>4)*8 + lane%8),
  // x2 n-tile 2 (rows 16 + lane%8); lane bit 3 picks k 0-7 or 8-15.
  const uint32_t wb4 = smem_u32(wsm + ((lane >> 4) * 8 + (lane & 7)) * kWStride
                                + ((lane >> 3) & 1) * 8);
  const uint32_t wb2 = smem_u32(wsm + (16 + (lane & 7)) * kWStride
                                + ((lane >> 3) & 1) * 8);
  // A fragment: lane supplies pixel row am of the M tile, channel half ah.
  // For column shift tb its address in the warp's row is a_base[tb]; the
  // swizzle bit, bit 2 of am + tb, is the same in every M tile (16 apart).
  uint32_t a_base[4];
#pragma unroll
  for (int tb = 0; tb < 4; ++tb) {
    const int am = (lane & 7) + ((lane >> 3) & 1) * 8 + tb;
    a_base[tb] = band_s + band_off(warp, am, lane >> 4);
  }
  // epilogue: this lane's output pixels (g, g + 8) and channel pair n0
  const int g = lane >> 2;
  float bs[3][2];
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
    const int n0 = nt * 8 + 2 * (lane & 3);
    bs[nt][0] = n0 < kCout ? bias[n0] : 0.0f;
    bs[nt][1] = n0 < kCout ? bias[n0 + 1] : 0.0f;
  }
  float* stg = stage + warp * kStageFloats;

  for (; item < items; item += gridDim.x) {
    const int64_t b = item / kBands;
    const int i0 = static_cast<int>(item % kBands) * kRows;
    // this item's rows have landed, and every warp is done with the band
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    normalize_band(raw, band, i0, alpha, beta);
    __syncthreads();
    // raw is free: the next item's rows arrive while this one computes
    if (item + gridDim.x < items) copy_rows(x, item + gridDim.x, raw);

    const int i = i0 + warp;
    if (i >= kOut) continue;  // the last band's rows 150-151
    float* out_row = out + ((b * kOut + i) * kOut) * kCout;

#pragma unroll 1
    for (int grp = 0; grp < kMTiles / kGroup; ++grp) {
      float acc[kGroup][3][4];
#pragma unroll
      for (int mt = 0; mt < kGroup; ++mt)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const int ta = s >> 2;
        const int tb = s & 3;
        uint32_t w0, w1, w2r, w3, w4, w5;
        ldmatrix_x4(wb4 + s * 32, w0, w1, w2r, w3);
        ldmatrix_x2(wb2 + s * 32, w4, w5);
#pragma unroll
        for (int mt = 0; mt < kGroup; ++mt) {
          uint32_t a0, a1, a2, a3;
          ldmatrix_x4(a_base[tb] + (ta * kCols + (grp * kGroup + mt) * 16) * 32,
                      a0, a1, a2, a3);
          mma_bf16(acc[mt][0], a0, a1, a2, a3, w0, w1);
          mma_bf16(acc[mt][1], a0, a1, a2, a3, w2r, w3);
          mma_bf16(acc[mt][2], a0, a1, a2, a3, w4, w5);
        }
      }

#pragma unroll
      for (int mt = 0; mt < kGroup; ++mt) {
        const int j0 = (grp * kGroup + mt) * 16;
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) {
          const int n0 = nt * 8 + 2 * (lane & 3);
          if (n0 < kCout) {
            *reinterpret_cast<float2*>(stg + g * kCout + n0) = make_float2(
                acc[mt][nt][0] + bs[nt][0], acc[mt][nt][1] + bs[nt][1]);
            *reinterpret_cast<float2*>(stg + (g + 8) * kCout + n0) =
                make_float2(acc[mt][nt][2] + bs[nt][0],
                            acc[mt][nt][3] + bs[nt][1]);
          }
        }
        __syncwarp();
        const int n_vec = min(16, kOut - j0) * (kCout / 4);
        float4* dst = reinterpret_cast<float4*>(out_row + j0 * kCout);
        const float4* src = reinterpret_cast<const float4*>(stg);
        for (int q = lane; q < n_vec; q += 32) dst[q] = src[q];
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" int u8_stem_forward(const void* x, const void* w2, const void* bias,
                               void* out, long long batch, float alpha,
                               float beta, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      u8_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, u8_stem_kernel, kThreads, kSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = batch * kBands;
  const long long blocks = std::min<long long>(items, 1LL * per_sm * sms);
  u8_stem_kernel<<<static_cast<unsigned int>(blocks), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint4*>(w2),
      static_cast<const float*>(bias), static_cast<float*>(out), items, alpha,
      beta);
  return static_cast<int>(cudaGetLastError());
}
