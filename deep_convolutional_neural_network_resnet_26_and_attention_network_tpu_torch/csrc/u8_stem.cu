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
// u8_stem_pool_kernel: the same stem with its epilogue in the same launch.
// The JAX package runs that epilogue (models/resnet's cast to bf16,
// LeakyReLU and 3x3/s2/p1 max-pool) as XLA ops after
// pallas_stem._stem_kernel; here the kernel writes
//
//   pooled[b,p,q,o] = leaky(bf16(max_{i = 2p-1..2p+1, j = 2q-1..2q+1}
//                                    out[b,i,j,o]))
//
// as bf16 NHWC [B,75,75,20], leaving out the window's positions outside the
// image (F.max_pool2d pads with -inf). Exact by construction: rounding to
// bf16 (nearest even) and PyTorch's LeakyReLU on bf16 (in float, v > 0 ? v
// : v * slope, rounded to bf16) are both non-decreasing, so the max of
// leaky(bf16(x)) over a window is leaky(bf16(max x)). The float32 sums are
// u8_stem_kernel's products in its order, so the output equals the
// composition max_pool2d(leaky_relu(out.to(bf16))) bit for bit (NaN aside).
//
// Its bound: per tile 270 KB of uint8 in and 75*75*20*2 B = 225 KB of bf16
// out; at 1024 tiles 0.506 GB, 0.151 ms at 3.35 TB/s, against 0.137 ms for
// the 147-tap products at the bf16 peak. The float32 output and the three
// passes over it (the cast, LeakyReLU and the max-pool: about 5.8 GB of
// traffic at 1024 tiles) are gone; what is left is the padded GEMM that
// mma.sync runs (about 0.3 ms at the dense bf16 peak) and the normalize.
// On an H100 SXM at 700 W the kernel takes 0.94 ms at 1024 tiles (the
// composition 5.6 ms), so it is no longer bound by bytes: by count its
// limit is mma.sync with one ldmatrix.x4 of A (4 shared-memory wavefronts)
// for every 3 products.
//
// Its design: the main loop, the band and the weights are u8_stem_kernel's.
// Pooled rows 4k..4k+3 need stem rows 8k-1..8k+7, band k's eight rows and
// the row above them, band k-1's last. That halo row is not recomputed (1/8
// more products): a block walks a contiguous run of items, so band k-1 is
// mostly the block's previous item, and each stem row's horizontal maxima
// stay in a ring of 9 bf16 rows in shared memory (slot (i+1) % 9 for stem
// row i), where band k-1's last row is still held when band k pools. A run
// that starts inside a tile first computes that one row (warp 7 of the band
// before: 1/74 more products at 1024 tiles). A row's horizontal max runs in
// registers after each group of five M tiles: pooled column q needs pixels
// 2q-1..2q+1, so the A fragment's rows are the M tile's pixels in the order
// 0, 2, .., 14, 1, 3, .., 15, and a lane's accumulator rows g and g+8 hold
// pixels 2g and 2g+1. Their sums plus the bias are rounded to bf16 pairs of
// channels, and one shuffle of pixel 2g+1 from lane g-1 and two bf16x2 max
// instructions give pooled column g; pixel 15 of the previous M tile rides in
// a register (-inf before the first). Those ldmatrix rows are 8 pixels at a
// stride of 2, so this kernel's band has a layout of its own (band_off<true>:
// the 16-byte halves of each 4-pixel group permuted by the group's index mod
// 4), which keeps them conflict-free, and the normalize writes it. After a
// __syncthreads the block takes the max of three ring rows,
// applies LeakyReLU, rounds to bf16 and stores the band's pooled rows (four,
// three in the last band), one contiguous run of 12,000 bytes, in coalesced
// 8-byte pieces: a tile is 225,000 bytes, so every other tile starts only
// 8-byte aligned. The 27,000-byte ring fits because the kernel keeps weight
// rows 0-19 alone (n-tile 2 reads rows 16-19 for its dropped columns 20-23)
// and needs no staging buffer: 114,736 bytes of shared memory, still two
// blocks an SM.
//
// C interface (loaded with ctypes): each entry launches its kernel and
// returns cudaGetLastError() after the launch, 0 on success.

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
// pixel (r, C) in the band. An ldmatrix reads 8 pixels of one folded row,
// and its 8 rows must hit 8 different bank groups. Without kPaired
// (u8_stem_kernel: 8 consecutive pixels) the halves swap when bit 2 of C is
// set. With kPaired (u8_stem_pool_kernel: 8 pixels at a stride of 2) the
// half's index among the 8 of its 4-pixel group is XORed with the group's
// index mod 4; the last group, pixels 160-162, keeps its order, so nothing
// lands in the slot of a pixel 163.
template <bool kPaired>
__device__ __forceinline__ uint32_t band_off(int r, int C, int half) {
  if (kPaired) {
    const int chunk = (2 * (C & 3) + half) ^ ((C >> 2) & 3);
    return static_cast<uint32_t>((r * kCols + (C & ~3)) * 32 + chunk * 16);
  }
  return static_cast<uint32_t>(((r * kCols + C) * 2 + (half ^ ((C >> 2) & 1))) * 16);
}
static_assert(((kCols - 1) >> 2) % 4 == 0, "the paired layout's last group");

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
template <bool kPaired>
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
        *reinterpret_cast<uint4*>(band + band_off<kPaired>(r, C, half)) =
            make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]),
                       pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
      }
    }
  }
}

// The first `rows` rows of the packed weights [kN][kK] bf16 into shared
// rows of kWStride.
__device__ __forceinline__ void load_weights(const uint4* __restrict__ w2,
                                             __nv_bfloat16* wsm, int rows) {
  for (int idx = threadIdx.x; idx < rows * (kK / 8); idx += kThreads) {
    const int n = idx / (kK / 8);
    const int q = idx - n * (kK / 8);
    *reinterpret_cast<uint4*>(wsm + n * kWStride + q * 8) = w2[idx];
  }
}

// A warp's ldmatrix addresses. B fragments: x4 gives n-tiles 0 and 1 (rows
// n = (lane>>4)*8 + lane%8), x2 n-tile 2 (rows 16 + lane%4: its columns
// 20-23 read rows 16-19 again, and both epilogues drop them, so weight rows
// 20-23 are never read); lane bit 3 picks k 0-7 or 8-15. A fragment: lane
// supplies row am of the M tile, channel half lane>>4. Row am is pixel am
// of the M tile, or with kPaired pixel 2*(am%8) + am/8, so that
// mma.sync's accumulator rows g and g+8 of a lane are pixels 2g and 2g+1.
// For column shift tb the address in the warp's row is a_base[tb]; the
// swizzle is the same in every M tile (16 pixels apart).
struct Frags {
  uint32_t wb4, wb2;
  uint32_t a_base[4];
};

template <bool kPaired>
__device__ __forceinline__ Frags fragments(const uint8_t* band,
                                           const __nv_bfloat16* wsm,
                                           int warp, int lane) {
  Frags f;
  f.wb4 = smem_u32(wsm + ((lane >> 4) * 8 + (lane & 7)) * kWStride
                   + ((lane >> 3) & 1) * 8);
  f.wb2 = smem_u32(wsm + (16 + (lane & 3)) * kWStride
                   + ((lane >> 3) & 1) * 8);
  const uint32_t band_s = smem_u32(band);
#pragma unroll
  for (int tb = 0; tb < 4; ++tb) {
    const int px = kPaired ? 2 * (lane & 7) + ((lane >> 3) & 1)
                           : (lane & 7) + ((lane >> 3) & 1) * 8;
    f.a_base[tb] = band_s + band_off<kPaired>(warp, px + tb, lane >> 4);
  }
  return f;
}

// This lane's bias of channel pairs n0 = nt*8 + 2*(lane & 3), 0 past kCout.
__device__ __forceinline__ void load_bias(const float* __restrict__ bias,
                                          int lane, float (&bs)[3][2]) {
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
    const int n0 = nt * 8 + 2 * (lane & 3);
    bs[nt][0] = n0 < kCout ? bias[n0] : 0.0f;
    bs[nt][1] = n0 < kCout ? bias[n0 + 1] : 0.0f;
  }
}

// The main loop of both kernels: the 16 taps of M tiles grp*kGroup ..
// grp*kGroup + kGroup-1 of the warp's output row, summed from 0 in acc, the
// taps unrolled so that every ldmatrix address is a per-lane base plus a
// constant. acc[mt][nt] holds pixels g and g+8 (g = lane>>2) of M tile mt,
// channels nt*8 + 2*(lane&3) + {0, 1}: mma.sync's accumulator layout.
__device__ __forceinline__ void row_products(float (&acc)[kGroup][3][4],
                                             const Frags& f, int grp) {
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
    ldmatrix_x4(f.wb4 + s * 32, w0, w1, w2r, w3);
    ldmatrix_x2(f.wb2 + s * 32, w4, w5);
#pragma unroll
    for (int mt = 0; mt < kGroup; ++mt) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(f.a_base[tb] + (ta * kCols + (grp * kGroup + mt) * 16) * 32,
                  a0, a1, a2, a3);
      mma_bf16(acc[mt][0], a0, a1, a2, a3, w0, w1);
      mma_bf16(acc[mt][1], a0, a1, a2, a3, w2r, w3);
      mma_bf16(acc[mt][2], a0, a1, a2, a3, w4, w5);
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

  int64_t item = blockIdx.x;
  copy_rows(x, item, raw);
  load_weights(w2, wsm, kCout);  // once for all items

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Frags f = fragments<false>(band, wsm, warp, lane);
  // epilogue: this lane's output pixels (g, g + 8) and channel pair n0
  const int g = lane >> 2;
  float bs[3][2];
  load_bias(bias, lane, bs);
  float* stg = stage + warp * kStageFloats;

  for (; item < items; item += gridDim.x) {
    const int64_t b = item / kBands;
    const int i0 = static_cast<int>(item % kBands) * kRows;
    // this item's rows have landed, and every warp is done with the band
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    normalize_band<false>(raw, band, i0, alpha, beta);
    __syncthreads();
    // raw is free: the next item's rows arrive while this one computes
    if (item + gridDim.x < items) copy_rows(x, item + gridDim.x, raw);

    const int i = i0 + warp;
    if (i >= kOut) continue;  // the last band's rows 150-151
    float* out_row = out + ((b * kOut + i) * kOut) * kCout;

#pragma unroll 1
    for (int grp = 0; grp < kMTiles / kGroup; ++grp) {
      float acc[kGroup][3][4];
      row_products(acc, f, grp);

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

// ---------------------------------------------------------------- pooled
constexpr int kPoolOut = kOut / 2;                    // 75 pooled rows, cols
constexpr int kPoolRows = kRows / 2;                  // pooled rows a band: 4
constexpr int kSlots = kRows + 1;                     // stem rows they pool: 9
constexpr int kPoolRowElems = kPoolOut * kCout;       // 1,500 bf16 a row
constexpr int kPieces = kPoolRowElems / 4;            // its 8-byte pieces
constexpr int kPoolWBytes = kCout * kWStride * 2;     // 10,560: rows 0-19
constexpr int kMaxBytes = kSlots * kPoolRowElems * 2; // 27,000
constexpr int kPoolSmemBytes =
    kBandBytes + kPoolWBytes + kRawBytes + kMaxBytes;  // 114,736
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPoolSmemBytes == 114736, "two blocks an SM need <= 115,712");

constexpr uint32_t kNegInf2 = 0xff80ff80u;          // bf16x2 of -inf

// The larger of each bf16 half of a and b.
__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// PyTorch's CUDA leaky_relu on a bf16 value v: in float, v > 0 ? v : v *
// slope, rounded to bf16 by the caller (pack_bf16); for v > 0, v is a bf16
// value already.
__device__ __forceinline__ float leaky(float v, float slope) {
  return v > 0.0f ? v : __fmul_rn(v, slope);
}

// One pooled 4-channel piece of pooled row p: the max over stem rows
// 2p-1 (not for p = 0), 2p and 2p+1 of their row maxima (slot of stem row
// i: (i + 1) % kSlots), then LeakyReLU, as four bf16 values.
__device__ __forceinline__ uint2 pool_piece(const uint8_t* rmax, int p,
                                            int piece, float slope) {
  const auto row = [&](int i) {
    return *reinterpret_cast<const uint2*>(
        rmax + (((i + 1) % kSlots) * kPoolRowElems + 4 * piece) * 2);
  };
  const uint2 a = row(2 * p);
  const uint2 c = row(2 * p + 1);
  float v0 = fmaxf(bf16_lo(a.x), bf16_lo(c.x));
  float v1 = fmaxf(bf16_hi(a.x), bf16_hi(c.x));
  float v2 = fmaxf(bf16_lo(a.y), bf16_lo(c.y));
  float v3 = fmaxf(bf16_hi(a.y), bf16_hi(c.y));
  if (p > 0) {  // stem row -1 is outside the image: max-pool pads with -inf
    const uint2 u = row(2 * p - 1);
    v0 = fmaxf(v0, bf16_lo(u.x));
    v1 = fmaxf(v1, bf16_hi(u.x));
    v2 = fmaxf(v2, bf16_lo(u.y));
    v3 = fmaxf(v3, bf16_hi(u.y));
  }
  return make_uint2(pack_bf16(leaky(v0, slope), leaky(v1, slope)),
                    pack_bf16(leaky(v2, slope), leaky(v3, slope)));
}

// Persistent: block walks the contiguous items [start, end), so that each
// band's last stem row is the next band's halo row; a run that starts
// inside a tile first computes the row above it (warp 7 of the band before).
__global__ void __launch_bounds__(kThreads, 2)
u8_stem_pool_kernel(const uint8_t* __restrict__ x,
                    const uint4* __restrict__ w2,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int64_t items,
                    float alpha, float beta, float slope) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* band = smem;                                    // folded input, bf16
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + kBandBytes);
  uint8_t* raw = smem + kBandBytes + kPoolWBytes;          // uint8 rows
  uint8_t* rmax = raw + kRawBytes;  // row maxima, bf16 [kSlots][75][20]

  const int64_t per = items / gridDim.x;
  const int64_t extra = items % gridDim.x;
  const int64_t bid = blockIdx.x;
  const int64_t start = bid * per + (bid < extra ? bid : extra);
  const int64_t end = start + per + (bid < extra ? 1 : 0);
  int64_t item = start % kBands != 0 ? start - 1 : start;
  copy_rows(x, item, raw);
  load_weights(w2, wsm, kCout);  // once for all items

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Frags f = fragments<true>(band, wsm, warp, lane);
  const int g = lane >> 2;
  const int up = (lane + 28) & 31;  // lane g-1's; at g = 0, lane 7's
  float bs[3][2];
  load_bias(bias, lane, bs);

  for (; item < end; ++item) {
    const int64_t b = item / kBands;
    const int k = static_cast<int>(item % kBands);
    const int i0 = k * kRows;
    // this item's rows have landed, and every thread is done with the band
    // and with the row maxima
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    normalize_band<true>(raw, band, i0, alpha, beta);
    __syncthreads();
    if (item + 1 < end) copy_rows(x, item + 1, raw);

    const bool halo = item < start;  // only its last row, for the next band
    const int i = i0 + warp;
    if (i < kOut && (!halo || warp == kWarps - 1)) {
      // the stem row's max over each pooled column's window (pixels 2q-1,
      // 2q, 2q+1; pixel -1 is -inf), in bf16x2 pairs of channels (the
      // rounding is monotone, so the max commutes with it): lane g holds
      // pixels 2g and 2g+1 of each M tile, one shuffle brings 2g-1 from
      // lane g-1, and carry holds the previous M tile's pixel 15
      uint8_t* slot = rmax + ((i + 1) % kSlots) * (kPoolRowElems * 2);
      uint32_t carry[3] = {kNegInf2, kNegInf2, kNegInf2};
#pragma unroll 1
      for (int grp = 0; grp < kMTiles / kGroup; ++grp) {
        float acc[kGroup][3][4];
        row_products(acc, f, grp);
#pragma unroll
        for (int mt = 0; mt < kGroup; ++mt) {
          const int q = (grp * kGroup + mt) * 8 + g;  // this lane's column
#pragma unroll
          for (int nt = 0; nt < 3; ++nt) {
            const uint32_t lo = pack_bf16(acc[mt][nt][0] + bs[nt][0],
                                          acc[mt][nt][1] + bs[nt][1]);
            const uint32_t hi = pack_bf16(acc[mt][nt][2] + bs[nt][0],
                                          acc[mt][nt][3] + bs[nt][1]);
            const uint32_t left = __shfl_sync(kFull, hi, up);
            const uint32_t m =
                bf16x2_max(bf16x2_max(lo, hi), g ? left : carry[nt]);
            carry[nt] = left;  // at g = 0: pixel 15
            const int n0 = nt * 8 + 2 * (lane & 3);
            if (n0 < kCout && q < kPoolOut)
              *reinterpret_cast<uint32_t*>(slot + (q * kCout + n0) * 2) = m;
          }
        }
      }
    }
    if (halo) continue;
    __syncthreads();  // every row maximum of the band is in rmax

    // pooled rows 4k .. 4k+3 (72-74 in the last band): one contiguous run
    // of the NHWC output, stored in 8-byte pieces (a tile is 225,000
    // bytes, so only every other tile starts 16-byte aligned)
    const int p0 = k * kPoolRows;
    const int n_pieces = min(kPoolRows, kPoolOut - p0) * kPieces;
    uint2* dst = reinterpret_cast<uint2*>(
        out + (b * kPoolOut + p0) * static_cast<int64_t>(kPoolRowElems));
    for (int idx = threadIdx.x; idx < n_pieces; idx += kThreads) {
      const int r = idx / kPieces;
      dst[idx] = pool_piece(rmax, p0 + r, idx - r * kPieces, slope);
    }
  }
}

// The blocks of a persistent launch: as many as fit on the card at once,
// at most one an item.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int smem, long long items,
                              long long* blocks, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = std::min<long long>(items, 1LL * *per_sm * sms);
  return cudaSuccess;
}

}  // namespace

extern "C" int u8_stem_forward(const void* x, const void* w2, const void* bias,
                               void* out, long long batch, float alpha,
                               float beta, void* stream) {
  const long long items = batch * kBands;
  long long blocks = 0;
  int per_sm = 0;
  cudaError_t err =
      persistent_blocks(u8_stem_kernel, kSmemBytes, items, &blocks, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  u8_stem_kernel<<<static_cast<unsigned int>(blocks), kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint4*>(w2),
      static_cast<const float*>(bias), static_cast<float*>(out), items, alpha,
      beta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int u8_stem_pool_forward(const void* x, const void* w2,
                                    const void* bias, void* out,
                                    long long batch, float alpha, float beta,
                                    float slope, void* stream) {
  const long long items = batch * kBands;
  long long blocks = 0;
  int per_sm = 0;
  cudaError_t err = persistent_blocks(u8_stem_pool_kernel, kPoolSmemBytes,
                                      items, &blocks, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  u8_stem_pool_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                        kPoolSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint4*>(w2),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      items, alpha, beta, slope);
  return static_cast<int>(cudaGetLastError());
}
