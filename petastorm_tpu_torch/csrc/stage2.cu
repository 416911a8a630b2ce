// The batched JPEG stage 2 for Hopper (sm_90a) as two kernels a layout group:
//
// 1. `stage2_planes`: a group's shipped coefficient slabs -> range-limited uint8 planes
//    (images, by*8, bx*8), one plane a component. It folds the stage-2 unpack and
//    dequantisation (petastorm_tpu/ops/jpeg.py:552-602, `unpack12`, `unpack4` and the
//    pad / unzigzag / `coef * qtab` of `_batched_stage2`, fused jnp), K1's product
//    (petastorm_tpu/ops/jpeg.py:311 `_idct_kernel`, launched :498) and the range limit and
//    block-to-plane transpose (jpeg.py:604-608) into one pass: the (N, 64) float32 blocks
//    between them never reach device memory.
// 2. `stage2_rgb`: those planes -> (images, h, w, 3) uint8, RGB or BGR: libjpeg's triangle
//    upsample of the chroma (jpeg.py:337 `_fancy_upsample2`, vertical then horizontal,
//    edges clamped at the padded plane), the crop to (h, w), the YCbCr -> RGB conversion
//    (jpeg.py:351 `ycbcr_to_rgb`) and its round / clip / uint8 (jpeg.py:610-618). The
//    upsample reads neighbouring blocks, which is why it is a kernel of its own.
//
// What each computes, exactly as the reference does in float32:
//  - planes: coef(b, j) from the shipped row (kind int16: k values, natural order when
//    k == 64, else the zigzag prefix; kind pack12: the 12-bit pack of that row, two values
//    in 3 bytes; kind split: zigzag order, a 12-bit head [0, k1), an int8 mid [k1, k2) and
//    a 4-bit tail [k2, k)), 0 past k; x = __fmul_rn(coef, qtab[image, j]); the IDCT value
//    is a 64-term fmaf chain in natural k order from 0 (idct_tile.cuh), + 128 with
//    __fadd_rn; then rintf (round half to even, as torch.round and jnp.round) and a clamp
//    to [0, 255].
//  - rgb: per component and axis with ratio r = max sampling / the component's: r == 2
//    the triangle filter (3 * near + far) * 0.25, r > 2 a nearest repeat, r == 1 a copy.
//    On integers 0..255 the filter is exact in float32 whatever the order, so it is done
//    in integers and scaled by 1/4 or 1/16. Colour with the reference's float32 constants
//    and order, as its jitted stage 2 computes it: XLA contracts each multiply-add of
//    `ycbcr_to_rgb` into one fused multiply-add, so r = fma(1.402, cr - 128, y),
//    g = fma(-0.714136, cr - 128, fma(-0.344136, cb - 128, y)), b = fma(1.772, cb - 128, y),
//    written with __fmaf_rn and __fsub_rn so that nvcc neither splits nor adds a fusion
//    (rounding each product on its own changes ~1 value in 100,000); then rintf and a
//    clamp. One component: the Y plane copied to three channels.
//
// Bound on an H100 SXM at the main path's batch (256 images of 224x224 at 4:2:0, 301,056
// blocks): `stage2_planes` by operations, 2 * 301,056 * 64 * 64 = 2.47 GFLOP of float32
// FMAs (0.0368 ms at 67 TFLOP/s) against 32.5 MB of shipped bytes, tables and planes
// (0.0097 ms at 3.35 TB/s); `stage2_rgb` by bytes, 19,267,584 in + 38,535,168 out
// (0.0172 ms).
//
// Design of `stage2_planes` (K1's shape, with a new load and store):
//  - ONE launch for a group's components (up to four segments, passed by value); 128
//    threads a block, persistent blocks (two an SM) walk the segments' 128-block tiles;
//  - the tile's SHIPPED bytes (~43 a block for the corpus's split, 128 for int16) enter a
//    two-stage ring in shared memory with cp.async, the next tile's in flight while this
//    one computes; the threads then unpack and dequantise them into K1's padded float
//    tile, each thread always the same four natural positions (its pick of bytes, shift
//    and width is made once a tile);
//  - K1's register micro-tile product (idct_tile.cuh), unchanged;
//  - the range-limited bytes go to a staging tile in shared memory, laid out by pixel row,
//    and leave as coalesced 16-byte stores (two neighbouring blocks of one block row) when
//    the plane's width in blocks is even, else 8-byte stores.
// Design of `stage2_rgb`: one warp an output row at a time, eight pixels a lane. Each lane
// reads its samples with one 8-byte load a plane row at ratio 1 and one 4-byte load at
// ratio 2 (the filter's outer neighbours come from the next lanes by shuffle), so a
// warp's loads are contiguous; the colour goes to a staging row in shared memory at the
// output's alignment and leaves as 16-byte stores. No block-wide barrier.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_tile.cuh"

extern "C" {

// One component of `stage2_planes` (the layout of ctypes' PlaneSegmentDesc in
// ops/kernels.py).
struct PlaneSegmentDesc {
  const void* src0;      // int16 row, the 12-bit pack, or the split's head
  const void* src1;      // split: the int8 mid
  const void* src2;      // split: the 4-bit tail
  const int32_t* qtab;   // (images, 64) natural order
  uint8_t* out;          // (images, by * 8, bx * 8)
  int64_t rows;          // images * blocks
  int64_t blocks;        // blocks an image (by * bx)
  int32_t bx;            // blocks a block row
  int32_t kind;
  int32_t k;             // positions shipped a block (even, 2..64)
  int32_t k1, k2;        // split points (kind 2)
  int32_t zigzag;        // rows in zigzag order (k < 64, or kind 2)
};

// `stage2_rgb`'s arguments (the layout of ctypes' RgbDesc in ops/kernels.py).
struct RgbDesc {
  const uint8_t* plane[3];  // (images, rows[c], cols[c]) uint8
  uint8_t* out;             // (images, height, width, 3) uint8
  int64_t images;
  int32_t rows[3], cols[3];
  int32_t ry[3], rx[3];     // vertical and horizontal ratios
  int32_t height, width, ncomp, bgr;
};

}  // extern "C"

namespace {

constexpr int kMaxSegments = 4;
constexpr int kMaxDevices = 64;
constexpr int kTileRows = ptpu::kIdctTileRows;
constexpr int kThreads = ptpu::kIdctThreads;
constexpr int kStride = ptpu::kIdctStride;
// a tile's shipped bytes at most (int16 at k = 64: 128 bytes a block), with room for the
// 16-byte alignment of three slab regions and for the two-byte reads at a region's end
constexpr int kRingBytes = kTileRows * 128 + 64;
constexpr int kStageBytes = kTileRows * 64;  // uint8 results, [pixel row][block][8]
constexpr int kPlanesSmem = (ptpu::kIdctBasisFloats + ptpu::kIdctTileFloats) * 4 +
                            kStageBytes + 2 * kRingBytes;

enum Kind { kInt16 = 0, kPack12 = 1, kSplit = 2 };

// natural position -> zigzag position (UNZIGZAG)
__constant__ uint8_t kNaturalToZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

struct Seg {
  const uint8_t* src[3];
  const int32_t* qtab;
  uint8_t* out;
  int32_t rows, blocks, bx;
  int32_t width[3];   // bytes a block in each slab
  int32_t region[3];  // offset of each slab's bytes in a ring stage (16-byte aligned)
  int32_t kind, k, k1, k2, zigzag;
};

struct PlanesParams {
  Seg seg[kMaxSegments];
  int32_t first_tile[kMaxSegments + 1];  // tile index where each segment starts
  int32_t count;
};

// Where one shipped value sits in a block's bytes: read two bytes at `off` of the slab's
// region, shift, mask to `mask` and sign-extend from `half`; mask 0 reads 0.
struct Pick {
  int32_t region, width, off, shift;
  uint32_t mask, half;
};

__device__ __forceinline__ Pick make_pick(const Seg& s, int p) {
  Pick pk = {0, 0, 0, 0, 0u, 0u};
  if (p >= s.k) return pk;
  int r = 0, bits;
  if (s.kind == kInt16) {
    pk.off = 2 * p;
    bits = 16;
  } else if (s.kind == kPack12 || p < s.k1) {
    pk.off = (p >> 1) * 3 + (p & 1);
    pk.shift = (p & 1) * 4;
    bits = 12;
  } else if (p < s.k2) {
    r = 1;
    pk.off = p - s.k1;
    bits = 8;
  } else {
    const int t = p - s.k2;
    r = 2;
    pk.off = t >> 1;
    pk.shift = (t & 1) * 4;
    bits = 4;
  }
  pk.region = s.region[r];
  pk.width = s.width[r];
  pk.mask = (1u << bits) - 1u;
  pk.half = 1u << (bits - 1);
  return pk;
}

__device__ __forceinline__ float pick_value(const uint8_t* ring, const Pick& pk, int blk) {
  const uint8_t* b = ring + pk.region + blk * pk.width + pk.off;
  const uint32_t raw = static_cast<uint32_t>(b[0]) | (static_cast<uint32_t>(b[1]) << 8);
  const uint32_t v = (raw >> pk.shift) & pk.mask;
  return static_cast<float>(static_cast<int32_t>(v) - static_cast<int32_t>((v & pk.half) << 1));
}

__device__ __forceinline__ int locate(const PlanesParams& prm, int tile) {
  int si = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < prm.count && tile >= prm.first_tile[i]) si = i;
  }
  return si;
}

// One tile's shipped bytes into a ring stage: 16-byte cp.async copies (the tile's bytes
// start 16-byte aligned: the tile's first block is a multiple of 128), the slab's ragged
// end byte by byte.
__device__ __forceinline__ void load_tile(const Seg& s, int b0, int nb, uint8_t* stage) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int w = s.width[r];
    if (w == 0) continue;
    const uint8_t* src = s.src[r];
    const int64_t start = static_cast<int64_t>(b0) * w;
    const int64_t total = static_cast<int64_t>(s.rows) * w;
    uint8_t* dst = stage + s.region[r];
    const int chunks = (nb * w + 15) >> 4;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const int64_t at = start + (static_cast<int64_t>(c) << 4);
      if (at + 16 <= total) {
        __pipeline_memcpy_async(dst + (c << 4), src + at, 16);
      } else {
        for (int e = 0; at + e < total; ++e) dst[(c << 4) + e] = src[at + e];
      }
    }
  }
}

__device__ __forceinline__ uint32_t range_limit4(float a, float b, float c, float d) {
  const float v[4] = {a, b, c, d};
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = fminf(fmaxf(rintf(__fadd_rn(v[e], 128.f)), 0.f), 255.f);
    out |= static_cast<uint32_t>(x) << (8 * e);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads, 2)
stage2_planes_kernel(const __grid_constant__ PlanesParams prm, const float* __restrict__ basis) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_basis = reinterpret_cast<float*>(smem);
  float* s_tile = s_basis + ptpu::kIdctBasisFloats;
  uint8_t* s_stage = reinterpret_cast<uint8_t*>(s_tile + ptpu::kIdctTileFloats);
  uint8_t* s_ring = s_stage + kStageBytes;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // micro-tile columns 4*tx .. 4*tx+3 and 32+4*tx .. 32+4*tx+3
  const int ty = tid >> 3;  // micro-tile rows ty + 16*i, i = 0..7
  const int j0 = (tid & 15) * 4;  // the four natural positions this thread unpacks
  int zz[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) zz[e] = kNaturalToZigzag[j0 + e];

  for (int f = tid; f < ptpu::kIdctBasisFloats / 4; f += kThreads) {
    reinterpret_cast<float4*>(s_basis)[f] = reinterpret_cast<const float4*>(basis)[f];
  }

  const int n_tiles = prm.first_tile[prm.count];
  int tile = blockIdx.x;
  if (tile < n_tiles) {
    const int si = locate(prm, tile);
    const Seg& s = prm.seg[si];
    const int b0 = (tile - prm.first_tile[si]) * kTileRows;
    load_tile(s, b0, min(kTileRows, s.rows - b0), s_ring);
  }
  __pipeline_commit();
  for (int stage = 0; tile < n_tiles; tile += gridDim.x, stage ^= 1) {
    const int next = tile + gridDim.x;
    // the other ring stage was last read in the previous iteration, before a barrier
    if (next < n_tiles) {
      const int si = locate(prm, next);
      const Seg& s = prm.seg[si];
      const int b0 = (next - prm.first_tile[si]) * kTileRows;
      load_tile(s, b0, min(kTileRows, s.rows - b0), s_ring + (stage ^ 1) * kRingBytes);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of `tile` have landed
    __syncthreads();           // everyone's have (and the basis is in place)

    const int si = locate(prm, tile);
    const Seg& s = prm.seg[si];
    const int b0 = (tile - prm.first_tile[si]) * kTileRows;
    const int nb = min(kTileRows, s.rows - b0);
    const uint8_t* ring = s_ring + stage * kRingBytes;

    // unpack and dequantise into the float tile (rows past the segment stay as they are:
    // their results are never stored)
    Pick pk[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pk[e] = make_pick(s, s.zigzag ? zz[e] : j0 + e);
    int image = (b0 + (tid >> 4)) / s.blocks;  // this thread's blocks step by 8: follow
    int rem = b0 + (tid >> 4) - image * s.blocks;  // their image without dividing again
    for (int blk = tid >> 4; blk < nb; blk += kThreads / 16) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(s.qtab + static_cast<int64_t>(image) * 64 + j0));
      float4 x;
      x.x = __fmul_rn(pick_value(ring, pk[0], blk), static_cast<float>(q.x));
      x.y = __fmul_rn(pick_value(ring, pk[1], blk), static_cast<float>(q.y));
      x.z = __fmul_rn(pick_value(ring, pk[2], blk), static_cast<float>(q.z));
      x.w = __fmul_rn(pick_value(ring, pk[3], blk), static_cast<float>(q.w));
      *reinterpret_cast<float4*>(&s_tile[blk * kStride + j0]) = x;
      for (rem += kThreads / 16; rem >= s.blocks; rem -= s.blocks) ++image;
    }
    __syncthreads();

    float acc[8][8];
    ptpu::idct_micro_tile(s_tile, s_basis, tx, ty, acc);

    // range limit into the staging tile: block ty + 16*i's pixel rows tx >> 1 (columns
    // 4*tx..) and 4 + (tx >> 1) (columns 32 + 4*tx..), four bytes each
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int blk = ty + 16 * i;
      const int at = blk * 8 + (tx & 1) * 4;
      *reinterpret_cast<uint32_t*>(s_stage + (tx >> 1) * (kTileRows * 8) + at) =
          range_limit4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<uint32_t*>(s_stage + (4 + (tx >> 1)) * (kTileRows * 8) + at) =
          range_limit4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

    // the staging tile to the planes: a unit is one pixel row of two neighbouring blocks
    // (16 bytes) when a block row holds an even number of blocks (then images, tiles and
    // block rows all start at even blocks), else of one block (8 bytes). A thread keeps
    // one block (pair) and steps through its pixel rows, so it places the block once.
    const int bx = s.bx;
    const int row_bytes = bx * 8;
    const bool pairs = (bx & 1) == 0;
    const int blk = pairs ? (tid % (kTileRows / 2)) * 2 : tid;
    if (blk < nb) {
      const int gb = b0 + blk;
      const int im = gb / s.blocks;
      const int r = gb - im * s.blocks;
      const int by = r / bx;
      uint8_t* dst = s.out + static_cast<int64_t>(im) * s.blocks * 64 +
                     static_cast<int64_t>(by * 8) * row_bytes + (r - by * bx) * 8;
      const uint8_t* src = s_stage + blk * 8;
      if (pairs) {
        for (int p = tid / (kTileRows / 2); p < 8; p += kThreads / (kTileRows / 2)) {
          *reinterpret_cast<uint4*>(dst + p * row_bytes) =
              *reinterpret_cast<const uint4*>(src + p * (kTileRows * 8));
        }
      } else {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          *reinterpret_cast<uint2*>(dst + p * row_bytes) =
              *reinterpret_cast<const uint2*>(src + p * (kTileRows * 8));
        }
      }
    }
    // the next iteration's barrier (after its load is issued) orders these reads of the
    // staging tile and this iteration's reads of the float tile and the ring stage before
    // anything rewrites them
  }
}

// -- stage2_rgb ------------------------------------------------------------------------

constexpr int kRgbThreads = 256;              // eight warps, each on its own output rows
constexpr int kRgbWarps = kRgbThreads / 32;
constexpr int kRgbLane = 8;                  // output pixels a lane a step
constexpr int kRgbChunk = 32 * kRgbLane;      // output pixels a warp a step

// JFIF constants as the reference's float32 (a double rounded to float, as torch and
// jnp convert a Python float)
constexpr float kCrR = static_cast<float>(1.402);
constexpr float kCbG = static_cast<float>(0.344136);
constexpr float kCrG = static_cast<float>(0.714136);
constexpr float kCbB = static_cast<float>(1.772);

__device__ __forceinline__ uint32_t to_u8(float v) {
  return static_cast<uint32_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

__device__ __forceinline__ int byte_of(uint32_t word, int e) {
  return static_cast<int>((word >> (8 * e)) & 255u);
}

// Component c's samples at output pixels x .. x+7 of output row y (x % 8 == 0) after its
// upsample, exact in float32. Vertically the near row weighs 3 and the far row 1 at ratio
// 2 (else the near row alone); horizontally, at ratio 1 the eight columns come in one
// 8-byte load a row, at ratio 2 columns x/2 .. x/2 + 3 in one 4-byte load a row and their
// outer neighbours from the next lanes (a load at the warp's two ends), above 2 a nearest
// repeat. Lanes whose pixels lie past the row's end read clamped columns (their values
// are not stored) and still take part in the shuffles. Rows of a plane start 8-byte
// aligned (planes 16-byte aligned, widths a multiple of 8).
__device__ __forceinline__ void samples8(const RgbDesc& d, int c, uint32_t image, int y,
                                         int x, int lane, float (&out)[kRgbLane]) {
  const int rows = d.rows[c], cols = d.cols[c], ry = d.ry[c], rx = d.rx[c];
  const uint8_t* plane = d.plane[c] + static_cast<int64_t>(image) * rows * cols;
  const int i = ry == 1 ? y : (ry == 2 ? (y >> 1) : y / ry);
  const int far = ry != 2 ? i : ((y & 1) ? min(i + 1, rows - 1) : max(i - 1, 0));
  const uint8_t* rn = plane + static_cast<int64_t>(i) * cols;
  const uint8_t* rf = plane + static_cast<int64_t>(far) * cols;
  const int wn = ry == 2 ? 3 : 1, wf = ry == 2 ? 1 : 0;
  int num[kRgbLane];
  if (rx == 1) {
    const int xl = min(x, cols - 8);
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(rn + xl));
    const uint2 b = wf ? __ldg(reinterpret_cast<const uint2*>(rf + xl)) : make_uint2(0u, 0u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      num[e] = wn * byte_of(a.x, e) + wf * byte_of(b.x, e);
      num[4 + e] = wn * byte_of(a.y, e) + wf * byte_of(b.y, e);
    }
  } else if (rx == 2) {
    const int j = min(x >> 1, cols - 4);  // a multiple of 4
    const uint32_t a = __ldg(reinterpret_cast<const unsigned int*>(rn + j));
    const uint32_t b = wf ? __ldg(reinterpret_cast<const unsigned int*>(rf + j)) : 0u;
    int v[6];  // columns j - 1 .. j + 4
#pragma unroll
    for (int e = 0; e < 4; ++e) v[1 + e] = wn * byte_of(a, e) + wf * byte_of(b, e);
    v[0] = __shfl_up_sync(0xffffffffu, v[4], 1);
    v[5] = __shfl_down_sync(0xffffffffu, v[1], 1);
    if (lane == 0) {
      const int jm = max(j - 1, 0);
      v[0] = wn * __ldg(rn + jm) + wf * __ldg(rf + jm);
    }
    if (j + 4 > cols - 1) {
      v[5] = v[4];  // the edge clamps at the padded plane
    } else if (lane == 31) {
      v[5] = wn * __ldg(rn + j + 4) + wf * __ldg(rf + j + 4);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      num[2 * k] = 3 * v[1 + k] + v[k];
      num[2 * k + 1] = 3 * v[1 + k] + v[2 + k];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kRgbLane; ++e) {
      const int jj = min((x + e) / rx, cols - 1);
      num[e] = wn * __ldg(rn + jj) + wf * __ldg(rf + jj);
    }
  }
  const float scale = (ry == 2 ? 0.25f : 1.f) * (rx == 2 ? 0.25f : 1.f);
#pragma unroll
  for (int e = 0; e < kRgbLane; ++e) out[e] = static_cast<float>(num[e]) * scale;
}

// Each warp takes output rows in turn and walks a row in steps of 256 pixels, eight a
// lane: the components' samples (samples8), the colour, the 24 bytes into the warp's
// staging row in shared memory at the output's offset within 16 bytes, then the staging
// row out as 16-byte stores (byte stores at the step's two ragged ends).
__global__ void __launch_bounds__(kRgbThreads) stage2_rgb_kernel(const __grid_constant__ RgbDesc d) {
  __shared__ __align__(16) uint8_t s_out[kRgbWarps][3 * kRgbChunk + 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* stage = s_out[warp];
  const int h = d.height, w = d.width;
  const uint32_t rows_total = static_cast<uint32_t>(d.images) * h;
  for (uint32_t row = blockIdx.x * kRgbWarps + warp; row < rows_total;
       row += gridDim.x * kRgbWarps) {
    const uint32_t image = row / h;
    const int y = static_cast<int>(row - image * h);
    uint8_t* out_row = d.out + static_cast<int64_t>(row) * w * 3;
    for (int x0 = 0; x0 < w; x0 += kRgbChunk) {
      const int x = x0 + kRgbLane * lane;
      float yy[kRgbLane], cb[kRgbLane], cr[kRgbLane];
      samples8(d, 0, image, y, x, lane, yy);
      uint32_t c0[kRgbLane], c1[kRgbLane], c2[kRgbLane];
      if (d.ncomp == 1) {
#pragma unroll
        for (int e = 0; e < kRgbLane; ++e) {
          // the reference clamps and casts (no rounding); the plane holds integers
          c0[e] = static_cast<uint32_t>(fminf(fmaxf(yy[e], 0.f), 255.f));
          c1[e] = c0[e];
          c2[e] = c0[e];
        }
      } else {
        samples8(d, 1, image, y, x, lane, cb);
        samples8(d, 2, image, y, x, lane, cr);
#pragma unroll
        for (int e = 0; e < kRgbLane; ++e) {
          const float dcb = __fsub_rn(cb[e], 128.f);
          const float dcr = __fsub_rn(cr[e], 128.f);
          const uint32_t r = to_u8(__fmaf_rn(kCrR, dcr, yy[e]));
          const uint32_t g = to_u8(__fmaf_rn(-kCrG, dcr, __fmaf_rn(-kCbG, dcb, yy[e])));
          const uint32_t b = to_u8(__fmaf_rn(kCbB, dcb, yy[e]));
          c0[e] = d.bgr ? b : r;
          c1[e] = g;
          c2[e] = d.bgr ? r : b;
        }
      }
      const int npx = min(kRgbChunk, w - x0);
      uint8_t* dst = out_row + x0 * 3;
      const int off = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
#pragma unroll
      for (int e = 0; e < kRgbLane; ++e) {
        if (kRgbLane * lane + e < npx) {
          uint8_t* o = stage + off + 3 * (kRgbLane * lane + e);
          o[0] = static_cast<uint8_t>(c0[e]);
          o[1] = static_cast<uint8_t>(c1[e]);
          o[2] = static_cast<uint8_t>(c2[e]);
        }
      }
      __syncwarp();
      const int end = off + 3 * npx;
      uint8_t* base = dst - off;
      for (int k = lane; k < (end + 15) / 16; k += 32) {
        const int b0 = 16 * k;
        if (b0 >= off && b0 + 16 <= end) {
          *reinterpret_cast<uint4*>(base + b0) = *reinterpret_cast<const uint4*>(stage + b0);
        } else {
          for (int e = max(b0, off); e < min(b0 + 16, end); ++e) base[e] = stage[e];
        }
      }
      __syncwarp();  // the staging row is rewritten next step
    }
  }
}

int g_planes_blocks[kMaxDevices];  // persistent blocks of stage2_planes (0 = not set up)
int g_sm_count[kMaxDevices];

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int32_t round16(int64_t x) { return static_cast<int32_t>((x + 15) & ~static_cast<int64_t>(15)); }

}  // namespace

extern "C" {

// segs: nseg (1..4) descriptors in HOST memory (copied into the launch parameters); their
// pointers live on CUDA device `device`: slabs, tables, outputs and the (64, 64) float32
// basis 16-byte aligned. Launches ONE kernel on `stream`; returns the cudaError_t of the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for arguments it does not take.
int ptpu_stage2_planes(const PlaneSegmentDesc* segs, int nseg, const void* basis, int device,
                       void* stream) {
  if (nseg < 1 || nseg > kMaxSegments || device < 0 || device >= kMaxDevices ||
      !aligned16(basis)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanesParams prm = {};
  prm.count = nseg;
  int64_t tiles = 0;
  for (int i = 0; i < nseg; ++i) {
    const PlaneSegmentDesc& d = segs[i];
    const bool split_ok = d.kind != kSplit ||
                          (0 <= d.k1 && d.k1 <= d.k2 && d.k2 <= d.k && d.k1 % 2 == 0 &&
                           (d.k - d.k2) % 2 == 0);
    if (d.rows < 0 || d.rows > INT32_MAX || d.blocks < 1 || d.rows % d.blocks != 0 ||
        d.bx < 1 || d.blocks % d.bx != 0 || d.kind < kInt16 || d.kind > kSplit ||
        d.k < 2 || d.k > 64 || d.k % 2 != 0 || !split_ok ||
        (d.kind != kSplit && !d.zigzag && d.k != 64) || (d.kind == kSplit && !d.zigzag) ||
        !aligned16(d.qtab) || !aligned16(d.out)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Seg& s = prm.seg[i];
    s.src[0] = static_cast<const uint8_t*>(d.src0);
    s.src[1] = static_cast<const uint8_t*>(d.src1);
    s.src[2] = static_cast<const uint8_t*>(d.src2);
    s.qtab = d.qtab;
    s.out = d.out;
    s.rows = static_cast<int32_t>(d.rows);
    s.blocks = static_cast<int32_t>(d.blocks);
    s.bx = d.bx;
    s.kind = d.kind;
    s.k = d.k;
    s.k1 = d.kind == kSplit ? d.k1 : 0;
    s.k2 = d.kind == kSplit ? d.k2 : 0;
    s.zigzag = d.zigzag;
    if (d.kind == kInt16) {
      s.width[0] = 2 * d.k;
    } else if (d.kind == kPack12) {
      s.width[0] = d.k / 2 * 3;
    } else {
      s.width[0] = d.k1 / 2 * 3;
      s.width[1] = d.k2 - d.k1;
      s.width[2] = (d.k - d.k2) / 2;
    }
    s.region[0] = 0;
    s.region[1] = round16(static_cast<int64_t>(kTileRows) * s.width[0]);
    s.region[2] = s.region[1] + round16(static_cast<int64_t>(kTileRows) * s.width[1]);
    if (s.region[2] + round16(static_cast<int64_t>(kTileRows) * s.width[2]) + 16 > kRingBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int r = 0; r < 3; ++r) {
      if (s.width[r] > 0 && d.rows > 0 && !aligned16(s.src[r])) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    prm.first_tile[i] = static_cast<int32_t>(tiles);
    tiles += (d.rows + kTileRows - 1) / kTileRows;
  }
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = nseg; i <= kMaxSegments; ++i) prm.first_tile[i] = static_cast<int32_t>(tiles);
  if (tiles == 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_planes_blocks[device] == 0) {
    err = cudaFuncSetAttribute(stage2_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPlanesSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage2_planes_kernel, kThreads,
                                                        kPlanesSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_planes_blocks[device] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = static_cast<int>(tiles < g_planes_blocks[device] ? tiles : g_planes_blocks[device]);
  stage2_planes_kernel<<<blocks, kThreads, kPlanesSmem, static_cast<cudaStream_t>(stream)>>>(
      prm, static_cast<const float*>(basis));
  return static_cast<int>(cudaGetLastError());
}

// d in HOST memory (copied into the launch parameters); its pointers live on CUDA device
// `device`, `out` 16-byte aligned. Launches ONE kernel on `stream`; returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for arguments it does not take.
int ptpu_stage2_rgb(const RgbDesc* d, int device, void* stream) {
  if (device < 0 || device >= kMaxDevices || (d->ncomp != 1 && d->ncomp != 3) ||
      d->images < 0 || d->height < 1 || d->width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < d->ncomp; ++c) {
    if (d->ry[c] < 1 || d->rx[c] < 1 || d->rows[c] < 1 || d->cols[c] < 8 ||
        d->cols[c] % 8 != 0 || !aligned16(d->plane[c]) ||
        static_cast<int64_t>(d->rows[c]) * d->ry[c] < d->height ||
        static_cast<int64_t>(d->cols[c]) * d->rx[c] < d->width) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t rows_total = d->images * d->height;
  if (rows_total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_total == 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_sm_count[device] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sm_count[device] = count > 0 ? count : 1;
  }
  const int64_t want = (rows_total + kRgbWarps - 1) / kRgbWarps;
  const int64_t cap = static_cast<int64_t>(g_sm_count[device]) * 8;
  stage2_rgb_kernel<<<static_cast<int>(want < cap ? want : cap), kRgbThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
