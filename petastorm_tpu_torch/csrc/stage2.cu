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
//  Both kernels round and clamp with the saturating conversion to uint32 (round half to
//  even, negatives to 0) and a min with 255: clamp(rint(v), 0, 255).
//
// Bound on an H100 SXM at the main path's batch (256 images of 224x224 at 4:2:0, 301,056
// blocks): `stage2_planes` by operations, 2 * 301,056 * 64 * 64 = 2.47 GFLOP of float32
// FMAs dense (0.0368 ms at 67 TFLOP/s) against 32.5 MB of shipped bytes, tables and planes
// (0.0097 ms at 3.35 TB/s); the chain it runs skips the coefficient columns that are zero
// across a tile, ~25 % of them on the corpus. `stage2_rgb` by bytes, 19,267,584 in +
// 38,535,168 out (0.0172 ms).
//
// Design of `stage2_planes`: ONE launch for a group's components (up to four segments,
// passed by value). Persistent blocks, two an SM, each of two warpgroups that hand tiles of
// 128 blocks over through mbarriers (no block-wide barrier after the set-up):
//  - the producer (warpgroup 0): its warp 0 brings each tile's SHIPPED bytes (~43 a block
//    for the corpus's split, 128 for int16) into a three-stage ring in shared memory with
//    bulk asynchronous copies (cp.async.bulk, one a slab, completion on an mbarrier; the
//    ragged last 1-15 bytes of a slab by as many lanes: the slabs are the caller's
//    tensors, with nothing readable past their ends). Each producer thread unpacks and
//    dequantises its four natural positions of 16 blocks into registers with no branch
//    in the loop (the picks made once a segment, the quantisation rows of the one or two
//    images its blocks span loaded ahead, the product an exact FMA on the value's biased
//    bit pattern); the tile's 64-bit mask of positions non-zero in any block meets behind
//    the producer's named barrier; then the tile goes COMPACTED into the float-tile
//    buffer: the active columns in natural order, zero columns up to a multiple of 4, the list of
//    their basis rows, each block's output address. One buffer: the producer unpacks the
//    next tile into registers while the consumer's product runs, and writes it there once
//    the consumer has read the tile before; the SM's other block fills the gaps;
//  - the consumer (warpgroup 1): K1's 8x8 register micro-tile over the list's columns
//    only (the next step's list entry loaded ahead). A value's chain keeps its natural
//    order and skips only terms fmaf(0, b, acc) = acc, up to the sign of a zero that the
//    + 128 erases, so the planes stay bit-identical to the dense chain. Then the range
//    limit from registers straight to the planes as 4-byte stores (eight neighbouring
//    threads fill 32 bytes of one pixel row).
// No tensor cores: float32 wgmma and mma go through TF32, which would break the chain.
// Design of `stage2_rgb`: persistent blocks of 128 threads walk bands of output rows of
// one image (one MCU row: 8 * the largest vertical ratio rows, halved while the band's
// double-buffered shared memory exceeds 64 KB). Each plane's rows of the band, with the
// chroma's halo row above and below (clamped at the plane's edges), are contiguous, so
// each is ONE bulk asynchronous copy into shared memory (from its 16-byte-aligned
// floor), issued by a lane of warp 0 two bands ahead. Threads take eight output pixels
// of a row each (warp 0, which also issues the copies, the fewest): 8 Y samples in one
// 8-byte shared load, 4 chroma samples a row in one 4-byte load and their neighbours
// from the halo bytes, the colour with the component count fixed at compile time; the
// RGB goes to shared memory as 32-bit words (bytes where a row starts unaligned), and the
// band leaves as ONE bulk store (cp.async.bulk shared -> global) of its 16-byte-aligned
// interior, with byte stores at the two ends. One barrier a band. A band too wide for
// 200 KB even at one row takes the row route: one warp an output row, 16-byte stores from
// a staging row.

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

// -- shared-memory barriers and bulk asynchronous copies (sm_90) -------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (the bulk copies)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, the same rules
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// all but the newest N committed bulk stores have finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// orders this thread's shared-memory writes before later bulk copies read them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// rint(clamp(v, 0, 255)): the conversion rounds half to even and saturates below at 0
__device__ __forceinline__ uint32_t to_u8(float v) { return min(__float2uint_rn(v), 255u); }

// the low bytes of a, b, c, d as one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// -- stage2_planes -----------------------------------------------------------------------

constexpr int kMaxSegments = 4;
constexpr int kMaxDevices = 64;
constexpr int kTileRows = ptpu::kIdctTileRows;
constexpr int kStride = ptpu::kIdctStride;
constexpr int kGroup = 128;                 // threads a warpgroup
constexpr int kPlanesThreads = 2 * kGroup;  // the producer, then the consumer
constexpr int kPlanesBlocksPerSm = 2;
constexpr int kRingStages = 3;
constexpr int kProducerBarrier = 1;         // named barrier id of the producer warpgroup
// a ring stage: a tile's shipped bytes at most (int16 at k = 64: 128 bytes a block), with
// room for the 16-byte alignment of three slab regions and for the two-byte reads at a
// region's end
constexpr int kRingBytes = kTileRows * 128 + 64;

// shared memory of stage2_planes (byte offsets, every region 16-byte aligned): the basis;
// the float-tile buffer (the compacted tile, its list, the blocks' addresses, its column
// count); the mask slots and the barriers; the ring
constexpr int kSmBasis = 0;
constexpr int kBufTile = 0;
constexpr int kBufList = kBufTile + ptpu::kIdctTileFloats * 4;
constexpr int kBufDst = kBufList + 64 * 4;
constexpr int kBufMeta = kBufDst + kTileRows * 8;
constexpr int kBufBytes = kBufMeta + 16;
constexpr int kSmBuf = kSmBasis + ptpu::kIdctBasisFloats * 4;
constexpr int kSmTail = kSmBuf + kBufBytes;  // mask slots, then barriers (3 ring + 2 tile)
constexpr int kSmRing = kSmTail + 64 + 64;
constexpr int kPlanesSmem = kSmRing + kRingStages * kRingBytes;

static_assert(kBufBytes % 16 == 0 && kSmBuf % 16 == 0 && kRingBytes % 16 == 0,
              "stage2_planes' shared memory regions are misaligned");
static_assert(kPlanesBlocksPerSm * (kPlanesSmem + 1024) <= 228 * 1024,
              "two stage2_planes blocks must fit an SM's shared memory");

enum Kind { kInt16 = 0, kPack12 = 1, kSplit = 2 };

// natural position -> zigzag position (UNZIGZAG)
__constant__ uint8_t kNaturalToZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// n / d for 0 <= n < 2^32 by a multiply: m = floor((2^32 - 1) / d) undershoots by at most
// one, which the remainder corrects
struct FastDiv {
  uint32_t d, m;
};

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  uint32_t q = __umulhi(static_cast<uint32_t>(n), f.m);
  if (static_cast<uint32_t>(n) - q * f.d >= f.d) ++q;
  return static_cast<int>(q);
}

struct Seg {
  const uint8_t* src[3];
  const int32_t* qtab;
  uint8_t* out;
  int32_t rows, blocks, bx;
  FastDiv div_blocks, div_bx;
  int32_t width[3];   // bytes a block in each slab
  int32_t region[3];  // offset of each slab's bytes in a ring stage (16-byte aligned)
  int32_t kind, k, k1, k2, zigzag;
};

struct PlanesParams {
  Seg seg[kMaxSegments];
  int32_t first_tile[kMaxSegments + 1];  // tile index where each segment starts
  int32_t count;
};

struct TileMeta {
  int32_t nact4;      // compacted columns (a multiple of 4)
  int32_t row_bytes;  // the plane's bytes a pixel row
  int32_t pad[2];
};

struct PlanesBuf {
  float* tile;        // [kIdctTileFloats]: the compacted tile
  int32_t* list;      // [64]: basis offsets (row * 64) of the tile's columns
  uint8_t** dst;      // [kTileRows]: each block's first output byte, or null
  TileMeta* meta;
};

__device__ __forceinline__ PlanesBuf buffer(uint8_t* smem) {
  uint8_t* at = smem + kSmBuf;
  return {reinterpret_cast<float*>(at + kBufTile), reinterpret_cast<int32_t*>(at + kBufList),
          reinterpret_cast<uint8_t**>(at + kBufDst), reinterpret_cast<TileMeta*>(at + kBufMeta)};
}

struct PlanesSmem {
  uint8_t* base;
  float* basis;
  uint8_t* ring;      // [kRingStages][kRingBytes]
  uint32_t* mask;     // [2][4 warps][2 words]
  uint64_t* ring_full;  // [kRingStages], 32 arrivals (warp 0) + the copies' bytes
  uint64_t* full;       // 128 arrivals (the producer): the float tile is written
  uint64_t* empty;      // 128 arrivals (the consumer): the float tile is read
};

__device__ __forceinline__ PlanesSmem carve(uint8_t* smem) {
  PlanesSmem s;
  s.base = smem;
  s.basis = reinterpret_cast<float*>(smem + kSmBasis);
  s.mask = reinterpret_cast<uint32_t*>(smem + kSmTail);
  s.ring_full = reinterpret_cast<uint64_t*>(smem + kSmTail + 64);
  s.full = s.ring_full + kRingStages;
  s.empty = s.full + 1;
  s.ring = smem + kSmRing;
  return s;
}

// Where one shipped value sits in a block's bytes: the two bytes at `base` (its slab's
// region plus its offset) of block blk's `width` bytes hold it as a field; the value is
// (int32)(raw << lsh) >> rsh, the field sign-extended. Past k, width is 0: the pick reads
// two bytes of the ring and its table entry is taken as 0.
struct Pick {
  int32_t base, width, lsh, rsh;
};

__device__ __forceinline__ Pick make_pick(const Seg& s, int p) {
  Pick pk = {0, 0, 16, 16};
  if (p >= s.k) return pk;
  int r = 0, bits, off = 0, shift = 0;
  if (s.kind == kInt16) {
    off = 2 * p;
    bits = 16;
  } else if (s.kind == kPack12 || p < s.k1) {
    off = (p >> 1) * 3 + (p & 1);
    shift = (p & 1) * 4;
    bits = 12;
  } else if (p < s.k2) {
    r = 1;
    off = p - s.k1;
    bits = 8;
  } else {
    const int t = p - s.k2;
    r = 2;
    off = t >> 1;
    shift = (t & 1) * 4;
    bits = 4;
  }
  pk.base = s.region[r] + off;
  pk.width = s.width[r];
  pk.lsh = 32 - shift - bits;  // >= 16: the upper half of `raw` is shifted out
  pk.rsh = 32 - bits;
  return pk;
}

// The value as the float bit pattern of 1.5 * 2^23 + value (exact for |value| < 2^22):
// fmaf(that, q, -1.5 * 2^23 * q) is then the exact product value * q rounded once, as
// __fmul_rn(value, q) gives it, without a conversion instruction.
__device__ __forceinline__ float pick_biased(const uint8_t* ring, const Pick& pk, int blk) {
  const uint8_t* b = ring + pk.base + blk * pk.width;
  const uint32_t raw = __byte_perm(b[0], b[1], 0x0040);  // b[0] | b[1] << 8 in the low half
  return __int_as_float(0x4B400000 + (static_cast<int32_t>(raw << pk.lsh) >> pk.rsh));
}

// A tile's values of this thread (its four positions of blocks row0 + 8 * j) into x,
// dequantised, 0 for blocks past the segment; act[e] ORs the bits of position e's values
// (non-zero: active). The loop has no branch, so the loads of all 16 blocks are in flight
// together. kImages 1: the thread's blocks lie in one image, whose table row qa was
// loaded ahead; 2: in two, the second (qb) from tile block `bnd` on; 0: each block looks
// its image up (images under 121 blocks). kFull: all 128 blocks of the tile exist.
template <int kImages, bool kFull>
__device__ __forceinline__ void unpack_tile(const uint8_t* ring, const Seg& s, const Pick (&pk)[4],
                                            int j0, int row0, int b0, int nb,
                                            int4 qa, int4 qb, int bnd, float (&x)[16][4],
                                            uint32_t (&act)[4]) {
  constexpr float kBias = 12582912.f;  // 1.5 * 2^23
  const int ia[4] = {qa.x, qa.y, qa.z, qa.w};
  const int ib[4] = {qb.x, qb.y, qb.z, qb.w};
  // one image: its table and bias terms; two: both tables, the bias per value
  float fa[4], fb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    fa[e] = pk[e].width != 0 ? static_cast<float>(ia[e]) : 0.f;
    fb[e] = kImages == 1 ? __fmul_rn(-kBias, fa[e])  // exact: q < 2^16
                         : (pk[e].width != 0 ? static_cast<float>(ib[e]) : 0.f);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int blk = row0 + 8 * j;
    int iq[4];
    if (kImages == 0) {
      const int im = fast_div(min(b0 + blk, s.rows - 1), s.div_blocks);
      const int4 qi =
          __ldg(reinterpret_cast<const int4*>(s.qtab + static_cast<int64_t>(im) * 64 + j0));
      iq[0] = qi.x;
      iq[1] = qi.y;
      iq[2] = qi.z;
      iq[3] = qi.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float q, bq;
      if (kImages == 1) {
        q = fa[e];
        bq = fb[e];
      } else if (kImages == 2) {
        q = blk >= bnd ? fb[e] : fa[e];
        bq = __fmul_rn(-kBias, q);
      } else {
        q = pk[e].width != 0 ? static_cast<float>(iq[e]) : 0.f;
        bq = __fmul_rn(-kBias, q);
      }
      float v = __fmaf_rn(pick_biased(ring, pk[e], blk), q, bq);
      if (!kFull) v = blk < nb ? v : 0.f;
      x[j][e] = v;
      act[e] |= __float_as_uint(v) & 0x7fffffffu;  // -0 is not active
    }
  }
}

template <bool kFull>
__device__ __forceinline__ void unpack_tile_any(const uint8_t* ring, const Seg& s,
                                                const Pick (&pk)[4], int j0,
                                                int row0, int b0, int nb, int im_a, int im_b,
                                                int4 qa, int4 qb, int bnd, float (&x)[16][4],
                                                uint32_t (&act)[4]) {
  if (im_a == im_b) {
    unpack_tile<1, kFull>(ring, s, pk, j0, row0, b0, nb, qa, qb, bnd, x, act);
  } else if (im_b - im_a == 1) {
    unpack_tile<2, kFull>(ring, s, pk, j0, row0, b0, nb, qa, qb, bnd, x, act);
  } else {
    unpack_tile<0, kFull>(ring, s, pk, j0, row0, b0, nb, qa, qb, bnd, x, act);
  }
}

__device__ __forceinline__ int locate(const PlanesParams& prm, int tile) {
  int si = 0;
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < prm.count && tile >= prm.first_tile[i]) si = i;
  }
  return si;
}

// Warp 0 of the producer: one tile's shipped bytes into a ring stage. Each slab's bytes
// for the tile are one contiguous range starting 16-byte aligned (the tile's first block
// is a multiple of 128); its 16-byte multiple goes as one bulk copy, the last 1-15 bytes
// of a slab's ragged last tile as one byte a lane. Every lane then arrives on the stage's
// barrier (lane 0 with the copies' bytes), so the phase completes when both have landed.
__device__ __forceinline__ void issue_tile(const PlanesParams& prm, int tile, uint8_t* stage,
                                           uint64_t* bar, int lane) {
  const int si = locate(prm, tile);
  const Seg& s = prm.seg[si];
  const int b0 = (tile - prm.first_tile[si]) * kTileRows;
  const int nb = min(kTileRows, s.rows - b0);
  uint32_t bulk = 0;
  bool wrote = false;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int bytes = nb * s.width[r];
    const int tail = bytes & 15;
    if (lane < tail) {
      const int at = bytes - tail + lane;
      stage[s.region[r] + at] = s.src[r][static_cast<int64_t>(b0) * s.width[r] + at];
      wrote = true;
    }
    bulk += static_cast<uint32_t>(bytes - tail);
  }
  if (wrote) fence_async_shared();  // this lane's byte writes before any later copy there
  if (lane == 0) mbar_arrive_expect_tx(bar, bulk);
  __syncwarp();
  if (lane < 3) {  // lane r copies slab r's bytes
    const int main = (nb * s.width[lane]) & ~15;
    if (main > 0) {
      bulk_load(stage + s.region[lane], s.src[lane] + static_cast<int64_t>(b0) * s.width[lane],
                static_cast<uint32_t>(main), bar);
    }
  }
  if (lane != 0) mbar_arrive(bar);
}

__device__ void planes_producer(const PlanesParams& prm, const PlanesSmem& sm, int ptid) {
  const int warp = ptid >> 5, lane = ptid & 31;
  const int j0 = (ptid & 15) * 4;  // the four natural positions this thread unpacks
  const int row0 = ptid >> 4;      // its blocks: row0 + 8 * j, j = 0..15
  const int n_tiles = prm.first_tile[prm.count];
  Pick pk[4];
  int pk_seg = -1;  // the segment pk was made for
  if (warp == 0) {
    for (int q = 0; q < kRingStages; ++q) {
      const int t = blockIdx.x + q * gridDim.x;
      if (t < n_tiles) issue_tile(prm, t, sm.ring + q * kRingBytes, &sm.ring_full[q], lane);
    }
  }
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int stage = i % kRingStages;
    const int si = locate(prm, tile);
    const Seg& s = prm.seg[si];
    const int b0 = (tile - prm.first_tile[si]) * kTileRows;
    const int nb = min(kTileRows, s.rows - b0);
    const uint8_t* ring = sm.ring + stage * kRingBytes;
    if (si != pk_seg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pk[e] = make_pick(s, s.zigzag ? kNaturalToZigzag[j0 + e] : j0 + e);
      }
      pk_seg = si;
    }

    // unpack and dequantise this thread's 64 values into registers, and which of its
    // positions are non-zero in any of its blocks; the tables of the first and the last
    // of its blocks' images are loaded before the wait
    const int im_a = fast_div(min(b0 + row0, s.rows - 1), s.div_blocks);
    const int im_b = fast_div(min(b0 + row0 + 120, s.rows - 1), s.div_blocks);
    const int4 qa =
        __ldg(reinterpret_cast<const int4*>(s.qtab + static_cast<int64_t>(im_a) * 64 + j0));
    const int4 qb =
        __ldg(reinterpret_cast<const int4*>(s.qtab + static_cast<int64_t>(im_b) * 64 + j0));
    const int bnd = (im_a + 1) * s.blocks - b0;
    mbar_wait(&sm.ring_full[stage], (i / kRingStages) & 1);
    float x[16][4];
    uint32_t act[4] = {0u, 0u, 0u, 0u};
    if (nb == kTileRows) {
      unpack_tile_any<true>(ring, s, pk, j0, row0, b0, nb, im_a, im_b, qa, qb, bnd, x, act);
    } else {
      unpack_tile_any<false>(ring, s, pk, j0, row0, b0, nb, im_a, im_b, qa, qb, bnd, x,
                             act);
    }
    uint32_t bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) bits |= (act[e] != 0u ? 1u : 0u) << e;
    // the tile's 64-bit mask of active natural positions: lanes l and l + 16 share
    // positions; a warp's 16 groups of four make its two words; the four warps' words
    // meet behind the producer's barrier (two sets of slots, so the next tile's writes
    // cannot overtake a slow reader of this one)
    bits |= __shfl_xor_sync(0xffffffffu, bits, 16);
    const int g = lane & 15;
    const uint32_t lo = __reduce_or_sync(0xffffffffu, g < 8 ? bits << (4 * g) : 0u);
    const uint32_t hi = __reduce_or_sync(0xffffffffu, g >= 8 ? bits << (4 * (g - 8)) : 0u);
    uint32_t* slots = sm.mask + (i & 1) * 8;
    if (lane == 0) {
      slots[2 * warp] = lo;
      slots[2 * warp + 1] = hi;
    }
    named_barrier(kProducerBarrier, kGroup);  // every producer thread is done with the stage
    if (warp == 0) {
      const int next = tile + kRingStages * gridDim.x;
      if (next < n_tiles) {
        issue_tile(prm, next, sm.ring + stage * kRingBytes, &sm.ring_full[stage], lane);
      }
    }
    const uint32_t mlo = slots[0] | slots[2] | slots[4] | slots[6];
    const uint32_t mhi = slots[1] | slots[3] | slots[5] | slots[7];
    const int nact = __popc(mlo) + __popc(mhi);
    const int nact4 = (nact + 3) & ~3;
    // compacted column of each of this thread's positions, -1: inactive (its four lie in
    // one word of the mask, at bits b .. b + 3)
    const uint32_t word = j0 < 32 ? mlo : mhi;
    const int b = j0 & 31;
    const int below = (j0 < 32 ? 0 : __popc(mlo)) + __popc(word & ((1u << b) - 1u));
    const uint32_t mine = (word >> b) & 15u;
    int cidx[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cidx[e] = (mine >> e) & 1u ? below + __popc(mine & ((1u << e) - 1u)) : -1;
    }
    uint8_t* dst = nullptr;
    if (ptid < nb) {
      const int gb = b0 + ptid;
      const int im = fast_div(gb, s.div_blocks);
      const int r = gb - im * s.blocks;
      const int by = fast_div(r, s.div_bx);
      dst = s.out + static_cast<int64_t>(im) * s.blocks * 64 +
            static_cast<int64_t>(by) * 64 * s.bx + (r - by * s.bx) * 8;
    }

    // the float buffer is free once the consumer has read the tile before; then the
    // compacted tile (each active value at its column, the 16 blocks kStride * 8 floats
    // apart), the zero columns up to nact4, the list, the blocks' addresses
    const PlanesBuf bf = buffer(sm.base);
    mbar_wait(sm.empty, (i & 1) ^ 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (cidx[e] >= 0) {
        float* col = bf.tile + row0 * kStride + cidx[e];
#pragma unroll
        for (int j = 0; j < 16; ++j) col[8 * j * kStride] = x[j][e];
      }
    }
    for (int col = nact; col < nact4; ++col) bf.tile[ptid * kStride + col] = 0.f;
    if (ptid < 16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (cidx[e] >= 0) bf.list[cidx[e]] = (j0 + e) * 64;
      }
    } else if (ptid < 16 + nact4 - nact) {
      bf.list[nact + ptid - 16] = 0;  // zero columns: any basis row
    }
    bf.dst[ptid] = dst;
    if (ptid == 0) {
      bf.meta->nact4 = nact4;
      bf.meta->row_bytes = s.bx * 8;
    }
    mbar_arrive(sm.full);
  }
}

// K1's micro-tile (idct_tile.cuh) over the compacted columns: rows ty + 16*i, columns
// 4*tx + {0..3} and 32 + 4*tx + {0..3}; column k of the tile multiplies basis row list[k].
__device__ __forceinline__ void idct_compact_tile(const float* __restrict__ st,
                                                  const int32_t* __restrict__ list,
                                                  const float* __restrict__ s_basis, int nact4,
                                                  int tx, int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const float* a_row = st + ty * kStride;   // row ty; rows ty + 16*i at 16*i*kStride
  const float* b_col = s_basis + 4 * tx;    // columns 4*tx.., and 32 + 4*tx.. at +32
  int4 next = *reinterpret_cast<const int4*>(list);
#pragma unroll 1
  for (int k = 0; k < nact4; k += 4) {
    const int4 rows = next;
    next = *reinterpret_cast<const int4*>(list + k + 4);  // at k + 4 = 64: the next region
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = *reinterpret_cast<const float4*>(a_row + 16 * i * kStride + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = kk == 0 ? rows.x : kk == 1 ? rows.y : kk == 2 ? rows.z : rows.w;
      const float4 b0 = *reinterpret_cast<const float4*>(b_col + r);
      const float4 b1 = *reinterpret_cast<const float4*>(b_col + r + 32);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ai = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(ai, b0.x, acc[i][0]);
        acc[i][1] = fmaf(ai, b0.y, acc[i][1]);
        acc[i][2] = fmaf(ai, b0.z, acc[i][2]);
        acc[i][3] = fmaf(ai, b0.w, acc[i][3]);
        acc[i][4] = fmaf(ai, b1.x, acc[i][4]);
        acc[i][5] = fmaf(ai, b1.y, acc[i][5]);
        acc[i][6] = fmaf(ai, b1.z, acc[i][6]);
        acc[i][7] = fmaf(ai, b1.w, acc[i][7]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t range_limit4(float a, float b, float c, float d) {
  return pack4(to_u8(__fadd_rn(a, 128.f)), to_u8(__fadd_rn(b, 128.f)),
               to_u8(__fadd_rn(c, 128.f)), to_u8(__fadd_rn(d, 128.f)));
}

__device__ void planes_consumer(const PlanesParams& prm, const PlanesSmem& sm, int ct) {
  const int tx = ct & 7;   // micro-tile columns 4*tx .. 4*tx+3 and 32+4*tx .. 32+4*tx+3
  const int ty = ct >> 3;  // micro-tile rows ty + 16*i, i = 0..7
  // this block's tiles: blockIdx.x, + gridDim.x, ... below the total (counted up front, so
  // nothing of the walk stays live across the product)
  const int n_tiles = prm.first_tile[prm.count];
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);
  const PlanesBuf bf = buffer(sm.base);
  for (int i = 0; i < mine; ++i) {
    mbar_wait(sm.full, i & 1);
    float acc[8][8];
    idct_compact_tile(bf.tile, bf.list, sm.basis, bf.meta->nact4, tx, ty, acc);
    const int row_bytes = bf.meta->row_bytes;
    uint8_t* dst[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) dst[r] = bf.dst[ty + 16 * r];
    mbar_arrive(sm.empty);  // the float tile, list and addresses are read
    // block ty + 16*r: pixel rows tx >> 1 (columns 4*tx..) and 4 + (tx >> 1) (columns
    // 32 + 4*tx..), four bytes each, at column (tx & 1) * 4 of the block
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (dst[r] != nullptr) {
        uint8_t* p = dst[r] + (tx >> 1) * row_bytes + (tx & 1) * 4;
        *reinterpret_cast<uint32_t*>(p) = range_limit4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<uint32_t*>(p + 4 * row_bytes) =
            range_limit4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
}

__global__ void __launch_bounds__(kPlanesThreads, kPlanesBlocksPerSm)
stage2_planes_kernel(const __grid_constant__ PlanesParams prm, const float* __restrict__ basis) {
  extern __shared__ __align__(128) uint8_t smem[];
  const PlanesSmem sm = carve(smem);
  const int tid = threadIdx.x;
  for (int f = tid; f < ptpu::kIdctBasisFloats / 4; f += kPlanesThreads) {
    reinterpret_cast<float4*>(sm.basis)[f] = reinterpret_cast<const float4*>(basis)[f];
  }
  if (tid == 0) {
    for (int q = 0; q < kRingStages; ++q) mbar_init(&sm.ring_full[q], 32);
    mbar_init(sm.full, kGroup);
    mbar_init(sm.empty, kGroup);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < kGroup) {
    planes_producer(prm, sm, tid);
  } else {
    planes_consumer(prm, sm, tid - kGroup);
  }
}

// -- stage2_rgb ------------------------------------------------------------------------

constexpr int kBandThreads = 128;
constexpr int kBandSmemTarget = 64 * 1024;   // halve the band while it needs more
constexpr int kBandSmemMax = 200 * 1024;     // else the row route
constexpr int kRgbThreads = 256;              // row route: eight warps, each on its own rows
constexpr int kRgbWarps = kRgbThreads / 32;
constexpr int kRgbLane = 8;                  // output pixels a lane a step
constexpr int kRgbChunk = 32 * kRgbLane;      // output pixels a warp a step

// JFIF constants as the reference's float32 (a double rounded to float, as torch and
// jnp convert a Python float)
constexpr float kCrR = static_cast<float>(1.402);
constexpr float kCbG = static_cast<float>(0.344136);
constexpr float kCrG = static_cast<float>(0.714136);
constexpr float kCbB = static_cast<float>(1.772);

__device__ __forceinline__ int byte_of(uint32_t word, int e) {
  return static_cast<int>((word >> (8 * e)) & 255u);
}

// The eight pixels' colour channels, in the order they are stored (RGB, or BGR).
template <int NCOMP>
__device__ __forceinline__ void colour8(bool bgr, const float (&yy)[8], const float (&cb)[8],
                                              const float (&cr)[8], uint32_t (&c0)[8],
                                              uint32_t (&c1)[8], uint32_t (&c2)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (NCOMP == 1) {
      c0[e] = c1[e] = c2[e] = to_u8(yy[e]);  // the plane holds integers: the reference's cast
    } else {
      const float dcb = __fsub_rn(cb[e], 128.f);
      const float dcr = __fsub_rn(cr[e], 128.f);
      const uint32_t r = to_u8(__fmaf_rn(kCrR, dcr, yy[e]));
      const uint32_t g = to_u8(__fmaf_rn(-kCrG, dcr, __fmaf_rn(-kCbG, dcb, yy[e])));
      const uint32_t b = to_u8(__fmaf_rn(kCbB, dcb, yy[e]));
      c0[e] = bgr ? b : r;
      c1[e] = g;
      c2[e] = bgr ? r : b;
    }
  }
}

// The band route's parameters (computed on the host).
struct BandParams {
  RgbDesc d;
  int32_t band_rows;   // output rows a band
  int32_t bands;       // bands an image
  int32_t in_off[3];   // each component's region in an input buffer
  int32_t in_bytes;    // an input buffer (16-byte multiple)
  int32_t out_bytes;   // an output buffer (16-byte multiple)
};

// the plane rows [r0, r1] that output rows [y0, y1) read, halo included
__device__ __forceinline__ void band_plane_rows(const RgbDesc& d, int c, int y0, int y1,
                                                int& r0, int& r1) {
  const int ry = d.ry[c];
  if (ry == 1) {
    r0 = y0;
    r1 = y1 - 1;
  } else if (ry == 2) {
    r0 = max((y0 >> 1) - 1, 0);
    r1 = min(((y1 - 1) >> 1) + 1, d.rows[c] - 1);
  } else {
    r0 = y0 / ry;
    r1 = (y1 - 1) / ry;
  }
}

// Warp 0: the band's rows of every plane into an input buffer, lane c issuing plane c's as
// one bulk copy from its 16-byte-aligned floor (planes are 16-byte aligned and a multiple
// of 64 bytes an image, so the rounded range stays inside the plane). The data of
// component c starts at in + in_off[c] + (first byte & 15).
__device__ __forceinline__ void issue_band(const BandParams& bp, int item, uint8_t* in,
                                           uint64_t* bar, int lane) {
  const RgbDesc& d = bp.d;
  const int image = item / bp.bands;
  const int y0 = (item - image * bp.bands) * bp.band_rows;
  const int y1 = min(y0 + bp.band_rows, d.height);
  uintptr_t lo = 0, hi = 0;
  if (lane < d.ncomp) {
    int r0, r1;
    band_plane_rows(d, lane, y0, y1, r0, r1);
    const uintptr_t a = reinterpret_cast<uintptr_t>(d.plane[lane]) +
                        (static_cast<int64_t>(image) * d.rows[lane] + r0) * d.cols[lane];
    const uintptr_t b = a + static_cast<int64_t>(r1 - r0 + 1) * d.cols[lane];
    lo = a & ~static_cast<uintptr_t>(15);
    hi = (b + 15) & ~static_cast<uintptr_t>(15);
  }
  const uint32_t total = __reduce_add_sync(0xffffffffu, static_cast<uint32_t>(hi - lo));
  if (lane == 0) mbar_arrive_expect_tx(bar, total);
  __syncwarp();
  if (lane < d.ncomp) {
    bulk_load(in + bp.in_off[lane], reinterpret_cast<const void*>(lo),
              static_cast<uint32_t>(hi - lo), bar);
  }
}

// An integer 0 <= n < 2^23 times `scale` (a power of two) as float32, exactly: the bit
// pattern 2^23 + n, fused-multiplied by scale, less 2^23 * scale (no conversion pipe).
__device__ __forceinline__ float scaled(int n, float scale) {
  return __fmaf_rn(__int_as_float(0x4B000000 + n), scale, __fmul_rn(-8388608.f, scale));
}

// Component c's samples at output pixels x0 .. x0+7 of output row y (x0 % 8 == 0) after
// its upsample, from the band's rows in shared memory or, on the row route, the row's
// plane rows in device memory (`base`: plane row r0). Vertically
// the near row weighs 3 and the far row 1 at ratio 2 (else the near row alone);
// horizontally, at ratio 1 the eight columns in one 8-byte load a row, at ratio 2 columns
// x0/2 .. x0/2 + 3 in one 4-byte load a row and their outer neighbours as bytes (clamped
// at the padded plane), above 2 a nearest repeat. Rows in shared memory start 8-byte
// aligned (a plane row is a multiple of 8 bytes and its copy starts at 0 or 8 mod 16).
// RY, RX: the ratios when known at compile time (1 or 2), else 0 (read from d).
template <int RY, int RX>
__device__ __forceinline__ void band_samples8(const RgbDesc& d, int c, const uint8_t* base,
                                              int r0, int y, int x0, float (&out)[8]) {
  const int rows = d.rows[c], cols = d.cols[c];
  const int ry = RY ? RY : d.ry[c], rx = RX ? RX : d.rx[c];
  const int i = ry == 1 ? y : (ry == 2 ? (y >> 1) : y / ry);
  const int far = ry != 2 ? i : ((y & 1) ? min(i + 1, rows - 1) : max(i - 1, 0));
  const uint8_t* rn = base + (i - r0) * cols;
  const uint8_t* rf = base + (far - r0) * cols;
  const int wn = ry == 2 ? 3 : 1, wf = ry == 2 ? 1 : 0;
  int num[8];
  if (rx == 1) {
    const uint2 a = *reinterpret_cast<const uint2*>(rn + x0);
    const uint2 b = ry == 2 ? *reinterpret_cast<const uint2*>(rf + x0) : make_uint2(0u, 0u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      num[e] = wn * byte_of(a.x, e) + wf * byte_of(b.x, e);
      num[4 + e] = wn * byte_of(a.y, e) + wf * byte_of(b.y, e);
    }
  } else if (rx == 2) {
    const int j = x0 >> 1;  // a multiple of 4, and j + 4 <= cols
    const uint32_t a = *reinterpret_cast<const uint32_t*>(rn + j);
    const uint32_t b = ry == 2 ? *reinterpret_cast<const uint32_t*>(rf + j) : 0u;
    const int jl = max(j - 1, 0), jr = min(j + 4, cols - 1);
    int v[6];  // columns j - 1 .. j + 4
    v[0] = wn * rn[jl] + (ry == 2 ? rf[jl] : 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[1 + e] = wn * byte_of(a, e) + wf * byte_of(b, e);
    v[5] = wn * rn[jr] + (ry == 2 ? rf[jr] : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      num[2 * k] = 3 * v[1 + k] + v[k];
      num[2 * k + 1] = 3 * v[1 + k] + v[2 + k];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int jj = min((x0 + e) / rx, cols - 1);
      num[e] = wn * rn[jj] + wf * rf[jj];
    }
  }
  const float scale = (ry == 2 ? 0.25f : 1.f) * (rx == 2 ? 0.25f : 1.f);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = scaled(num[e], scale);
}

__device__ __forceinline__ void band_samples8_any(const RgbDesc& d, int c, const uint8_t* base,
                                                  int r0, int y, int x0, float (&out)[8]) {
  if (d.ry[c] == 1 && d.rx[c] == 1) {
    band_samples8<1, 1>(d, c, base, r0, y, x0, out);
  } else if (d.ry[c] == 2 && d.rx[c] == 2) {
    band_samples8<2, 2>(d, c, base, r0, y, x0, out);
  } else {
    band_samples8<0, 0>(d, c, base, r0, y, x0, out);
  }
}

// A thread's units of a band (eight output pixels of a row each, from `start` in `step`s):
// the components' samples, the colour, the 24 bytes into the band's RGB in shared memory
// as six words (bytes where the row leaves them unaligned or the row ends).
template <int NCOMP>
__device__ __forceinline__ void band_units(const RgbDesc& d, const uint8_t* const (&base)[3],
                                           const int (&r0)[3], int y0, int rows, int w,
                                           int units_per_row, int2 start, int2 step,
                                           uint8_t* ob) {
  int r = start.x, xu = start.y;
  while (r < rows) {
    const int x0 = xu * 8;
    const int y = y0 + r;
    float yy[8], cb[8] = {}, cr[8] = {};
    band_samples8_any(d, 0, base[0], r0[0], y, x0, yy);
    if (NCOMP == 3) {
      band_samples8_any(d, 1, base[1], r0[1], y, x0, cb);
      band_samples8_any(d, 2, base[2], r0[2], y, x0, cr);
    }
    uint32_t c0[8], c1[8], c2[8];
    colour8<NCOMP>(d.bgr != 0, yy, cb, cr, c0, c1, c2);
    uint8_t* p = ob + 3 * (r * w + x0);
    const int npx = min(8, w - x0);
    if (npx == 8 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      uint32_t* q = reinterpret_cast<uint32_t*>(p);
      q[0] = pack4(c0[0], c1[0], c2[0], c0[1]);
      q[1] = pack4(c1[1], c2[1], c0[2], c1[2]);
      q[2] = pack4(c2[2], c0[3], c1[3], c2[3]);
      q[3] = pack4(c0[4], c1[4], c2[4], c0[5]);
      q[4] = pack4(c1[5], c2[5], c0[6], c1[6]);
      q[5] = pack4(c2[6], c0[7], c1[7], c2[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < npx) {
          p[3 * e] = static_cast<uint8_t>(c0[e]);
          p[3 * e + 1] = static_cast<uint8_t>(c1[e]);
          p[3 * e + 2] = static_cast<uint8_t>(c2[e]);
        }
      }
    }
    r += step.x;
    xu += step.y;
    if (xu >= units_per_row) {
      xu -= units_per_row;
      ++r;
    }
  }
}

// Each block takes bands in turn (its k-th band in input and output buffer k & 1): the
// band's rows arrived two bands ahead; its threads take eight output pixels of a row
// each; the one barrier a band publishes the band's RGB (and, as thread 0 has waited for
// the previous band's bulk store to read its buffer, frees that buffer for the next
// band), then thread 0 issues the band's bulk store and the loads of the band two ahead.
__global__ void __launch_bounds__(kBandThreads)
stage2_rgb_band_kernel(const __grid_constant__ BandParams bp) {
  extern __shared__ __align__(128) uint8_t smem[];
  const RgbDesc& d = bp.d;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * (bp.in_bytes + bp.out_bytes));
  const int tid = threadIdx.x;
  const int h = d.height, w = d.width;
  const int items = static_cast<int>(d.images) * bp.bands;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid < 32) {
    for (int q = 0; q < 2; ++q) {
      const int item = blockIdx.x + q * gridDim.x;
      if (item < items) issue_band(bp, item, smem + q * bp.in_bytes, &full[q], tid);
    }
  }
  // this thread's first unit of a band (the last threads take a band's extra units, warp 0,
  // which issues the stores and the loads, the fewest) and its step, as (row, unit of row)
  const int units_per_row = (w + 7) >> 3;
  const int first = static_cast<int>(blockDim.x) - 1 - tid;
  const int2 start = make_int2(first / units_per_row, first % units_per_row);
  const int2 step = make_int2(static_cast<int>(blockDim.x) / units_per_row,
                              static_cast<int>(blockDim.x) % units_per_row);
  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int buf = k & 1;
    uint8_t* in = smem + buf * bp.in_bytes;
    uint8_t* out = smem + 2 * bp.in_bytes + buf * bp.out_bytes;
    const int image = item / bp.bands;
    const int y0 = (item - image * bp.bands) * bp.band_rows;
    const int y1 = min(y0 + bp.band_rows, h);
    uint8_t* g0 = d.out + (static_cast<int64_t>(image) * h + y0) * w * 3;
    const int nbytes = (y1 - y0) * w * 3;
    const int o = static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 15);
    const uint8_t* base[3] = {in, in, in};
    int r0[3] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < d.ncomp) {
        int r1;
        band_plane_rows(d, c, y0, y1, r0[c], r1);
        const uintptr_t a = reinterpret_cast<uintptr_t>(d.plane[c]) +
                            (static_cast<int64_t>(image) * d.rows[c] + r0[c]) * d.cols[c];
        base[c] = in + bp.in_off[c] + (a & 15);
      }
    }
    mbar_wait(&full[buf], (k >> 1) & 1);
    uint8_t* ob = out + o;  // output byte j of the band at ob + j
    if (d.ncomp == 1) {
      band_units<1>(d, base, r0, y0, y1 - y0, w, units_per_row, start, step, ob);
    } else {
      band_units<3>(d, base, r0, y0, y1 - y0, w, units_per_row, start, step, ob);
    }
    fence_async_shared();
    if (tid == 0) bulk_wait_read<0>();  // the previous band's store has read its buffer
    __syncthreads();  // the band's RGB is in shared memory; its input buffer is read
    // the 16-byte-aligned interior [head, body_end) as one bulk store, the ends as bytes
    const int head = min((16 - o) & 15, nbytes);
    const int body_end = head + ((nbytes - head) & ~15);
    if (tid == 0) {
      if (body_end > head) {
        bulk_store(g0 + head, ob + head, static_cast<uint32_t>(body_end - head));
      }
      bulk_commit();
    }
    if (tid < 32) {
      const int next = item + 2 * gridDim.x;
      if (next < items) issue_band(bp, next, in, &full[buf], tid);
    }
    if (tid < head) g0[tid] = ob[tid];
    if (tid < nbytes - body_end) g0[body_end + tid] = ob[body_end + tid];
  }
  if (tid == 0) bulk_wait_all();
}

// The row route, for bands too wide for shared memory. Each warp takes output rows in
// turn and walks a row in steps of 256 pixels, eight a lane: the components' samples
// (band_samples8 on the plane rows the output row reads, in device memory, where rows
// start 8-byte aligned; lanes past the row's end sample nothing), the colour, the 24 bytes
// into the warp's staging row in shared memory at the output's offset within 16 bytes,
// then the staging row out as 16-byte stores (byte stores at the step's two ragged ends).
__global__ void __launch_bounds__(kRgbThreads)
stage2_rgb_rows_kernel(const __grid_constant__ RgbDesc d) {
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
    const uint8_t* base[3] = {nullptr, nullptr, nullptr};
    int r0[3] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < d.ncomp) {
        int r1;
        band_plane_rows(d, c, y, y + 1, r0[c], r1);
        base[c] = d.plane[c] + (static_cast<int64_t>(image) * d.rows[c] + r0[c]) * d.cols[c];
      }
    }
    for (int x0 = 0; x0 < w; x0 += kRgbChunk) {
      const int x = x0 + kRgbLane * lane;
      float yy[kRgbLane] = {}, cb[kRgbLane] = {}, cr[kRgbLane] = {};
      if (x < w) {
        band_samples8_any(d, 0, base[0], r0[0], y, x, yy);
        if (d.ncomp == 3) {
          band_samples8_any(d, 1, base[1], r0[1], y, x, cb);
          band_samples8_any(d, 2, base[2], r0[2], y, x, cr);
        }
      }
      uint32_t c0[kRgbLane], c1[kRgbLane], c2[kRgbLane];
      if (d.ncomp == 1) {
        colour8<1>(false, yy, cb, cr, c0, c1, c2);
      } else {
        colour8<3>(d.bgr != 0, yy, cb, cr, c0, c1, c2);
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

bool g_planes_ready[kMaxDevices];  // stage2_planes' shared-memory limit is raised
int g_sm_count[kMaxDevices];
bool g_band_ready[kMaxDevices];    // the band kernel's shared-memory limit is raised
int g_band_smem[kMaxDevices];      // the last band launch's shared memory ...
int g_band_per_sm[kMaxDevices];    // ... and its resident blocks an SM

cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

cudaError_t sm_count(int device, int* count) {
  if (g_sm_count[device] == 0) {
    int n = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    g_sm_count[device] = n > 0 ? n : 1;
  }
  *count = g_sm_count[device];
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

FastDiv fast_divisor(int32_t d) {
  return {static_cast<uint32_t>(d), static_cast<uint32_t>(0xFFFFFFFFu / static_cast<uint32_t>(d))};
}

int32_t round16(int64_t x) { return static_cast<int32_t>((x + 15) & ~static_cast<int64_t>(15)); }

// the band route's shared memory for bands of `rows` output rows (0: too large), and
// each component's input region
int64_t band_smem(const RgbDesc& d, int rows, int32_t (&in_off)[3], int32_t* in_bytes,
                  int32_t* out_bytes) {
  int64_t in = 0;
  for (int c = 0; c < d.ncomp; ++c) {
    const int ry = d.ry[c];
    const int64_t need = ry == 1 ? rows : rows / ry + 3;
    const int64_t nr = need < d.rows[c] ? need : d.rows[c];
    in_off[c] = static_cast<int32_t>(in);
    in += round16(nr * d.cols[c] + 32);
  }
  const int64_t out = round16(static_cast<int64_t>(rows) * d.width * 3 + 32);
  if (in > INT32_MAX / 4 || out > INT32_MAX / 4) return INT64_MAX;
  *in_bytes = static_cast<int32_t>(in);
  *out_bytes = static_cast<int32_t>(out);
  return 2 * (in + out) + 16;
}

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
    s.div_blocks = fast_divisor(s.blocks);
    s.div_bx = fast_divisor(s.bx);
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
    const int32_t bytes = s.region[2] + round16(static_cast<int64_t>(kTileRows) * s.width[2]);
    if (bytes + 16 > kRingBytes) return static_cast<int>(cudaErrorInvalidValue);
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
  if (!g_planes_ready[device]) {
    err = cudaFuncSetAttribute(stage2_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPlanesSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_planes_ready[device] = true;
  }
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cap = static_cast<int64_t>(sms) * kPlanesBlocksPerSm;  // persistent blocks
  stage2_planes_kernel<<<static_cast<int>(tiles < cap ? tiles : cap), kPlanesThreads,
                         kPlanesSmem, static_cast<cudaStream_t>(stream)>>>(
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
  if (rows_total > INT32_MAX || !aligned16(d->out)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_total == 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the band route: one MCU row of output rows a band, halved while it needs more than
  // the target (so several blocks share an SM)
  BandParams bp = {};
  bp.d = *d;
  int ry_max = 1;
  for (int c = 0; c < d->ncomp; ++c) ry_max = d->ry[c] > ry_max ? d->ry[c] : ry_max;
  int rows = 8 * ry_max;
  int64_t smem = band_smem(*d, rows, bp.in_off, &bp.in_bytes, &bp.out_bytes);
  while (smem > kBandSmemTarget && rows > 1) {
    rows >>= 1;
    smem = band_smem(*d, rows, bp.in_off, &bp.in_bytes, &bp.out_bytes);
  }
  const int64_t items = d->images * ((d->height + rows - 1) / rows);
  if (smem <= kBandSmemMax && items <= INT32_MAX) {
    bp.band_rows = rows;
    bp.bands = (d->height + rows - 1) / rows;
    if (!g_band_ready[device]) {
      err = cudaFuncSetAttribute(stage2_rgb_band_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBandSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      g_band_ready[device] = true;
    }
    if (g_band_smem[device] != smem) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage2_rgb_band_kernel,
                                                          kBandThreads, static_cast<size_t>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      g_band_smem[device] = static_cast<int>(smem);
      g_band_per_sm[device] = per_sm > 0 ? per_sm : 1;
    }
    const int64_t cap = static_cast<int64_t>(sms) * g_band_per_sm[device];
    stage2_rgb_band_kernel<<<static_cast<int>(items < cap ? items : cap), kBandThreads,
                             static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(bp);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t want = (rows_total + kRgbWarps - 1) / kRgbWarps;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  stage2_rgb_rows_kernel<<<static_cast<int>(want < cap ? want : cap), kRgbThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(*d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
