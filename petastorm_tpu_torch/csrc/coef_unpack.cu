// The stage-2 unpack of the JPEG path's narrowed coefficient transfer, for Hopper (sm_90a):
// a layout group's shipped coefficient slabs -> dequantised float32 blocks in natural
// order, K1's input.
//
// Replaces the unpack and dequantisation that the JAX package writes as plain jnp inside
// its stage-2 program (petastorm_tpu/ops/jpeg.py:552-602, `unpack12`, `unpack4` and the
// pad / unzigzag / `coef * qtab` of `_batched_stage2`), which XLA fuses into one pass; in
// eager PyTorch the same code would be 10-25 launches a component. Not a Pallas kernel:
// it is the fused pass XLA made, written by hand.
//
// What it computes, per component (segment) and block b of image i = b / blocks:
//     out[b, j] = float(coef(b, j)) * float(qtab[i, j])   (j natural order, 0..63)
// where coef(b, j) reads the value at p = (zigzag ? natural_to_zigzag[j] : j) from the
// shipped row, 0 when p >= k:
//   kind 0 (int16):  int16 row of k values (natural order when k == 64, else the zigzag
//                    prefix);
//   kind 1 (pack12): the 12-bit pack of that row, two values in 3 bytes
//                    (lo = b0 | (b1 & 0xF) << 8, hi = b1 >> 4 | b2 << 4, two's complement);
//   kind 2 (split):  zigzag order always, a 12-bit head [0, k1), an int8 mid [k1, k2) and
//                    a 4-bit tail [k2, k) (two's complement nibbles, low nibble first).
// The product is one float32 multiply, rounded to nearest (__fmul_rn), as the reference's.
//
// Bound on an H100 SXM: memory. It reads the shipped bytes and the tables once and writes
// 256 bytes a block: at the main path's batch (301,056 blocks) 77,070,336 bytes out, so
// ~0.0345 ms for full int16 at 3.35 TB/s and less when narrowed.
//
// Design (a simple first form): ONE launch for every component of a group (the segment
// list works like K1's). A grid-stride loop over quads, four consecutive natural
// positions of one block: each thread gathers its four values from the block's shipped
// row (a few dozen bytes that the warp's neighbours read too, so L1 serves them; one
// 8-byte load for an int16 row in natural order), multiplies by four table entries, and
// writes one 16-byte store; a warp writes 512 contiguous bytes. Folding this into K1's
// tile load is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 4;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

enum Kind { kInt16 = 0, kPack12 = 1, kSplit = 2 };

// natural position -> zigzag position (UNZIGZAG)
__constant__ uint8_t kNaturalToZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

}  // namespace

extern "C" {

// One component's shipped coefficients (the layout of ctypes' CoefSegmentDesc in
// ops/kernels.py).
struct CoefSegmentDesc {
  const void* src0;      // int16 row, the 12-bit pack, or the split's head
  const void* src1;      // split: the int8 mid
  const void* src2;      // split: the 4-bit tail
  const int32_t* qtab;   // (images, 64) natural order
  float* out;            // (rows, 64)
  int64_t rows;          // images * blocks
  int64_t blocks;        // blocks an image
  int32_t kind;
  int32_t k;             // positions shipped a block (even, 2..64)
  int32_t k1, k2;        // split points (kind 2)
  int32_t zigzag;        // rows in zigzag order (k < 64, or kind 2)
  int32_t pad;
};

}  // extern "C"

namespace {

struct Params {
  CoefSegmentDesc seg[kMaxSegments];
  int64_t start[kMaxSegments + 1];  // first quad of each segment
  int nseg;
};

__device__ __forceinline__ int32_t sext12(int32_t v) { return v - ((v & 0x800) << 1); }

// Value at 12-bit pair position p of a packed row.
__device__ __forceinline__ int32_t read12(const uint8_t* row, int p) {
  const uint8_t* t = row + (p >> 1) * 3;
  const int32_t b1 = t[1];
  return (p & 1) ? sext12((b1 >> 4) | (static_cast<int32_t>(t[2]) << 4))
                 : sext12(static_cast<int32_t>(t[0]) | ((b1 & 0xF) << 8));
}

__device__ __forceinline__ int32_t fetch(const CoefSegmentDesc& s, int64_t b, int p) {
  if (p >= s.k) return 0;
  if (s.kind == kInt16) {
    return static_cast<const int16_t*>(s.src0)[b * s.k + p];
  }
  if (s.kind == kPack12) {
    return read12(static_cast<const uint8_t*>(s.src0) + b * (s.k / 2 * 3), p);
  }
  if (p < s.k1) {
    return read12(static_cast<const uint8_t*>(s.src0) + b * (s.k1 / 2 * 3), p);
  }
  if (p < s.k2) {
    return static_cast<const int8_t*>(s.src1)[b * (s.k2 - s.k1) + (p - s.k1)];
  }
  const int t = p - s.k2;
  const uint8_t byte =
      static_cast<const uint8_t*>(s.src2)[b * ((s.k - s.k2) / 2) + (t >> 1)];
  const int32_t nib = (t & 1) ? (byte >> 4) & 0xF : byte & 0xF;
  return nib - ((nib & 0x8) << 1);
}

__global__ void __launch_bounds__(kThreads) coef_unpack_kernel(Params prm) {
  const int64_t total = prm.start[prm.nseg];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; u < total;
       u += stride) {
    int si = 0;
#pragma unroll
    for (int t = 1; t < kMaxSegments; ++t) {
      if (t < prm.nseg && u >= prm.start[t]) si = t;
    }
    const CoefSegmentDesc& s = prm.seg[si];
    const int64_t local = u - prm.start[si];
    const int64_t b = local >> 4;       // block
    const int j0 = static_cast<int>(local & 15) * 4;  // first natural position
    int32_t v[4];
    if (s.kind == kInt16 && !s.zigzag) {
      // natural order, k == 64: one 8-byte load when the row start allows it
      const int16_t* row = static_cast<const int16_t*>(s.src0) + b * 64 + j0;
      if ((reinterpret_cast<uintptr_t>(row) & 7) == 0) {
        const int2 w = *reinterpret_cast<const int2*>(row);
        v[0] = static_cast<int16_t>(w.x & 0xFFFF);
        v[1] = static_cast<int16_t>((static_cast<uint32_t>(w.x) >> 16) & 0xFFFF);
        v[2] = static_cast<int16_t>(w.y & 0xFFFF);
        v[3] = static_cast<int16_t>((static_cast<uint32_t>(w.y) >> 16) & 0xFFFF);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = row[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        v[e] = fetch(s, b, s.zigzag ? kNaturalToZigzag[j] : j);
      }
    }
    const int32_t* q = s.qtab + (b / s.blocks) * 64 + j0;
    float4 o;
    o.x = __fmul_rn(static_cast<float>(v[0]), static_cast<float>(q[0]));
    o.y = __fmul_rn(static_cast<float>(v[1]), static_cast<float>(q[1]));
    o.z = __fmul_rn(static_cast<float>(v[2]), static_cast<float>(q[2]));
    o.w = __fmul_rn(static_cast<float>(v[3]), static_cast<float>(q[3]));
    *reinterpret_cast<float4*>(s.out + b * 64 + j0) = o;
  }
}

int g_sm_count[kMaxDevices];

}  // namespace

extern "C" {

// segs: nseg (1..4) segment descriptors in HOST memory (copied into the launch
// parameters); their pointers live on CUDA device `device`, every `out` 16-byte aligned.
// Launches on `stream`; returns the cudaError_t of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments it does not take.
int ptpu_coef_unpack_segments(const CoefSegmentDesc* segs, int nseg, int device,
                              void* stream) {
  if (nseg < 1 || nseg > kMaxSegments || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm = {};
  prm.nseg = nseg;
  prm.start[0] = 0;
  for (int i = 0; i < nseg; ++i) {
    const CoefSegmentDesc& s = segs[i];
    const bool split_ok = s.kind != kSplit ||
                          (0 <= s.k1 && s.k1 <= s.k2 && s.k2 <= s.k && s.k1 % 2 == 0 &&
                           (s.k - s.k2) % 2 == 0);
    if (s.rows < 0 || s.blocks < 1 || s.rows % s.blocks != 0 || s.kind < kInt16 ||
        s.kind > kSplit || s.k < 2 || s.k > 64 || s.k % 2 != 0 || !split_ok ||
        (s.kind != kSplit && !s.zigzag && s.k != 64) ||
        (reinterpret_cast<uintptr_t>(s.out) & 15) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    prm.seg[i] = s;
    prm.start[i + 1] = prm.start[i] + s.rows * 16;
  }
  for (int i = nseg + 1; i <= kMaxSegments; ++i) prm.start[i] = prm.start[nseg];
  const int64_t total = prm.start[nseg];
  if (total == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_sm_count[device] == 0) {
    int count = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    g_sm_count[device] = count > 0 ? count : 1;
  }
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(g_sm_count[device]) * 16;
  coef_unpack_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
