// K1 — inverse DCT of dequantised JPEG coefficient rows, for Hopper (sm_90a).
//
// Replaces the Pallas kernel petastorm_tpu/ops/jpeg.py:311 `_idct_kernel`, launched at
// jpeg.py:498 inside `_idct_scaled` (jpeg.py:486): out = scaled @ basis + 128, where
// `scaled` is (N, 64) float32 (dequantised coefficients, one 8x8 block per row) and
// `basis` is the (64, 64) float32 separable 2-D IDCT basis kron(A, A) (jpeg.py:301).
//
// Bound on an H100 SXM: memory, with the float32 FMA rate close behind. A row is read
// once and written once (512 B) for 64 * 64 * 2 = 8192 flops, 16 flop/B, below the
// float32 (non tensor core) ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/B. At the main
// path's batch of 256 224x224 4:2:0 images (N = 200,704 Y + 2 x 50,176 chroma rows) the
// bytes give ~46 us and the FMAs ~37 us, so both have to run side by side.
//
// Design: ONE launch a batch, over up to kMaxSegments (input, output, rows) segments
// (the batch's colour components), passed by value.
//  - persistent blocks (as many as fit the SMs, two per SM) walk the segments' 128-row
//    tiles in grid-stride order; the 16 KB basis enters shared memory once per block;
//  - a two-stage ring of coefficient tiles in shared memory is filled with cp.async, so
//    the next tile's bytes are in flight while this one computes;
//  - each of the 128 threads computes an 8x8 register micro-tile: rows ty + 16*i,
//    columns 4*tx + {0..3} and 32 + 4*tx + {0..3}, 16 shared loads per 256 FMAs, the
//    k loop fully unrolled (168 registers; two blocks an SM);
//  - every output value is a 64-term fmaf chain in k order starting from 0, then +128
//    with __fadd_rn, so nvcc contracts nothing: the value a float32 matmul with k-ordered
//    accumulation gives, with no TF32 (and no wgmma, whose float32 path is TF32). The
//    micro-tile lives in idct_tile.cuh, shared with stage2.cu's `stage2_planes`;
//  - results leave as 16-byte stores, eight neighbouring threads on one 128-byte row.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct_tile.cuh"

namespace {

constexpr int kMaxSegments = 4;
constexpr int kTileRows = ptpu::kIdctTileRows;
constexpr int kThreads = ptpu::kIdctThreads;
constexpr int kStride = ptpu::kIdctStride;
constexpr int kStages = 2;
constexpr int kBasisFloats = ptpu::kIdctBasisFloats;
constexpr int kTileFloats = ptpu::kIdctTileFloats;
constexpr int kIdctSmem = (kBasisFloats + kStages * kTileFloats) * static_cast<int>(sizeof(float));

struct Segments {
  const float* in[kMaxSegments];
  float* out[kMaxSegments];
  int64_t rows[kMaxSegments];
  int64_t first_tile[kMaxSegments + 1];  // tile index where each segment starts
  int count;
};

struct TileRef {
  const float* in;
  float* out;
  int64_t row0;
  int64_t rows;
};

// the segment that holds `tile` (constant indices only, so the table stays in the
// kernel's parameter space)
__device__ __forceinline__ TileRef locate(const Segments& segs, int64_t tile) {
  TileRef t = {segs.in[0], segs.out[0], tile * kTileRows, segs.rows[0]};
#pragma unroll
  for (int i = 1; i < kMaxSegments; ++i) {
    if (i < segs.count && tile >= segs.first_tile[i]) {
      t = {segs.in[i], segs.out[i], (tile - segs.first_tile[i]) * kTileRows, segs.rows[i]};
    }
  }
  return t;
}

// one tile's rows into a ring stage: 16-byte cp.async copies, rows past the segment
// left as they are (their results are never stored)
__device__ __forceinline__ void load_tile(const TileRef& t, float* stage) {
  for (int f = threadIdx.x; f < kTileRows * 16; f += kThreads) {
    const int r = f >> 4;
    const int c4 = f & 15;
    if (t.row0 + r < t.rows) {
      __pipeline_memcpy_async(stage + r * kStride + c4 * 4, t.in + (t.row0 + r) * 64 + c4 * 4,
                              16);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
idct_segments_kernel(const Segments segs, const float* __restrict__ basis) {
  extern __shared__ __align__(16) float smem[];
  float* s_basis = smem;
  float* s_tiles = smem + kBasisFloats;

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // columns 4*tx .. 4*tx+3 and 32+4*tx .. 32+4*tx+3
  const int ty = tid >> 3;  // rows ty + 16*i, i = 0..7

  for (int f = tid; f < kBasisFloats / 4; f += kThreads) {
    reinterpret_cast<float4*>(s_basis)[f] = reinterpret_cast<const float4*>(basis)[f];
  }

  const int64_t n_tiles = segs.first_tile[segs.count];
  int64_t tile = blockIdx.x;
  if (tile < n_tiles) load_tile(locate(segs, tile), s_tiles);
  __pipeline_commit();
  for (int stage = 0; tile < n_tiles; tile += gridDim.x, stage ^= 1) {
    const int64_t next = tile + gridDim.x;
    // the other stage was last read in the previous iteration, before its closing barrier
    if (next < n_tiles) load_tile(locate(segs, next), s_tiles + (stage ^ 1) * kTileFloats);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of `tile` have landed
    __syncthreads();           // everyone's have (and the basis is in place)

    float acc[8][8];
    ptpu::idct_micro_tile(s_tiles + stage * kTileFloats, s_basis, tx, ty, acc);

    const TileRef t = locate(segs, tile);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = t.row0 + ty + 16 * i;
      if (row < t.rows) {
        float4 lo, hi;
        lo.x = __fadd_rn(acc[i][0], 128.f);
        lo.y = __fadd_rn(acc[i][1], 128.f);
        lo.z = __fadd_rn(acc[i][2], 128.f);
        lo.w = __fadd_rn(acc[i][3], 128.f);
        hi.x = __fadd_rn(acc[i][4], 128.f);
        hi.y = __fadd_rn(acc[i][5], 128.f);
        hi.z = __fadd_rn(acc[i][6], 128.f);
        hi.w = __fadd_rn(acc[i][7], 128.f);
        float4* dst = reinterpret_cast<float4*>(t.out + row * 64);
        dst[tx] = lo;
        dst[8 + tx] = hi;
      }
    }
    __syncthreads();  // this stage's reads are done before the next load refills it
  }
}

}  // namespace

extern "C" {

// `count` (<= 4) segments: ins[s] (rows[s], 64) float32 and outs[s] (rows[s], 64)
// float32, contiguous and 16-byte aligned; basis (64, 64) float32; all on CUDA device
// `device`. ONE launch on `stream` (a stream of that device) computes every segment;
// returns the cudaError_t of the launch (0 = cudaSuccess).
int ptpu_idct_segments_f32(const void* const* ins, void* const* outs, const int64_t* rows,
                           int count, const void* basis, int device, void* stream) {
  if (count < 1 || count > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  Segments segs = {};
  segs.count = count;
  segs.first_tile[0] = 0;
  for (int s = 0; s < count; ++s) {
    if (rows[s] < 0) return static_cast<int>(cudaErrorInvalidValue);
    segs.in[s] = static_cast<const float*>(ins[s]);
    segs.out[s] = static_cast<float*>(outs[s]);
    segs.rows[s] = rows[s];
    segs.first_tile[s + 1] = segs.first_tile[s] + (rows[s] + kTileRows - 1) / kTileRows;
  }
  const int64_t n_tiles = segs.first_tile[count];
  if (n_tiles == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(idct_segments_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kIdctSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_segments_kernel, kThreads,
                                                      kIdctSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t max_blocks = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(n_tiles < max_blocks ? n_tiles : max_blocks);
  idct_segments_kernel<<<blocks, kThreads, kIdctSmem, static_cast<cudaStream_t>(stream)>>>(
      segs, static_cast<const float*>(basis));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
