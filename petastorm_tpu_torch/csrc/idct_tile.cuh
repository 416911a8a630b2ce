// The 8x8 inverse DCT's tile product, shared by K1 (idct.cu) and the batched stage 2's
// `stage2_planes` kernel (stage2.cu), so that the chain the tests hold exact exists once.
//
// A tile is kIdctTileRows (128) rows of 64 dequantised coefficients in shared memory at a
// padded row stride of kIdctStride floats; the basis is the (64, 64) float32 separable
// 2-D IDCT basis kron(A, A) in shared memory. 128 threads each compute an 8x8 register
// micro-tile: rows ty + 16*i (i = 0..7) and columns 4*tx + {0..3} and 32 + 4*tx + {0..3},
// tx = tid & 7, ty = tid >> 3. Every value is a 64-term fmaf chain in natural k order
// starting from 0 (no TF32, no wgmma, whose float32 path is TF32): the value a float32
// matmul with k-ordered accumulation gives. The caller adds the level shift with
// __fadd_rn(acc, 128.f), so nvcc contracts nothing.

#pragma once

namespace ptpu {

constexpr int kIdctTileRows = 128;
constexpr int kIdctThreads = 128;
constexpr int kIdctStride = 68;  // padded row stride (floats) of a coefficient tile
constexpr int kIdctBasisFloats = 64 * 64;
constexpr int kIdctTileFloats = kIdctTileRows * kIdctStride;

__device__ __forceinline__ void idct_micro_tile(const float* __restrict__ st,
                                                const float* __restrict__ s_basis, int tx,
                                                int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < 64; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = *reinterpret_cast<const float4*>(&st[(ty + 16 * i) * kIdctStride + k]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(&s_basis[(k + kk) * 64 + 4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s_basis[(k + kk) * 64 + 32 + 4 * tx]);
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

}  // namespace ptpu
