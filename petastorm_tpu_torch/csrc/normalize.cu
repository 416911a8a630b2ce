// K2 — per-channel image normalisation, uint8 -> bfloat16, float16 or float32, with the train-time
// horizontal flip in the same pass, for Hopper (sm_90a).
//
// Replaces the Pallas kernel petastorm_tpu/ops/image.py:24 `_normalize_kernel`, launched
// at image.py:54 in `normalize_images` (image.py:31), and the flip and select of
// `normalize_and_augment` (image.py:69-77):
//     out = (x * (1/255) - mean[c]) * inv_std[c],  inv_std = 1/std in float32,
// with c the channel of each element of an NHWC batch; an image whose `flips` byte is set
// lands mirrored along W (pixel w of a row at W-1-w).
//
// Bound on an H100 SXM: memory. Each element moves 1 byte in and 2 (bf16) or 4 (f32)
// bytes out for 3 flops. At the main path's batch (256 x 224 x 224 x 3 uint8 -> bf16,
// 115.6 MB) the bytes give ~34.5 us; the flip adds no byte.
//
// The old design (one 16-byte load a thread in a grid-stride loop, a 64-bit `%` and 32
// indexed shared-memory loads a chunk) reached ~0.5 of that bound. The bulk route (the
// main path's) is built for the bytes instead: persistent blocks (as many an SM as the
// shared memory allows: one at 224 x 224 x 3) walk tiles of whole image rows (at most
// rows_per_tile rows of W*C bytes, W*C a multiple of 16) in turn. The tiles are a
// multiple of the grid in number and within one row of each other in size, so every
// block does the same work.
// - Bytes in flight. One thread issues each tile's load as ONE cp.async.bulk (TMA) copy
//   into a ring of kStages shared-memory stages, completed on an mbarrier with
//   complete_tx accounting, kStages - 1 tiles ahead of the tile being converted: the
//   ring, not the registers or the occupancy, sets how many bytes are in flight.
// - Instructions per byte. A tile holds whole rows, so it starts at channel 0. For
//   C in {1, 3, 4} (template cases) a thread converts a chunk of lcm(16, C) bytes, whole
//   pixels, so each element's channel is known at compile time and mean / inv_std are
//   kernel-parameter constants: no `%`, no indexed shared-memory load. Other C up to 16
//   take 16-byte chunks with a per-chunk channel phase and a shared-memory table.
// - Stores. Threads write the converted tile into one of kOutTiles shared output tiles;
//   one thread sends it out as ONE cp.async.bulk store (bulk_group), and waits for its
//   `.read` only before that buffer is written again, two tiles later.
// - The flip. A flipped image's chunk goes to the mirrored chunk of its row, its pixels
//   in reverse order (a compile-time permutation of registers), so the tile's store
//   stays one contiguous copy and the flip moves no extra byte.
// Batches the bulk route cannot take keep hand-written routes, both with the flip: the
// 16-byte-vector grid-stride kernel (pointers 16-byte aligned, W*C not a multiple of 16,
// or a tile too large for shared memory) and the one-element kernel (unaligned
// pointers). The host side caches the SM count, the occupancy and the shared-memory
// opt-in, and sets the device only when it is not the current one.
//
// Every route rounds as the reference does: __fmul_rn / __fsub_rn (never contracted into
// an FMA), then __float2bfloat16_rn or __float2half_rn (round to nearest even, as torch's
// .to(bfloat16) and .to(float16)). float16 is a store type of every route, beside bfloat16
// and float32: its plain version is the same formula cast to float16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kThreads = 256;
constexpr int kStages = 4;          // input ring depth of the bulk route
constexpr int kOutTiles = 3;        // output tiles of the bulk route
constexpr int kMaxDevices = 64;

enum Route { kBulk = 0, kVector = 1, kScalar = 2 };

struct ChannelParams {
  float mean[kMaxChannels];
  float inv_std[kMaxChannels];
};

__device__ __forceinline__ float normalize_one(uint32_t x, float mean, float inv_std) {
  const float scaled = __fmul_rn(static_cast<float>(x), 1.0f / 255.0f);
  return __fmul_rn(__fsub_rn(scaled, mean), inv_std);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&words)[4], int e) {
  return (words[e >> 2] >> (8 * (e & 3))) & 0xFFu;
}

template <typename Out>
__device__ __forceinline__ void store_one(Out* out, int64_t i, float v);

template <>
__device__ __forceinline__ void store_one<float>(float* out, int64_t i, float v) {
  out[i] = v;
}

template <>
__device__ __forceinline__ void store_one<__nv_bfloat16>(__nv_bfloat16* out, int64_t i,
                                                          float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <>
__device__ __forceinline__ void store_one<__half>(__half* out, int64_t i, float v) {
  out[i] = __float2half_rn(v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(lo))) |
         (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(hi))) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Writes kN values to dst (16-byte aligned) with 16-byte stores. Value j of the output is
// v[src(j)], where src mirrors the pixel order of the chunk when kFlip is set (kN / C
// pixels of C channels): a compile-time permutation of registers.
template <int C, int kN, bool kFlip>
__device__ __forceinline__ constexpr int source_of(int j) {
  return kFlip ? (kN / C - 1 - j / C) * C + j % C : j;
}

template <int C, int kN, bool kFlip>
__device__ __forceinline__ void store_chunk(float* dst, const float (&v)[kN]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    d[q] = make_float4(v[source_of<C, kN, kFlip>(4 * q)],
                       v[source_of<C, kN, kFlip>(4 * q + 1)],
                       v[source_of<C, kN, kFlip>(4 * q + 2)],
                       v[source_of<C, kN, kFlip>(4 * q + 3)]);
  }
}

template <int C, int kN, bool kFlip>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float (&v)[kN]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < kN / 8; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      w[p] = pack_bf16(v[source_of<C, kN, kFlip>(8 * q + 2 * p)],
                       v[source_of<C, kN, kFlip>(8 * q + 2 * p + 1)]);
    }
    d[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int C, int kN, bool kFlip>
__device__ __forceinline__ void store_chunk(__half* dst, const float (&v)[kN]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < kN / 8; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      w[p] = pack_f16(v[source_of<C, kN, kFlip>(8 * q + 2 * p)],
                      v[source_of<C, kN, kFlip>(8 * q + 2 * p + 1)]);
    }
    d[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// -- PTX: mbarrier and the bulk asynchronous copies ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst_smem)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src_smem)), "r"(bytes)
               : "memory");
}

// -- the bulk route ---------------------------------------------------------------------

struct BulkArgs {
  const uint8_t* x;
  void* out;
  const uint8_t* flips;   // one byte an image, or null
  int total_rows;         // N * H
  int rows_per_image;     // H
  int width;              // W
  int channels;           // C
  int row_bytes;          // W * C, a multiple of 16
  int rows_per_tile;
  int in_stage_bytes;     // one input stage, rows_per_tile * row_bytes rounded up to 128
  // the input ring's depth, kStages. It travels here rather than as a compile-time
  // constant: with the constant, nvcc's code for the tile loop ran measurably slower on
  // an H100 80GB HBM3 (bf16, 224 x 224 x 3)
  int stages;
  int out_tile_bytes;     // one output tile, rounded up to 128
};

__host__ __device__ __forceinline__ int round128(int v) { return (v + 127) & ~127; }

// One tile, C in {1, 3, 4}: chunks of lcm(16, C) bytes, whole pixels, channel of each
// element known at compile time.
template <int C, typename Out>
__device__ __forceinline__ void convert_tile_fixed(const uint8_t* in, Out* out, int rows,
                                                   int row0, const BulkArgs& a,
                                                   const ChannelParams& p) {
  constexpr int kChunk = (C == 3) ? 48 : 16;
  const int per_row = a.row_bytes / kChunk;
  const int chunks = rows * per_row;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const int r = k / per_row;
    const int c = k - r * per_row;
    const bool flip = a.flips != nullptr && a.flips[(row0 + r) / a.rows_per_image] != 0;
    const uint4* src = reinterpret_cast<const uint4*>(in + r * a.row_bytes + c * kChunk);
    float v[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk / 16; ++q) {
      const uint4 raw = src[q];
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        v[16 * q + e] = normalize_one(byte_of(words, e), p.mean[(16 * q + e) % C],
                                      p.inv_std[(16 * q + e) % C]);
      }
    }
    Out* dst = out + r * a.row_bytes + (flip ? per_row - 1 - c : c) * kChunk;
    if (flip) {
      store_chunk<C, kChunk, true>(dst, v);
    } else {
      store_chunk<C, kChunk, false>(dst, v);
    }
  }
}

// One tile, any C up to 16: 16-byte chunks with a per-chunk channel phase.
template <typename Out>
__device__ __forceinline__ void convert_tile_any(const uint8_t* in, Out* out, int rows,
                                                 int row0, const BulkArgs& a,
                                                 const float* s_mean, const float* s_inv) {
  const int per_row = a.row_bytes / 16;
  const int chunks = rows * per_row;
  const int channels = a.channels;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const int r = k / per_row;
    const int c = k - r * per_row;
    const bool flip = a.flips != nullptr && a.flips[(row0 + r) / a.rows_per_image] != 0;
    const uint4 raw = reinterpret_cast<const uint4*>(in + r * a.row_bytes)[c];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    int pixel = (16 * c) / channels;
    int ch = 16 * c - pixel * channels;
    Out* row_out = out + r * a.row_bytes;
    if (!flip) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        v[e] = normalize_one(byte_of(words, e), s_mean[ch], s_inv[ch]);
        ch = (ch + 1 == channels) ? 0 : ch + 1;
      }
      store_chunk<1, 16, false>(row_out + 16 * c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        store_one<Out>(row_out, (a.width - 1 - pixel) * channels + ch,
                       normalize_one(byte_of(words, e), s_mean[ch], s_inv[ch]));
        if (++ch == channels) {
          ch = 0;
          ++pixel;
        }
      }
    }
  }
}

// C: 1, 3 or 4 for the compile-time cases, 0 for any C up to 16.
template <int C, typename Out>
__global__ void __launch_bounds__(kThreads, 2)
normalize_bulk_kernel(BulkArgs a, ChannelParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float s_mean[kMaxChannels];
  __shared__ float s_inv[kMaxChannels];
  uint8_t* in_ring = smem;
  uint8_t* out_ring = smem + a.stages * a.in_stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_ring + kOutTiles * a.out_tile_bytes);
  // the batch cut into num_tiles tiles, a multiple of the grid, within one row of each
  // other's size (at most rows_per_tile); block b takes tiles b, b + grid, ...: every
  // block the same number, and the blocks' accesses stay in a compact window
  const int64_t grid = gridDim.x;
  const int64_t want = (a.total_rows + a.rows_per_tile - 1) / a.rows_per_tile;
  const int64_t num_tiles = grid * ((want + grid - 1) / grid);
  const int my_tiles = static_cast<int>(num_tiles / grid);
  Out* out = static_cast<Out*>(a.out);
  auto tile_row = [&](int64_t t) {  // first row of tile t
    return static_cast<int>(a.total_rows * t / num_tiles);
  };

  // tile j of this block: rows [row0, row0 + rows) of the batch, in stage j % a.stages
  auto issue_load = [&](int j) {
    const int64_t t = blockIdx.x + j * grid;
    const int row0 = tile_row(t);
    const uint32_t bytes = static_cast<uint32_t>((tile_row(t + 1) - row0) * a.row_bytes);
    uint64_t* bar = &full[j % a.stages];
    mbar_expect_tx(bar, bytes);  // an empty tile completes its phase here
    if (bytes > 0) {
      bulk_load(in_ring + (j % a.stages) * a.in_stage_bytes,
                a.x + static_cast<int64_t>(row0) * a.row_bytes, bytes, bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C == 0) {
    if (threadIdx.x < kMaxChannels) {
      s_mean[threadIdx.x] = p.mean[threadIdx.x];
      s_inv[threadIdx.x] = p.inv_std[threadIdx.x];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < a.stages && j < my_tiles; ++j) issue_load(j);
  }
  for (int i = 0; i < my_tiles; ++i) {
    const int64_t t = blockIdx.x + i * grid;
    const int row0 = tile_row(t);
    const int rows = tile_row(t + 1) - row0;
    const uint8_t* in = in_ring + (i % a.stages) * a.in_stage_bytes;
    Out* tile_out = reinterpret_cast<Out*>(out_ring + (i % kOutTiles) * a.out_tile_bytes);
    mbar_wait(&full[i % a.stages], (i / a.stages) & 1);
    if constexpr (C == 0) {
      convert_tile_any<Out>(in, tile_out, rows, row0, a, s_mean, s_inv);
    } else {
      convert_tile_fixed<C, Out>(in, tile_out, rows, row0, a, p);
    }
    // this thread's shared-memory writes become visible to the bulk store (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // the store of tile i - 2 has read its buffer, which tile i + 1 writes next
      static_assert(kOutTiles == 3, "the wait below leaves kOutTiles - 2 stores reading");
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncthreads();  // tile i converted: its input stage is free, its output tile whole
    if (threadIdx.x == 0) {
      if (rows > 0) {
        bulk_store(out + static_cast<int64_t>(row0) * a.row_bytes, tile_out,
                   static_cast<uint32_t>(rows * a.row_bytes * sizeof(Out)));
      }
      // one group a tile, empty for an empty tile, so the wait above counts tiles
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i + a.stages < my_tiles) issue_load(i + a.stages);
    }
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// -- the vector and one-element routes -----------------------------------------------------

// Where element i of an NHWC batch lands: mirrored along W when its image is flipped.
__device__ __forceinline__ int64_t flipped_index(int64_t i, const uint8_t* flips, int channels,
                                                 int width, int rows_per_image) {
  const int64_t pixel = i / channels;
  const int64_t row = pixel / width;
  const int w = static_cast<int>(pixel - row * width);
  return flips[row / rows_per_image] ? i + static_cast<int64_t>(width - 1 - 2 * w) * channels
                                     : i;
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
normalize_vec16_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, int64_t n,
                       int channels, int width, int rows_per_image,
                       const uint8_t* __restrict__ flips, ChannelParams params) {
  __shared__ float s_mean[kMaxChannels];
  __shared__ float s_inv_std[kMaxChannels];
  if (threadIdx.x < kMaxChannels) {
    s_mean[threadIdx.x] = params.mean[threadIdx.x];
    s_inv_std[threadIdx.x] = params.inv_std[threadIdx.x];
  }
  __syncthreads();
  const int64_t n_chunks = n / 16;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t chunk = first; chunk < n_chunks; chunk += stride) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[chunk];
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    int c = static_cast<int>((chunk * 16) % channels);
    float v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      v[e] = normalize_one(byte_of(words, e), s_mean[c], s_inv_std[c]);
      c = (c + 1 == channels) ? 0 : c + 1;
    }
    if (flips == nullptr) {
      store_chunk<1, 16, false>(out + chunk * 16, v);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        store_one<Out>(out, flipped_index(chunk * 16 + e, flips, channels, width,
                                          rows_per_image), v[e]);
      }
    }
  }
  // the last n % 16 elements, one per thread
  const int64_t i = n_chunks * 16 + first;
  if (i < n) {
    const int c = static_cast<int>(i % channels);
    const int64_t dst =
        flips == nullptr ? i : flipped_index(i, flips, channels, width, rows_per_image);
    store_one<Out>(out, dst, normalize_one(x[i], s_mean[c], s_inv_std[c]));
  }
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
normalize_scalar_kernel(const uint8_t* __restrict__ x, Out* __restrict__ out, int64_t n,
                        int channels, int width, int rows_per_image,
                        const uint8_t* __restrict__ flips, ChannelParams params) {
  __shared__ float s_mean[kMaxChannels];
  __shared__ float s_inv_std[kMaxChannels];
  if (threadIdx.x < kMaxChannels) {
    s_mean[threadIdx.x] = params.mean[threadIdx.x];
    s_inv_std[threadIdx.x] = params.inv_std[threadIdx.x];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = static_cast<int>(i % channels);
    const int64_t dst =
        flips == nullptr ? i : flipped_index(i, flips, channels, width, rows_per_image);
    store_one<Out>(out, dst, normalize_one(x[i], s_mean[c], s_inv_std[c]));
  }
}

// -- host side ------------------------------------------------------------------------------

std::atomic<int> g_sm_count[kMaxDevices];
std::atomic<int> g_smem_optin[kMaxDevices];

int sm_count(int device) {
  int count = g_sm_count[device].load(std::memory_order_relaxed);
  if (count == 0) {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    count = count > 0 ? count : 1;
    g_sm_count[device].store(count, std::memory_order_relaxed);
  }
  return count;
}

int smem_optin(int device) {
  int bytes = g_smem_optin[device].load(std::memory_order_relaxed);
  if (bytes == 0) {
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    bytes = bytes > 0 ? bytes : 48 * 1024;
    g_smem_optin[device].store(bytes, std::memory_order_relaxed);
  }
  return bytes;
}

// Blocks an SM of one bulk kernel instantiation at `smem` dynamic bytes, on `device`
// (0: it does not fit): the opt-in for dynamic shared memory is set once a device, the
// occupancy asked once a size.
template <int C, typename Out>
int bulk_blocks_per_sm(int device, int smem) {
  struct Entry {
    int max_dynamic;  // 0 until the opt-in is set
    int smem;
    int blocks;
  };
  static Entry cache[kMaxDevices] = {};
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  Entry& e = cache[device];
  const void* fn = reinterpret_cast<const void*>(&normalize_bulk_kernel<C, Out>);
  if (e.max_dynamic == 0) {
    cudaFuncAttributes attrs;
    if (cudaFuncGetAttributes(&attrs, fn) != cudaSuccess) return 0;
    const int max_dynamic = smem_optin(device) - static_cast<int>(attrs.sharedSizeBytes);
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_dynamic) != cudaSuccess) {
      return 0;
    }
    e.max_dynamic = max_dynamic;
  }
  if (smem > e.max_dynamic) return 0;
  if (e.smem != smem) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem) !=
        cudaSuccess) {
      return 0;
    }
    e.smem = smem;
    e.blocks = blocks;
  }
  return e.blocks;
}

template <int C, typename Out>
cudaError_t launch_bulk(const BulkArgs& a, const ChannelParams& p, int device,
                        cudaStream_t stream) {
  const int smem = a.stages * a.in_stage_bytes + kOutTiles * a.out_tile_bytes + a.stages * 8;
  const int per_sm = bulk_blocks_per_sm<C, Out>(device, smem);
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int num_tiles = (a.total_rows + a.rows_per_tile - 1) / a.rows_per_tile;
  const int cap = sm_count(device) * per_sm;
  normalize_bulk_kernel<C, Out>
      <<<num_tiles < cap ? num_tiles : cap, kThreads, smem, stream>>>(a, p);
  return cudaSuccess;
}

template <typename Out>
cudaError_t launch(const uint8_t* x, Out* out, int64_t n_images, int rows_per_image,
                   int width, int channels, const ChannelParams& p, const uint8_t* flips,
                   int route, int rows_per_tile, int device, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t n = n_images * rows_per_image * width * channels;
  if (route == kBulk) {
    const int64_t total_rows = n_images * rows_per_image;
    const int64_t row_bytes = static_cast<int64_t>(width) * channels;
    if (!aligned || row_bytes % 16 != 0 || rows_per_tile < 1 || total_rows >= (1LL << 31) ||
        rows_per_tile * row_bytes * static_cast<int64_t>(sizeof(Out)) > (1 << 20)) {
      return cudaErrorInvalidValue;
    }
    BulkArgs a;
    a.x = x;
    a.out = out;
    a.flips = flips;
    a.total_rows = static_cast<int>(total_rows);
    a.rows_per_image = rows_per_image;
    a.width = width;
    a.channels = channels;
    a.row_bytes = static_cast<int>(row_bytes);
    a.rows_per_tile = rows_per_tile;
    a.in_stage_bytes = round128(rows_per_tile * a.row_bytes);
    a.stages = kStages;
    a.out_tile_bytes = round128(rows_per_tile * a.row_bytes * static_cast<int>(sizeof(Out)));
    switch (channels) {
      case 1: return launch_bulk<1, Out>(a, p, device, stream);
      case 3: return launch_bulk<3, Out>(a, p, device, stream);
      case 4: return launch_bulk<4, Out>(a, p, device, stream);
      default: return launch_bulk<0, Out>(a, p, device, stream);
    }
  }
  if (route == kVector && !aligned) return cudaErrorInvalidValue;
  const int64_t work = route == kVector ? (n / 16 > 0 ? n / 16 : 1) : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count(device)) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  if (route == kVector) {
    normalize_vec16_kernel<Out><<<blocks, kThreads, 0, stream>>>(
        x, out, n, channels, width, rows_per_image, flips, p);
  } else {
    normalize_scalar_kernel<Out><<<blocks, kThreads, 0, stream>>>(
        x, out, n, channels, width, rows_per_image, flips, p);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: an (n_images, rows_per_image, width, channels) uint8 NHWC batch; out: as many values
// of out_kind (0 = bfloat16, 1 = float32, 2 = float16); mean / inv_std: `channels` float32 values in
// HOST memory (copied into the launch parameters); flips: n_images bytes on the device
// (non-zero = mirror that image along W) or null. route: 0 bulk (rows_per_tile rows of
// width * channels bytes a tile; needs 16-byte aligned pointers and width * channels a
// multiple of 16), 1 vector (16-byte aligned pointers), 2 one element a thread (any).
// x, out and flips live on CUDA device `device`; launches on `stream` (a stream of that
// device); returns the cudaError_t of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments it does not take.
int ptpu_normalize_u8(const void* x, void* out, int64_t n_images, int rows_per_image,
                      int width, int channels, const float* mean, const float* inv_std,
                      int out_kind, const void* flips, int route, int rows_per_tile,
                      int device, void* stream) {
  if (channels < 1 || channels > kMaxChannels || out_kind < 0 || out_kind > 2 ||
      route < kBulk || route > kScalar || device < 0 || device >= kMaxDevices ||
      n_images < 0 || rows_per_image < 0 || width < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_images == 0 || rows_per_image == 0 || width == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ChannelParams p;
  for (int c = 0; c < kMaxChannels; ++c) {
    p.mean[c] = c < channels ? mean[c] : 0.f;
    p.inv_std[c] = c < channels ? inv_std[c] : 0.f;
  }
  const uint8_t* src = static_cast<const uint8_t*>(x);
  const uint8_t* f = static_cast<const uint8_t*>(flips);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      err = launch(src, static_cast<__nv_bfloat16*>(out), n_images, rows_per_image, width,
                   channels, p, f, route, rows_per_tile, device, s);
      break;
    case 1:
      err = launch(src, static_cast<float*>(out), n_images, rows_per_image, width, channels,
                   p, f, route, rows_per_tile, device, s);
      break;
    default:
      err = launch(src, static_cast<__half*>(out), n_images, rows_per_image, width,
                   channels, p, f, route, rows_per_tile, device, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
