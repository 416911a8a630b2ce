// K3 (snappy page inflate), the RLE run-table scan, and K4 (RLE/bit-packed extract)
// for Hopper (sm_90a): the device half of the compressed-page pass-through.
//
// K3 replaces the Pallas kernel petastorm_tpu/ops/pagedec_kernels.py:149
// `_snappy_pages_kernel` (launched :167, body `_snappy_machine` :54): the snappy LZ token
// machine, one page per program. The scan replaces `_rle_run_scan` (:224, a
// lax.while_loop, not Pallas). K4 replaces `_extract_kernel` (:290, launched :319) and
// takes in the run-id lookup and the 4-byte window gather that `rle_expand` (:328) did as
// separate jnp ops, and takes every bit width Parquet allows (1-32), where the
// reference's 4-byte windows stop at 24.
//
// Bound on an H100 SXM: bytes, in principle (each compressed byte read once, each
// decoded byte or value written once: ~100 KB a column a batch, ~30 ns at 3.35 TB/s).
// In practice all three are latency-bound: a snappy stream and a run stream are
// sequential by definition, so one thread walks each and the card's width only helps
// with the copying. The design keeps the walk cheap and moves the bulk bytes wide:
//
// - K3: one thread block per page. Thread 0 parses the tags. Tokens of at least
//   kBlockCopyMin bytes whose source does not overlap their destination (literals, and
//   copies with offset >= length) are handed to the whole block through shared memory
//   and copied one byte per thread; shorter tokens and overlapping copies (offset <
//   length, byte-serial by definition) are copied by thread 0 alone. The tail of the row
//   past the last byte written is zero-filled by the block, as the reference's output
//   starts from zeros.
// - Scan: one thread walks the run stream (reads stay in L1); the block then fills the
//   unused table entries as the reference initialises them.
// - K4: one thread per value: binary search of its run in run_end (torch.searchsorted
//   side="right" over the whole table), the little-endian 5-byte window with every
//   index clamped to cap - 1, then (word >> shift) & mask in a bit-packed run and the
//   run's RLE value otherwise. uint64 arithmetic: shift <= 7 plus width <= 32 fits the
//   window's 40 bits. For widths up to 24 the fifth byte lies above the mask, so the
//   values equal the reference's 4-byte window and arithmetic int32 shift.
//
// Every read is clamped to its buffer and every write is in bounds, and `ok` latches 0
// in exactly the reference's cases. Bound checks are done in 64-bit integers, where
// the reference's int32 sums can wrap: on every input where the reference terminates
// the verdict is the same, and a crafted literal length near 2^31 that would wrap the
// reference's `start + ln` check ends here with ok = 0 instead of a 2^31-byte loop.
// Varint preambles and run headers keep the reference's 32-bit truncation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSnappyThreads = 128;
constexpr int64_t kBlockCopyMin = 32;
constexpr int kScanThreads = 256;
constexpr int kExtractThreads = 256;

// snappy token command handed from thread 0 to the block
constexpr int kCmdDone = 0;
constexpr int kCmdLiteral = 1;
constexpr int kCmdCopy = 2;

__device__ __forceinline__ uint32_t clamped_byte(const uint8_t* row, int64_t cap, int64_t i) {
  if (cap <= 0) return 0u;
  i = i < 0 ? 0 : (i >= cap ? cap - 1 : i);
  return row[i];
}

__global__ void __launch_bounds__(kSnappyThreads)
snappy_pages_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ meta,
                    uint8_t* out, int32_t* __restrict__ ok_out, int64_t src_cap,
                    int64_t out_cap) {
  const int64_t page = blockIdx.x;
  const uint8_t* src_row = comp + page * src_cap;
  uint8_t* dst_row = out + page * out_cap;
  __shared__ int64_t s_from, s_to, s_len;
  __shared__ int s_kind;

  // thread 0's machine state
  int64_t comp_len = 0, src = 0, dst = 0, out_len = 0;
  bool ok = true;
  if (threadIdx.x == 0) {
    comp_len = meta[2 * page];
    // preamble: varint uncompressed length, 32-bit as the reference
    uint32_t val = 0;
    int shift = 0;
    bool done = false;
    int64_t pos = 0;
    while (!done && ok) {
      const uint32_t b = clamped_byte(src_row, src_cap, pos);
      if (shift < 32) val |= (b & 0x7Fu) << shift;
      done = (b & 0x80u) == 0;
      ok = ok && pos < comp_len && shift <= 28;
      ++pos;
      shift += 7;
    }
    out_len = static_cast<int32_t>(val);
    ok = ok && out_len <= out_cap;
    src = pos;
  }

  while (true) {
    if (threadIdx.x == 0) {
      s_kind = kCmdDone;
      while (src < comp_len && dst < out_len && ok) {
        const uint32_t tag = clamped_byte(src_row, src_cap, src);
        const uint32_t t = tag & 3u;
        int64_t ln, next_src, from = 0, off = 0;
        bool good;
        if (t == 0) {
          const int n0 = static_cast<int>(tag >> 2);
          const int extra = n0 >= 60 ? n0 - 59 : 0;
          const uint32_t mask =
              extra >= 4 ? 0x7FFFFFFFu : ((1u << (8 * (extra < 3 ? extra : 3))) - 1u);
          const uint32_t word = clamped_byte(src_row, src_cap, src + 1) |
                                (clamped_byte(src_row, src_cap, src + 2) << 8) |
                                (clamped_byte(src_row, src_cap, src + 3) << 16) |
                                ((clamped_byte(src_row, src_cap, src + 4) & 0x7Fu) << 24);
          ln = (n0 >= 60 ? static_cast<int64_t>(word & mask) : n0) + 1;
          from = src + 1 + extra;
          good = ln >= 1 && from + ln <= comp_len && dst + ln <= out_len;
          next_src = from + ln;
        } else {
          const uint32_t b1 = clamped_byte(src_row, src_cap, src + 1);
          int64_t consumed;
          if (t == 1) {
            ln = ((tag >> 2) & 7u) + 4;
            off = ((tag >> 5) << 8) | b1;
            consumed = 2;
          } else if (t == 2) {
            ln = (tag >> 2) + 1;
            off = b1 | (clamped_byte(src_row, src_cap, src + 2) << 8);
            consumed = 3;
          } else {
            ln = (tag >> 2) + 1;
            off = static_cast<int32_t>(b1 | (clamped_byte(src_row, src_cap, src + 2) << 8) |
                                       (clamped_byte(src_row, src_cap, src + 3) << 16) |
                                       (clamped_byte(src_row, src_cap, src + 4) << 24));
            consumed = 5;
          }
          good = src + consumed <= comp_len && off > 0 && off <= dst && dst + ln <= out_len;
          next_src = src + consumed;
        }
        if (!good) {
          ok = false;
          break;
        }
        const bool overlapping = t != 0 && off < ln;
        if (ln >= kBlockCopyMin && !overlapping) {
          s_kind = t == 0 ? kCmdLiteral : kCmdCopy;
          s_from = t == 0 ? from : dst - off;
          s_to = dst;
          s_len = ln;
          src = next_src;
          dst += ln;
          break;
        }
        if (t == 0) {
          for (int64_t k = 0; k < ln; ++k) {
            dst_row[dst + k] = static_cast<uint8_t>(clamped_byte(src_row, src_cap, from + k));
          }
        } else {
          for (int64_t k = 0; k < ln; ++k) dst_row[dst + k] = dst_row[dst - off + k];
        }
        src = next_src;
        dst += ln;
      }
    }
    __syncthreads();
    const int kind = s_kind;
    if (kind == kCmdDone) break;
    const int64_t from = s_from, to = s_to, len = s_len;
    if (kind == kCmdLiteral) {
      for (int64_t k = threadIdx.x; k < len; k += blockDim.x) {
        dst_row[to + k] = static_cast<uint8_t>(clamped_byte(src_row, src_cap, from + k));
      }
    } else {
      for (int64_t k = threadIdx.x; k < len; k += blockDim.x) {
        dst_row[to + k] = dst_row[from + k];
      }
    }
    __syncthreads();
  }

  // every byte in [0, dst) was written by a good token; the rest of the row is zero
  if (threadIdx.x == 0) {
    ok = ok && dst == out_len && src == comp_len;
    ok_out[page] = ok ? 1 : 0;
    s_to = dst;
  }
  __syncthreads();
  for (int64_t k = s_to + threadIdx.x; k < out_cap; k += blockDim.x) dst_row[k] = 0;
}

__global__ void __launch_bounds__(kScanThreads)
rle_run_scan_kernel(const uint8_t* __restrict__ data, int64_t data_len, int64_t cap,
                    int32_t total, int32_t max_runs, int bit_width, int32_t* run_end,
                    int32_t* is_packed, int32_t* rle_value, int32_t* bit_base,
                    int32_t* status) {
  __shared__ int32_t s_written;
  if (threadIdx.x == 0) {
    const int byte_width = (bit_width + 7) / 8;
    int64_t pos = 0, filled = 0;
    int32_t nruns = 0;
    bool ok = true;
    while (filled < total && ok) {
      uint32_t header = 0;
      int shift = 0;
      bool done = false;
      while (!done && ok) {
        const uint32_t b = clamped_byte(data, cap, pos);
        if (shift < 32) header |= (b & 0x7Fu) << shift;
        done = (b & 0x80u) == 0;
        ok = ok && pos < data_len && shift <= 28;
        ++pos;
        shift += 7;
      }
      const int32_t h = static_cast<int32_t>(header);
      const bool packed = (h & 1) == 1;
      const int64_t groups = h >> 1;
      const int64_t count = packed ? groups * 8 : groups;
      const int64_t consumed = packed ? groups * bit_width : byte_width;
      uint32_t v = 0;
      for (int k = 0; k < byte_width; ++k) v |= clamped_byte(data, cap, pos + k) << (8 * k);
      ok = ok && pos + consumed <= data_len && count > 0 && nruns < max_runs;
      const int32_t idx = nruns < max_runs ? nruns : max_runs - 1;
      const int64_t end = filled + count < total ? filled + count : total;
      run_end[idx] = static_cast<int32_t>(end);
      is_packed[idx] = packed ? 1 : 0;
      rle_value[idx] = packed ? 0 : static_cast<int32_t>(v);
      bit_base[idx] = static_cast<int32_t>(pos * 8);
      pos += consumed;
      filled += count;
      ++nruns;
    }
    ok = ok && filled >= total;
    status[0] = nruns;
    status[1] = ok ? 1 : 0;
    s_written = nruns < max_runs ? nruns : max_runs;
  }
  __syncthreads();
  for (int32_t i = s_written + threadIdx.x; i < max_runs; i += blockDim.x) {
    run_end[i] = INT32_MAX;
    is_packed[i] = 0;
    rle_value[i] = 0;
    bit_base[i] = 0;
  }
}

__global__ void __launch_bounds__(kExtractThreads)
rle_extract_kernel(const uint8_t* __restrict__ data, int64_t cap,
                   const int32_t* __restrict__ run_end, const int32_t* __restrict__ is_packed,
                   const int32_t* __restrict__ rle_value, const int32_t* __restrict__ bit_base,
                   int32_t max_runs, int bit_width, uint64_t mask, int32_t total,
                   int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int32_t lo = 0, hi = max_runs;  // first run whose end is > i
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (run_end[mid] <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int32_t rid = lo < max_runs ? lo : max_runs - 1;
  const int64_t run_start = rid == 0 ? 0 : run_end[rid - 1];
  if (is_packed[rid] == 0) {
    out[i] = rle_value[rid];
    return;
  }
  const int64_t bitpos = static_cast<int64_t>(bit_base[rid]) + (i - run_start) * bit_width;
  const int64_t byte_off = bitpos >> 3;
  const int shift = static_cast<int>(bitpos & 7);
  uint64_t word = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    word |= static_cast<uint64_t>(clamped_byte(data, cap, byte_off + j)) << (8 * j);
  }
  out[i] = static_cast<int32_t>(static_cast<uint32_t>((word >> shift) & mask));
}

}  // namespace

extern "C" {

// comp: (n_pages, src_cap) uint8, zero-padded compressed pages; meta: (n_pages, 2) int32
// rows [comp_len, out_len]; out: (n_pages, out_cap) uint8; ok: (n_pages,) int32 (1 = the
// page decoded exactly). All on CUDA device `device`; launches on `stream` and returns
// the cudaError_t of the launch (0 = cudaSuccess).
int ptpu_snappy_pages(const void* comp, const void* meta, void* out, void* ok, int64_t n_pages,
                      int64_t src_cap, int64_t out_cap, int device, void* stream) {
  if (n_pages < 0 || src_cap < 1 || out_cap < 0 || n_pages > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pages == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  snappy_pages_kernel<<<static_cast<unsigned>(n_pages), kSnappyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(meta),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(ok), src_cap, out_cap);
  return static_cast<int>(cudaGetLastError());
}

// One hybrid RLE/bit-packed stream: data (cap,) uint8 of which data_len bytes are the
// stream. Fills the (max_runs,) int32 tables run_end, is_packed, rle_value, bit_base and
// status (2,) int32 = [n_runs, ok].
int ptpu_rle_run_scan(const void* data, int64_t data_len, int64_t cap, int32_t total,
                      int32_t max_runs, int bit_width, void* run_end, void* is_packed,
                      void* rle_value, void* bit_base, void* status, int device,
                      void* stream) {
  if (max_runs < 1 || total < 0 || bit_width < 1 || bit_width > 32 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  rle_run_scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), data_len, cap, total, max_runs, bit_width,
      static_cast<int32_t*>(run_end), static_cast<int32_t*>(is_packed),
      static_cast<int32_t*>(rle_value), static_cast<int32_t*>(bit_base),
      static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// `total` int32 values of one stream from its run tables (ptpu_rle_run_scan) and its
// bytes data (cap,) uint8; out: (total,) int32.
int ptpu_rle_extract(const void* data, int64_t cap, const void* run_end, const void* is_packed,
                     const void* rle_value, const void* bit_base, int32_t max_runs,
                     int bit_width, int32_t total, void* out, int device, void* stream) {
  if (max_runs < 1 || total < 0 || bit_width < 1 || bit_width > 32 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t mask = (1ull << bit_width) - 1ull;
  const int blocks = (total + kExtractThreads - 1) / kExtractThreads;
  rle_extract_kernel<<<blocks, kExtractThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), cap, static_cast<const int32_t*>(run_end),
      static_cast<const int32_t*>(is_packed), static_cast<const int32_t*>(rle_value),
      static_cast<const int32_t*>(bit_base), max_runs, bit_width, mask, total,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
