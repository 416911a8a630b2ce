// K3 (snappy page inflate), the RLE run-table scan, and K4 (RLE/bit-packed extract)
// for Hopper (sm_90a): the device half of the compressed-page pass-through.
//
// K3 replaces the Pallas kernel petastorm_tpu/ops/pagedec_kernels.py:149
// `_snappy_pages_kernel` (launched :167, body `_snappy_machine` :54): the snappy LZ token
// machine, one page per program. The scan replaces `_rle_run_scan` (:224, a
// lax.while_loop, not Pallas). K4 replaces `_extract_kernel` (:290, launched :319) and
// takes in the run-id lookup and the 4-byte window gather that `rle_expand` (:338) did as
// separate jnp ops, the per-page checks of the reference's `inflate_window` (:472-503:
// level block, PLAIN length, dictionary index range) and the dictionary gather, and
// takes every bit width Parquet allows (1-32), where the reference's 4-byte windows stop
// at 24.
//
// Bound on an H100 SXM: bytes, in principle (each compressed byte read once, each
// decoded byte or value written once: ~2.2 MB a 16,384-row Criteo batch, ~0.7 us at
// 3.35 TB/s). In practice all three are latency-bound: a snappy stream and a run stream
// are sequential by definition. K3's serial floor is its longest page's tokens times one
// shared-memory round trip each (~4,650 tokens x ~30 cycles, ~0.07 ms for a dense
// Criteo data page); the parallel parse below shares that chain among 32 lanes.
//
// - K3: ONE launch over every page of a batch. The pages lie back to back in one ragged
//   source buffer and decode into one ragged output buffer; a page table row per page,
//   int64 [src_off, src_len, comp_len, dst_off, out_cap], says where. Reads of a page
//   clamp to its [src_off, src_off + src_len) span (the reference's clamped gather over
//   its src_cap row); `comp_len` bounds the stream; the page's output is its
//   [dst_off, dst_off + out_cap) span, zero past the bytes it decoded. One block per page:
//   - its four warps stage the compressed page in shared memory with cp.async (16-byte
//     copies; the window base is offset so that it is aligned where the page is);
//   - warps 0 and 1 run the token machine as a pipeline, warp 0 parsing a round of
//     tokens into one half of a queue while warp 1 executes the previous round's from
//     the other half (snappy_machine_shared: a warp-parallel speculative parse and
//     32 output bytes a step, see there);
//   - the output decodes into a shared-memory window, which the block then stores with
//     16-byte stores, zero-filled past the decoded bytes.
//   A page whose source exceeds kSrcWindow, or whose output exceeds kOutWindow, or whose
//   stream is longer than its readable span, runs the same pipeline with a serial parser
//   and clamped byte reads, on device memory directly where a span is above its window
//   (snappy_machine_any: the same kernel, another branch).
// - Scan: ONE launch over every data page of a batch (a page table row a page, see
//   PageCol), one thread a page in blocks of 32 pages; it reads the level block's
//   length and the bit width from the page bytes, makes the page's checks, and writes
//   only the run entries that exist (a ragged run table) and a verdict a page.
// - K4: ONE launch over the values of every data page of a batch (a block-range table
//   maps blocks to pages): a dictionary page's values are found by one run search a warp
//   and a walk, decoded from a 5-byte window, range-checked and gathered from the
//   dictionary straight into the column's output; a PLAIN page's values are copied. The
//   page's flag latches a reason code. uint64 arithmetic: shift <= 7 plus width <= 32
//   fits the window's 40 bits. For widths up to 24 the fifth byte lies above the mask,
//   so the values equal the reference's 4-byte window and arithmetic int32 shift.
//
// Every read is clamped to its buffer and every write is in bounds, and `ok` latches 0
// in exactly the reference's cases. Bound checks are done in 64-bit integers, where
// the reference's int32 sums can wrap: on every input where the reference terminates
// the verdict is the same, and a crafted literal length near 2^31 that would wrap the
// reference's `start + ln` check ends here with ok = 0 instead of a 2^31-byte loop.
// Varint preambles and run headers keep the reference's 32-bit truncation. A page-table
// row whose spans leave the buffers latches ok = 0 and writes nothing.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSnappyThreads = 128;
constexpr int kTableCols = 5;
constexpr int64_t kSrcWindow = 40 * 1024;  // compressed bytes staged in shared memory
constexpr int64_t kOutWindow = 66 * 1024;  // decoded bytes kept in shared memory
constexpr int kQueue = 32;                 // tokens a round (one per executor lane)
constexpr int kSrcSlack = 64;  // past the source window: alignment shift + speculative reads
constexpr int kOutSlack = 16;  // past the output window: alignment shift
constexpr int kExtractThreads = 256;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// A snappy token, from the parser warp to the executor warp: a literal copies `len`
// bytes from the source at `a`; a copy repeats `len` bytes from `a` (the offset) bytes
// back. A token that reaches the queue passed its checks, so to + len <= out_len < 2^31.
struct Token {
  int64_t a;
  uint32_t to;
  uint32_t len_kind;  // len | kind << 31 (kind 1: copy)
};
constexpr uint32_t kCopyBit = 0x80000000u;
constexpr int kQueueBytes = 2 * kQueue * static_cast<int>(sizeof(Token));  // two rounds
// queue, then the source window and the output window with their slack: 109,648 bytes,
// two blocks an SM. The output window holds a 16,384-row page of 4-byte values with its
// level block.
constexpr int kSnappySmem = kQueueBytes + static_cast<int>(kSrcWindow) + kSrcSlack +
                            static_cast<int>(kOutWindow) + kOutSlack;
static_assert(kQueueBytes % 16 == 0 && kSrcSlack % 16 == 0,
              "the windows must start 16-byte aligned");

__device__ __forceinline__ uint32_t clamped_byte(const uint8_t* row, int64_t cap, int64_t i) {
  if (cap <= 0) return 0u;
  i = i < 0 ? 0 : (i >= cap ? cap - 1 : i);
  return row[i];
}

__device__ __forceinline__ int64_t shfl64(int64_t v, int lane) {
  return static_cast<int64_t>(__shfl_sync(kFullMask, static_cast<long long>(v), lane));
}

// the parser warp and the executor warp meet here once a round (barrier 1, 64 threads)
__device__ __forceinline__ void pair_barrier() {
  __syncwarp();
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// Bytes pos .. pos+7 of a shared-memory buffer as two little-endian words, from three
// aligned 32-bit loads.
__device__ __forceinline__ void window8(const uint8_t* s, uint32_t pos, uint32_t* lo,
                                        uint32_t* hi) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(s) + pos;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(addr & ~static_cast<uintptr_t>(3));
  const uint32_t sh = 8u * static_cast<uint32_t>(addr & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  *lo = __funnelshift_r(w0, w1, sh);
  *hi = __funnelshift_r(w1, w2, sh);
}

// The varint preamble (the uncompressed length, 32-bit as the reference): returns the
// position after it and sets out_len and ok.
__device__ __forceinline__ int64_t snappy_preamble(const uint8_t* src, int64_t src_len,
                                                   int64_t comp_len, int64_t out_cap,
                                                   int64_t* out_len, bool* ok) {
  uint32_t val = 0;
  int shift = 0;
  bool done = false;
  int64_t pos = 0;
  *ok = true;
  while (!done && *ok) {
    const uint32_t b = clamped_byte(src, src_len, pos);
    if (shift < 32) val |= (b & 0x7Fu) << shift;
    done = (b & 0x80u) == 0;
    *ok = *ok && pos < comp_len && shift <= 28;
    ++pos;
    shift += 7;
  }
  *out_len = static_cast<int32_t>(val);
  *ok = *ok && *out_len <= out_cap;
  return pos;
}

// One snappy token at `pos` from its tag and the four bytes after it; `good` is the
// reference's bound check (done in 64-bit: a literal length reaches 2^31).
__device__ __forceinline__ void decode_token(uint32_t tag, uint32_t b1, uint32_t b2,
                                             uint32_t b3, uint32_t b4, int64_t pos,
                                             int64_t dst, int64_t comp_len, int64_t out_len,
                                             Token* tok, int64_t* next_pos, bool* good) {
  const uint32_t t = tag & 3u;
  int64_t len;
  if (t == 0) {
    const int n0 = static_cast<int>(tag >> 2);
    const int extra = n0 >= 60 ? n0 - 59 : 0;
    const uint32_t mask =
        extra >= 4 ? 0x7FFFFFFFu : ((1u << (8 * (extra < 3 ? extra : 3))) - 1u);
    const uint32_t word = b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x7Fu) << 24);
    len = (n0 >= 60 ? static_cast<int64_t>(word & mask) : n0) + 1;
    tok->a = pos + 1 + extra;
    *good = len >= 1 && tok->a + len <= comp_len && dst + len <= out_len;
    *next_pos = tok->a + len;
    tok->len_kind = static_cast<uint32_t>(len);
  } else {
    int64_t consumed;
    if (t == 1) {
      len = ((tag >> 2) & 7u) + 4;
      tok->a = ((tag >> 5) << 8) | b1;
      consumed = 2;
    } else if (t == 2) {
      len = (tag >> 2) + 1;
      tok->a = b1 | (b2 << 8);
      consumed = 3;
    } else {
      len = (tag >> 2) + 1;
      tok->a = static_cast<int32_t>(b1 | (b2 << 8) | (b3 << 16) | (b4 << 24));
      consumed = 5;
    }
    *good = pos + consumed <= comp_len && tok->a > 0 && tok->a <= dst && dst + len <= out_len;
    *next_pos = pos + consumed;
    tok->len_kind = static_cast<uint32_t>(len) | kCopyBit;
  }
  tok->to = static_cast<uint32_t>(dst);
}

// The token machine for a page in the shared windows (src_len <= kSrcWindow, out_cap <=
// kOutWindow, comp_len <= src_len), so every position and length fits 32 bits. Warps 0
// and 1 of the block, as a pipeline: warp 0 parses a round of tokens into one half of
// the queue while warp 1 executes the previous round's from the other half; they meet
// at a named barrier once a round.
//  - Parsing, warp-parallel and speculative: for a 32-byte span of the stream starting at
//    the next token, every lane decodes the token that would start at its byte; a
//    shuffle chain from lane 0 marks the real token starts; an inclusive scan of their
//    lengths gives each token's output offset; then every token runs the reference's
//    bound checks, and the first one that fails (or whose output offset has reached
//    out_len) ends the stream exactly where the byte-serial loop ends it. Bytes past
//    comp_len (the span's tail and the window's slack) only ever decode tokens that fail
//    their checks or lie past the stream's end.
//  - Executing: a token of 32+ bytes alone, its bytes strided over the 32 lanes; a run of
//    shorter tokens 32 output bytes a step, each lane finding the token that writes its
//    byte (a ballot over the token starts). A literal byte comes from the source; a copy
//    byte j of a token at `to` is out[to - off + (j mod off)], a byte before the token
//    (the byte-serial definition, overlapping copies included), read from the window
//    when it lies before the step, else taken from the lane of an earlier token that
//    computes it in this step (pointer jumping over shuffles). __syncwarp() between
//    tokens and steps.
// Returns, in thread 0, the bytes decoded (dst) and the verdict.
__device__ __forceinline__ void snappy_machine_shared(const uint8_t* src, int64_t src_len,
                                                      int64_t comp_len, uint8_t* out,
                                                      int64_t out_cap, Token* queue,
                                                      int* counts, int64_t* dst_out,
                                                      bool* ok_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the parser's state, uniform over warp 0
  int64_t out_len64 = 0;
  bool ok = true;
  int32_t pos = 0, dst = 0;
  if (warp == 0) {
    pos = static_cast<int32_t>(snappy_preamble(src, src_len, comp_len, out_cap, &out_len64, &ok));
  }
  const int32_t out_len = static_cast<int32_t>(out_len64);
  const int32_t c_len = static_cast<int32_t>(comp_len);
  bool ended = false;
  for (int round = 0;; ++round) {
    const int half = round & 1;
    if (warp == 0) {
      Token* q = queue + half * kQueue;
      int n = 0;
      // a span holds at most 16 token starts (every token takes 2+ bytes)
      while (n <= kQueue - 16 && !ended && pos < c_len && dst < out_len && ok) {
        const int32_t base = pos;
        const int32_t p = base + lane;
        uint32_t lo, hi;
        window8(src, static_cast<uint32_t>(p), &lo, &hi);
        const uint32_t tag = lo & 0xFFu;
        const uint32_t t = tag & 3u;
        uint32_t len, consumed;
        int32_t a;
        if (t == 0) {
          const uint32_t n0 = tag >> 2;
          const uint32_t extra = n0 >= 60 ? n0 - 59 : 0;
          const uint32_t word = (lo >> 8) | ((hi & 0x7Fu) << 24);
          const uint32_t mask = extra >= 4 ? 0x7FFFFFFFu : ((1u << (8 * extra)) - 1u);
          len = (n0 >= 60 ? (word & mask) : n0) + 1u;  // <= 2^31
          a = p + 1 + static_cast<int32_t>(extra);
          consumed = 1u + extra + len;
        } else {
          len = t == 1 ? ((tag >> 2) & 7u) + 4u : (tag >> 2) + 1u;
          a = t == 1   ? static_cast<int32_t>(((tag >> 5) << 8) | ((lo >> 8) & 0xFFu))
              : t == 2 ? static_cast<int32_t>((lo >> 8) & 0xFFFFu)
                       : static_cast<int32_t>((lo >> 8) | (hi << 24));
          consumed = t == 1 ? 2u : (t == 2 ? 3u : 5u);
        }
        // the chain of real token starts within the span
        const int32_t rel_next = lane + static_cast<int32_t>(consumed < 32u ? consumed : 32u);
        uint32_t starts = 0;
        int32_t cur = 0;
        while (cur < 32 && base + cur < c_len) {
          starts |= 1u << cur;
          cur = __shfl_sync(kFullMask, rel_next, cur);
        }
        const bool is_tok = (starts >> lane) & 1u;
        // output offsets: a length past 2^20 fails its check (out_len <= kOutWindow)
        const int32_t slen = is_tok ? static_cast<int32_t>(len < (1u << 20) ? len : (1u << 20)) : 0;
        int32_t incl = slen;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int32_t v = __shfl_up_sync(kFullMask, incl, d);
          if (lane >= d) incl += v;
        }
        const int32_t d_l = dst + incl - slen;
        const bool run = d_l < out_len;
        const uint32_t room = static_cast<uint32_t>(out_len - d_l);
        const bool good =
            t == 0 ? (a <= c_len && len <= static_cast<uint32_t>(c_len - a) && len <= room)
                   : (p + static_cast<int32_t>(consumed) <= c_len && a > 0 && a <= d_l &&
                      len <= room);
        const uint32_t stop = __ballot_sync(kFullMask, is_tok && !(run && good));
        const int first = stop ? __ffs(stop) - 1 : 32;
        const uint32_t exec = first < 32 ? (starts & ((1u << first) - 1u)) : starts;
        if ((exec >> lane) & 1u) {
          Token tok;
          tok.a = a;
          tok.to = static_cast<uint32_t>(d_l);
          tok.len_kind = len | (t == 0 ? 0u : kCopyBit);
          q[n + __popc(exec & ((1u << lane) - 1u))] = tok;
        }
        n += __popc(exec);
        if (first < 32) {  // the byte-serial loop stops at this token
          if (__shfl_sync(kFullMask, run ? 1 : 0, first)) ok = false;
          pos = base + first;
          dst = __shfl_sync(kFullMask, d_l, first);
          ended = true;
        } else {
          const int last = 31 - __clz(exec);
          pos = base + last + static_cast<int32_t>(__shfl_sync(kFullMask, consumed, last));
          dst = __shfl_sync(kFullMask, d_l, last) +
                static_cast<int32_t>(__shfl_sync(kFullMask, len, last));
        }
      }
      if (lane == 0) counts[half] = n;
    } else if (round > 0) {
      const Token* q = queue + (half ^ 1) * kQueue;
      const int n = counts[half ^ 1];
      Token mine = {0, 0u, 0u};
      if (lane < n) mine = q[lane];
      const uint32_t my_len = mine.len_kind & ~kCopyBit;
      const uint32_t long_mask = __ballot_sync(kFullMask, lane < n && my_len >= 32u);
      int k = 0;
      while (k < n) {
        if ((long_mask >> k) & 1u) {  // a long token alone: its bytes strided over the lanes
          const int64_t a = shfl64(mine.a, k);
          const uint32_t to = __shfl_sync(kFullMask, mine.to, k);
          const uint32_t len_kind = __shfl_sync(kFullMask, mine.len_kind, k);
          const uint32_t len = len_kind & ~kCopyBit;
          if ((len_kind & kCopyBit) == 0) {
            for (uint32_t j = lane; j < len; j += 32) out[to + j] = src[a + j];
          } else {
            // out[to + j] = out[to - off + (j mod off)], j mod off kept incrementally
            const uint32_t off = static_cast<uint32_t>(a);
            const uint32_t step = 32u % off;
            uint32_t r = static_cast<uint32_t>(lane) % off;
            for (uint32_t j = lane; j < len; j += 32) {
              out[to + j] = out[to - off + r];
              r += step;
              if (r >= off) r -= off;
            }
          }
          __syncwarp();
          ++k;
          continue;
        }
        // a run of short tokens k .. e-1, 32 output bytes a step
        const uint32_t rest = long_mask >> k;
        const int e = rest ? k + __ffs(rest) - 1 : n;
        const uint32_t d0 = __shfl_sync(kFullMask, mine.to, k);
        const uint32_t d1 = __shfl_sync(kFullMask, mine.to + my_len, e - 1);
        for (uint32_t g = d0; g < d1; g += 32) {
          const uint32_t qq = g + lane;
          const bool starts_here = lane < n && mine.to >= g && mine.to < g + 32;
          const uint32_t m =
              __reduce_or_sync(kFullMask, starts_here ? 1u << (mine.to - g) : 0u);
          const int before = __popc(__ballot_sync(kFullMask, lane < n && mine.to < g));
          const int kq = before - 1 + __popc(m & ((2u << lane) - 1u));  // the token of qq
          const int kl = kq < 0 ? 0 : kq;
          const int64_t ka = shfl64(mine.a, kl);
          const uint32_t kto = __shfl_sync(kFullMask, mine.to, kl);
          const uint32_t klk = __shfl_sync(kFullMask, mine.len_kind, kl);
          uint32_t v = 0;
          bool resolved = true;
          int ptr = 0;
          if (qq < d1) {
            if ((klk & kCopyBit) == 0) {
              v = src[ka + (qq - kto)];
            } else {
              // out[to + j] = out[to - off + (j mod off)]: a byte before the token
              const uint32_t off = static_cast<uint32_t>(ka), j = qq - kto;
              const uint32_t s = kto - off + (j < off ? j : j % off);
              if (s >= g) {
                resolved = false;  // an earlier token writes it in this step, lane s - g
                ptr = static_cast<int>(s - g);
              } else {
                v = out[s];
              }
            }
          }
          while (__any_sync(kFullMask, !resolved)) {  // pointers go to lower lanes: ends
            const uint32_t pv = __shfl_sync(kFullMask, v, ptr);
            const int pr = __shfl_sync(kFullMask, resolved ? 1 : 0, ptr);
            const int pp = __shfl_sync(kFullMask, ptr, ptr);
            if (!resolved) {
              if (pr) {
                v = pv;
                resolved = true;
              } else {
                ptr = pp;
              }
            }
          }
          if (qq < d1) out[qq] = static_cast<uint8_t>(v);
          __syncwarp();  // this step's bytes are visible to the next step's reads
        }
        k = e;
      }
    }
    pair_barrier();
    if (counts[half] == 0) break;  // nothing parsed this round: the last was executed
  }
  if (threadIdx.x == 0) {
    *dst_out = dst;
    *ok_out = ok && dst == out_len && pos == c_len;
  }
}

// The token machine for any other page (a source or output span above its window, or
// a stream longer than its readable span): the same two-warp pipeline on device memory
// or the windows, with clamped byte reads, lane 0 of warp 0 parsing serially in 64-bit
// and warp 1 executing one token at a time, its bytes spread over the 32 lanes. An
// overlapping copy (offset < length) writes out[to + k] = out[to - off + (k mod off)],
// which equals the byte-serial definition and reads only bytes written before the token.
__device__ __forceinline__ void snappy_machine_any(const uint8_t* src, int64_t src_len,
                                                   int64_t comp_len, uint8_t* out,
                                                   int64_t out_cap, Token* queue,
                                                   int* counts, int64_t* dst_out,
                                                   bool* ok_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int64_t pos = 0, dst = 0, out_len = 0;  // the parser's state, in thread 0
  bool ok = true;
  if (threadIdx.x == 0) pos = snappy_preamble(src, src_len, comp_len, out_cap, &out_len, &ok);
  for (int round = 0;; ++round) {
    const int half = round & 1;
    if (warp == 0) {
      if (lane == 0) {
        Token* q = queue + half * kQueue;
        int n = 0;
        while (n < kQueue && pos < comp_len && dst < out_len && ok) {
          const uint32_t tag = clamped_byte(src, src_len, pos);
          const uint32_t b1 = clamped_byte(src, src_len, pos + 1);
          const uint32_t b2 = clamped_byte(src, src_len, pos + 2);
          const uint32_t b3 = clamped_byte(src, src_len, pos + 3);
          const uint32_t b4 = clamped_byte(src, src_len, pos + 4);
          Token tok;
          int64_t next_pos;
          bool good;
          decode_token(tag, b1, b2, b3, b4, pos, dst, comp_len, out_len, &tok, &next_pos,
                       &good);
          if (!good) {
            ok = false;
            break;
          }
          q[n++] = tok;
          pos = next_pos;
          dst += tok.len_kind & ~kCopyBit;
        }
        counts[half] = n;
      }
    } else if (round > 0) {
      const Token* q = queue + (half ^ 1) * kQueue;
      const int n = counts[half ^ 1];
      Token mine = {0, 0u, 0u};
      if (lane < n) mine = q[lane];
      for (int k = 0; k < n; ++k) {
        const int64_t a = shfl64(mine.a, k);
        const uint32_t to = __shfl_sync(kFullMask, mine.to, k);
        const uint32_t len_kind = __shfl_sync(kFullMask, mine.len_kind, k);
        const uint32_t len = len_kind & ~kCopyBit;
        if ((len_kind & kCopyBit) == 0) {
          for (uint32_t j = lane; j < len; j += 32) {
            out[to + j] = static_cast<uint8_t>(clamped_byte(src, src_len, a + j));
          }
        } else {
          // a copy is at most 64 bytes and 0 < off <= to: every byte read lies before `to`
          const uint32_t off = static_cast<uint32_t>(a);
          for (uint32_t j = lane; j < len; j += 32) {
            out[to + j] = out[to - off + (j < off ? j : j % off)];
          }
        }
        __syncwarp();  // this token's bytes are visible to the next token's reads
      }
    }
    pair_barrier();
    if (counts[half] == 0) break;  // nothing parsed this round: the last was executed
  }
  if (threadIdx.x == 0) {
    *dst_out = dst;
    *ok_out = ok && dst == out_len && pos == comp_len;
  }
}

// `len` bytes from device memory to shared memory, by the whole block: cp.async for the
// 16-byte chunks (`s` and `g` agree modulo 16), plain loads for the ragged ends.
__device__ __forceinline__ void stage_to_shared(uint8_t* s, const uint8_t* g, int64_t len) {
  const int64_t head_raw = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(g) & 15)) & 15;
  const int64_t head = head_raw < len ? head_raw : len;
  const int64_t body_end = head + ((len - head) & ~static_cast<int64_t>(15));
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) s[i] = g[i];
  for (int64_t c = head + 16 * static_cast<int64_t>(threadIdx.x); c < body_end;
       c += 16 * static_cast<int64_t>(blockDim.x)) {
    __pipeline_memcpy_async(s + c, g + c, 16);
  }
  for (int64_t i = body_end + threadIdx.x; i < len; i += blockDim.x) s[i] = g[i];
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// A page's output span [0, cap) in device memory, by the whole block: bytes below
// `dst` from the shared window `s` (or, when `s` is null, left as decoded in place),
// zeros from `dst` on; 16-byte stores where `g` is aligned (`s` agrees modulo 16).
__device__ __forceinline__ void store_window(uint8_t* g, const uint8_t* s, int64_t dst,
                                             int64_t cap) {
  const int64_t head_raw = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(g) & 15)) & 15;
  const int64_t head = head_raw < cap ? head_raw : cap;
  const int64_t body_end = head + ((cap - head) & ~static_cast<int64_t>(15));
  const int64_t first = s != nullptr ? 0 : dst;  // in place: only the zero tail
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) {
    if (i >= first) g[i] = i < dst ? s[i] : 0;
  }
  int64_t c0 = head + ((first > head ? (first - head) : 0) & ~static_cast<int64_t>(15));
  for (int64_t c = c0 + 16 * static_cast<int64_t>(threadIdx.x); c < body_end;
       c += 16 * static_cast<int64_t>(blockDim.x)) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c + 16 <= dst) {
      v = *reinterpret_cast<const uint4*>(s + c);
    } else if (c < dst) {  // the chunk that holds the last decoded byte
      uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
      for (int b = 0; b < 16; ++b) {
        vb[b] = c + b < dst ? (s != nullptr ? s[c + b] : g[c + b]) : 0;
      }
    }
    *reinterpret_cast<uint4*>(g + c) = v;
  }
  for (int64_t i = body_end + threadIdx.x; i < cap; i += blockDim.x) {
    if (i >= first) g[i] = i < dst ? s[i] : 0;
  }
}

__global__ void __launch_bounds__(kSnappyThreads)
snappy_ragged_kernel(const uint8_t* __restrict__ src, int64_t src_bytes,
                     const int64_t* __restrict__ table, uint8_t* out, int64_t out_bytes,
                     int32_t* __restrict__ ok_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int64_t s_dst;
  __shared__ int s_counts[2];
  const int64_t page = blockIdx.x;
  const int64_t* row = table + page * kTableCols;
  const int64_t src_off = row[0], src_len = row[1], comp_len = row[2];
  const int64_t dst_off = row[3], out_cap = row[4];
  const bool spans_ok = src_off >= 0 && src_len >= 0 && src_off <= src_bytes - src_len &&
                        dst_off >= 0 && out_cap >= 0 && dst_off <= out_bytes - out_cap;
  if (!spans_ok) {
    if (threadIdx.x == 0) ok_out[page] = 0;
    return;
  }
  const uint8_t* g_src = src + src_off;
  uint8_t* g_out = out + dst_off;
  const bool src_shared = src_len <= kSrcWindow;
  const bool out_shared = out_cap <= kOutWindow;
  Token* queue = reinterpret_cast<Token*>(smem);
  uint8_t* s_src = smem + kQueueBytes + (reinterpret_cast<uintptr_t>(g_src) & 15);
  uint8_t* s_out = smem + kQueueBytes + kSrcWindow + kSrcSlack +
                   (reinterpret_cast<uintptr_t>(g_out) & 15);
  if (src_shared) stage_to_shared(s_src, g_src, src_len);
  __syncthreads();
  if (threadIdx.x < 64) {
    int64_t dst = 0;
    bool ok = false;
    if (src_shared && out_shared && comp_len <= src_len) {
      snappy_machine_shared(s_src, src_len, comp_len, s_out, out_cap, queue, s_counts, &dst,
                            &ok);
    } else {
      snappy_machine_any(src_shared ? s_src : g_src, src_len, comp_len,
                         out_shared ? s_out : g_out, out_cap, queue, s_counts, &dst, &ok);
    }
    if (threadIdx.x == 0) {
      s_dst = dst;
      ok_out[page] = ok ? 1 : 0;
    }
  }
  __syncthreads();
  // every byte in [0, dst) was written by a good token; the rest of the span is zero
  store_window(g_out, out_shared ? s_out : nullptr, s_dst, out_cap);
}

// -- the batched run scan and K4 ---------------------------------------------------------
//
// Both take one row per data page of a batch (int64, kPageCols columns; the one-stream
// entry points pass one row). The page's bytes are [off, off + size) of one of two
// buffers: K3's output (buf 0) or the stored, UNCOMPRESSED pages (buf 1).

constexpr int kPageCols = 18;
enum PageCol {
  kBuf = 0,     // 0: K3's output, 1: the stored pages
  kOff,         // the page's first byte in that buffer
  kSize,        // the page's bytes; every read clamps to them
  kOkIdx,       // its row of K3's ok vector; -1 a stored page that is whole, -2 one that is not
  kMaxDef,      // 1: a definition-level block (4-byte length, then the block) comes first
  kEnc,         // kEncPlain, kEncDict or kEncIndices
  kNumValues,   // values in the page
  kItem,        // bytes a value: 4 or 8 (kEncIndices: 4)
  kDictBuf,     // where the dictionary's values lie (kEncDict)
  kDictOff,
  kDictN,       // values in the dictionary; -1: no dictionary page
  kRunOff,      // the page's first entry in the ragged run table
  kRunCap,      // the entries it may write there
  kMaxRuns,     // the reference's latch: more runs than this is a bad stream
  kStreamLen,   // the stream's length for the bound checks; -1: the bytes after its width
  kLo,          // the delivered values [lo, hi) of the page
  kHi,
  kDst,         // the output byte where value lo goes
};
enum Enc { kEncPlain = 0, kEncDict = 1, kEncIndices = 2 };
// a page's verdict: 0, or why the page is rejected (pagedec_kernels.REASONS)
enum Reason {
  kOk = 0,
  kInflate = 1,        // K3 latched ok = 0 on the page, or a stored page is not whole
  kShortLevel = 2,     // page too short for the level block's length
  kLevelPastEnd = 3,   // level block past page end
  kPlainShort = 4,     // PLAIN page shorter than its values
  kDictMissing = 5,    // dictionary page missing
  kEmptyBody = 6,      // empty dictionary-index body
  kRleLatched = 7,     // the run stream is bad, or its width is above 32
  kIndexRange = 8,     // a dictionary index out of range
};
constexpr int kScanPages = 32;  // pages a block of the scan, one thread each
constexpr int kMetaCols = 4;  // scan -> K4, per page: stream_off, bit_width, n_runs, verdict
constexpr int kValuesPerBlock = 1024;
constexpr int kValuesPerWarp = kValuesPerBlock / (kExtractThreads / 32);

struct Buffers {
  const uint8_t* k3_out;
  int64_t k3_bytes;
  const uint8_t* stored;
  int64_t stored_bytes;
};

// The page's span, or null when it leaves its buffer.
__device__ __forceinline__ const uint8_t* page_span(const Buffers& b, int64_t buf, int64_t off,
                                                    int64_t size) {
  const uint8_t* base = buf == 0 ? b.k3_out : b.stored;
  const int64_t bytes = buf == 0 ? b.k3_bytes : b.stored_bytes;
  if (!(off >= 0 && size >= 0 && off <= bytes - size)) return nullptr;
  return base + off;
}

// One page's checks and run walk, in the reference's order (_decode_window, then
// _rle_run_scan): returns the verdict and sets m = [stream_off, bit_width, n_runs].
__device__ int scan_page(const Buffers& b, const int64_t* row, const uint8_t* k3_ok,
                         int64_t n_ok, int4* runs, int64_t runs_total, int32_t* m) {
  const int64_t ok_idx = row[kOkIdx];
  if (ok_idx >= 0 ? (ok_idx >= n_ok || k3_ok[ok_idx] == 0) : ok_idx != -1) return kInflate;
  const int64_t size = row[kSize];
  const uint8_t* page = page_span(b, row[kBuf], row[kOff], size);
  if (page == nullptr) return kInflate;
  int64_t pos = 0;
  if (row[kMaxDef] != 0) {
    if (size < 4) return kShortLevel;
    const uint32_t head = page[0] | (page[1] << 8) | (page[2] << 16) |
                          (static_cast<uint32_t>(page[3]) << 24);
    pos = 4 + static_cast<int64_t>(head);
    if (pos > size) return kLevelPastEnd;
  }
  const int64_t enc = row[kEnc], total = row[kNumValues];
  if (enc == kEncPlain) {
    m[0] = static_cast<int32_t>(pos);
    return size - pos < total * row[kItem] ? kPlainShort : kOk;
  }
  if (enc == kEncDict && row[kDictN] < 0) return kDictMissing;
  if (size - pos < 1) return kEmptyBody;
  const int bit_width = page[pos];
  m[0] = static_cast<int32_t>(pos + 1);
  m[1] = bit_width;
  if (bit_width == 0) return kOk;  // every index 0
  if (bit_width > 32) return kRleLatched;
  const uint8_t* data = page + pos + 1;
  const int64_t cap = size - pos - 1;
  const int64_t data_len = row[kStreamLen] >= 0 ? row[kStreamLen] : cap;
  const int64_t run_off = row[kRunOff], run_cap = row[kRunCap], max_runs = row[kMaxRuns];
  const int byte_width = (bit_width + 7) / 8;
  int64_t p = 0, filled = 0, nruns = 0;
  bool ok = true;
  while (filled < total && ok) {
    uint32_t header = 0;
    int shift = 0;
    bool done = false;
    while (!done && ok) {
      const uint32_t c = clamped_byte(data, cap, p);
      if (shift < 32) header |= (c & 0x7Fu) << shift;
      done = (c & 0x80u) == 0;
      ok = ok && p < data_len && shift <= 28;
      ++p;
      shift += 7;
    }
    const int32_t h = static_cast<int32_t>(header);
    const bool packed = (h & 1) == 1;
    const int64_t groups = h >> 1;
    const int64_t count = packed ? groups * 8 : groups;
    const int64_t consumed = packed ? groups * bit_width : byte_width;
    uint32_t v = 0;
    for (int k = 0; !packed && k < byte_width; ++k) v |= clamped_byte(data, cap, p + k) << (8 * k);
    ok = ok && p + consumed <= data_len && count > 0 && nruns < max_runs;
    // the reference writes entry min(nruns, max_runs - 1); only entries that exist are kept
    const int64_t idx = nruns < max_runs ? nruns : max_runs - 1;
    if (run_off >= 0 && idx < run_cap && run_off + idx < runs_total) {
      const int64_t end = filled + count < total ? filled + count : total;
      runs[run_off + idx] = make_int4(static_cast<int32_t>(end), packed ? 1 : 0,
                                      packed ? 0 : static_cast<int32_t>(v),
                                      static_cast<int32_t>(p));
    }
    p += consumed;
    filled += count;
    ++nruns;
  }
  m[2] = static_cast<int32_t>(nruns < INT32_MAX ? nruns : INT32_MAX);
  return ok && filled >= total ? kOk : kRleLatched;
}

// One thread a page, kScanPages pages a block: a stream's run headers are a dependent
// chain of loads (from L2, where K3 has just written the bytes), so the walk is
// latency-bound; every page of the batch walks side by side.
__global__ void __launch_bounds__(kScanPages)
rle_scan_pages_kernel(Buffers b, const int64_t* __restrict__ pages, int64_t n_pages,
                      const uint8_t* __restrict__ k3_ok, int64_t n_ok, int4* runs,
                      int64_t runs_total, int32_t* __restrict__ meta,
                      int32_t* __restrict__ flags) {
  const int64_t page = static_cast<int64_t>(blockIdx.x) * kScanPages + threadIdx.x;
  if (page >= n_pages) return;
  int32_t m[3] = {0, 0, 0};
  const int reason = scan_page(b, pages + page * kPageCols, k3_ok, n_ok, runs, runs_total, m);
  int32_t* out = meta + page * kMetaCols;
  out[0] = m[0];
  out[1] = m[1];
  out[2] = m[2];
  out[3] = reason;
  flags[page] = reason;
}

// `item` bytes (4 or 8) at `p`, little-endian, by word where aligned, else byte by byte
__device__ __forceinline__ uint64_t load_item(const uint8_t* p, int item) {
  if ((reinterpret_cast<uintptr_t>(p) & (item - 1)) == 0) {
    return item == 8 ? *reinterpret_cast<const uint64_t*>(p)
                     : *reinterpret_cast<const uint32_t*>(p);
  }
  uint64_t v = 0;
  for (int k = 0; k < item; ++k) v |= static_cast<uint64_t>(p[k]) << (8 * k);
  return v;
}

__device__ __forceinline__ void store_item(uint8_t* p, int item, uint64_t v) {
  if (item == 8) {
    *reinterpret_cast<uint64_t*>(p) = v;
  } else {
    *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(v);
  }
}

// K4 over every data page of a batch: a block takes up to kValuesPerBlock values of one
// page (blocks[i] = [page, first value]), a warp kValuesPerWarp consecutive ones.
// - A dictionary page: lane 0 finds the warp's first run among the page's real runs (a
//   binary search of run_end), each lane walks on from there to its value's run; then
//   the 5-byte little-endian window, clamped to the stream, and (word >> shift) & mask,
//   or the run's RLE value; then 0 <= index < dict_n (the page's flag latches
//   kIndexRange where it fails) and the dictionary value's 4 or 8 bytes straight into
//   the output at the value's row. Every value of the page is checked (as the
//   reference checks the whole page), only [lo, hi) is written.
// - A PLAIN page: the item bytes of [lo, hi) from the stream offset the scan found.
// - kEncIndices (the one-stream entry points): the int32 index itself.
// A page whose scan verdict is not 0, or whose run entries leave the run table, writes
// zeros and reads nothing. Bytes: the stream,
// the run entries, the dictionary values gathered, the delivered values written; bound
// by the latency of a few dependent L1/L2 loads a warp, not by bytes.
__global__ void __launch_bounds__(kExtractThreads)
extract_pages_kernel(Buffers b, const int64_t* __restrict__ pages, int64_t n_pages,
                     const int32_t* __restrict__ blocks, const int4* __restrict__ runs,
                     int64_t runs_total, const int32_t* __restrict__ meta,
                     int32_t* flags, uint8_t* __restrict__ out, int64_t out_bytes) {
  const int32_t page = blocks[2 * static_cast<int64_t>(blockIdx.x)];
  const int64_t first = blocks[2 * static_cast<int64_t>(blockIdx.x) + 1];
  if (page < 0 || page >= n_pages) return;
  const int64_t* row = pages + static_cast<int64_t>(page) * kPageCols;
  const int32_t* m = meta + static_cast<int64_t>(page) * kMetaCols;
  const int64_t enc = row[kEnc], total = row[kNumValues], lo = row[kLo], hi = row[kHi];
  const int item = static_cast<int>(row[kItem]);
  const int64_t dst = row[kDst];
  if (!((item == 4 || item == 8) && lo >= 0 && lo <= hi && hi <= total && dst >= 0 &&
        dst % item == 0 && dst <= out_bytes - (hi - lo) * item)) {
    return;  // a row whose output span leaves the buffer writes nothing
  }
  const int64_t limit = enc == kEncPlain ? hi : total;
  const int64_t end = first + kValuesPerBlock < limit ? first + kValuesPerBlock : limit;
  const int64_t size = row[kSize];
  const uint8_t* bytes = page_span(b, row[kBuf], row[kOff], size);
  const int64_t stream_off = m[0];
  const int bit_width = m[1];
  int64_t n_runs = m[2];
  n_runs = n_runs < row[kRunCap] ? n_runs : row[kRunCap];
  n_runs = n_runs < row[kMaxRuns] ? n_runs : row[kMaxRuns];
  const int64_t run_off = row[kRunOff];
  // a dictionary page's run entries must lie in the run table
  const bool runs_in = enc == kEncPlain || bit_width == 0 ||
                       (n_runs >= 1 && run_off >= 0 && run_off <= runs_total - n_runs);
  const bool readable = bytes != nullptr && stream_off >= 0 && stream_off <= size && runs_in;
  if (m[3] != kOk || !readable) {
    for (int64_t v = first + threadIdx.x; v < end; v += blockDim.x) {
      if (v >= lo && v < hi) store_item(out + dst + (v - lo) * item, item, 0);
    }
    return;
  }
  if (enc == kEncPlain) {
    for (int64_t v = first + threadIdx.x; v < end; v += blockDim.x) {
      if (v >= lo) {
        store_item(out + dst + (v - lo) * item, item,
                   load_item(bytes + stream_off + v * item, item));
      }
    }
    return;
  }
  const uint8_t* data = bytes + stream_off;
  const int64_t cap = size - stream_off;
  const int4* r = runs + run_off;
  const uint64_t mask = bit_width >= 32 ? 0xFFFFFFFFull : (1ull << bit_width) - 1ull;
  const uint8_t* dict = nullptr;
  int64_t dict_n = 0;
  if (enc == kEncDict) {
    dict_n = row[kDictN] > 0 ? row[kDictN] : 0;
    dict = page_span(b, row[kDictBuf], row[kDictOff], dict_n * item);
    if (dict == nullptr) dict_n = 0;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t v0 = first + static_cast<int64_t>(warp) * kValuesPerWarp;
  int64_t rid = 0;
  if (bit_width > 0 && v0 < end) {  // one search a warp: the first run whose end is > v0
    if (lane == 0) {
      int64_t a = 0, z = n_runs;
      while (a < z) {
        const int64_t mid = (a + z) >> 1;
        if (r[mid].x <= v0) {
          a = mid + 1;
        } else {
          z = mid;
        }
      }
      rid = a < n_runs ? a : n_runs - 1;
    }
    rid = shfl64(rid, 0);
  }
  bool bad = false;
  for (int64_t v = v0 + lane; v < v0 + kValuesPerWarp; v += 32) {
    if (v >= end) break;
    uint32_t idx = 0;
    if (bit_width > 0) {
      // a walk: an RLE run holds 1 or more values and a packed run 8 or more, so a
      // lane's walk takes at most the warp's kValuesPerWarp steps
      while (rid < n_runs - 1 && r[rid].x <= v) ++rid;
      const int4 e = r[rid];
      if (e.y == 0) {
        idx = static_cast<uint32_t>(e.z);
      } else {
        const int64_t run_start = rid == 0 ? 0 : r[rid - 1].x;
        const int64_t bitpos = static_cast<int64_t>(static_cast<uint32_t>(e.w)) * 8 +
                               (v - run_start) * bit_width;
        const int64_t byte_off = bitpos >> 3;
        uint64_t word = 0;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          word |= static_cast<uint64_t>(clamped_byte(data, cap, byte_off + j)) << (8 * j);
        }
        idx = static_cast<uint32_t>((word >> (bitpos & 7)) & mask);
      }
    }
    const bool delivered = v >= lo && v < hi;
    if (enc == kEncIndices) {
      if (delivered) store_item(out + dst + (v - lo) * item, item, idx);
      continue;
    }
    const int32_t si = static_cast<int32_t>(idx);
    const bool in_range = si >= 0 && si < dict_n;
    bad = bad || !in_range;
    if (delivered) {
      store_item(out + dst + (v - lo) * item, item,
                 in_range ? load_item(dict + static_cast<int64_t>(si) * item, item) : 0);
    }
  }
  if (__any_sync(kFullMask, bad) && lane == 0) flags[page] = kIndexRange;
}

}  // namespace

extern "C" {

// One launch over a batch of snappy pages packed back to back. src: (src_bytes,) uint8;
// table: (n_pages, 5) int64 rows [src_off, src_len, comp_len, dst_off, out_cap]; out:
// (out_bytes,) uint8, of which each page writes exactly its [dst_off, dst_off + out_cap)
// span (decoded bytes, then zeros); ok: (n_pages,) int32 (1 = the page decoded exactly).
// All on CUDA device `device`; launches on `stream` and returns the cudaError_t of the
// launch (0 = cudaSuccess).
int ptpu_snappy_ragged(const void* src, int64_t src_bytes, const void* table, void* out,
                       int64_t out_bytes, void* ok, int64_t n_pages, int device,
                       void* stream) {
  if (n_pages < 0 || n_pages > INT32_MAX || src_bytes < 0 || out_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pages == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(snappy_ragged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSnappySmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  snappy_ragged_kernel<<<static_cast<unsigned>(n_pages), kSnappyThreads, kSnappySmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), src_bytes, static_cast<const int64_t*>(table),
      static_cast<uint8_t*>(out), out_bytes, static_cast<int32_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// The run scan over a batch's data pages, one launch. k3_out (k3_bytes,) uint8 and
// stored (stored_bytes,) uint8: the pages' bytes; pages: (n_pages, 18) int64 rows (see
// PageCol); k3_ok: (n_ok,) bool, K3's ok flags. Writes each page's run entries (int32
// [run_end, is_packed, rle_value, byte_pos]) into runs (runs_total, 4), only those that
// exist; meta (n_pages, 4) int32 [stream_off, bit_width, n_runs, verdict]; flags
// (n_pages,) int32, the verdict.
int ptpu_rle_scan_pages(const void* k3_out, int64_t k3_bytes, const void* stored,
                        int64_t stored_bytes, const void* pages, int64_t n_pages,
                        const void* k3_ok, int64_t n_ok, void* runs, int64_t runs_total,
                        void* meta, void* flags, int device, void* stream) {
  if (n_pages < 0 || n_pages > INT32_MAX || k3_bytes < 0 || stored_bytes < 0 || n_ok < 0 ||
      runs_total < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pages == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Buffers b = {static_cast<const uint8_t*>(k3_out), k3_bytes,
                     static_cast<const uint8_t*>(stored), stored_bytes};
  rle_scan_pages_kernel<<<static_cast<unsigned>((n_pages + kScanPages - 1) / kScanPages),
                          kScanPages, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const int64_t*>(pages), n_pages, static_cast<const uint8_t*>(k3_ok), n_ok,
      static_cast<int4*>(runs), runs_total, static_cast<int32_t*>(meta),
      static_cast<int32_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// K4 over a batch's data pages, one launch: blocks (n_blocks, 2) int32 [page, first
// value]; runs, meta and flags from ptpu_rle_scan_pages (flags latch kIndexRange in
// place); out (out_bytes,) uint8, each page's delivered values at its dst.
int ptpu_extract_pages(const void* k3_out, int64_t k3_bytes, const void* stored,
                       int64_t stored_bytes, const void* pages, int64_t n_pages,
                       const void* blocks, int64_t n_blocks, const void* runs,
                       int64_t runs_total, const void* meta, void* flags, void* out,
                       int64_t out_bytes, int device, void* stream) {
  if (n_pages < 0 || n_pages > INT32_MAX || n_blocks < 0 || n_blocks > INT32_MAX ||
      k3_bytes < 0 || stored_bytes < 0 || runs_total < 0 || out_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_blocks == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Buffers b = {static_cast<const uint8_t*>(k3_out), k3_bytes,
                     static_cast<const uint8_t*>(stored), stored_bytes};
  extract_pages_kernel<<<static_cast<unsigned>(n_blocks), kExtractThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const int64_t*>(pages), n_pages, static_cast<const int32_t*>(blocks),
      static_cast<const int4*>(runs), runs_total, static_cast<const int32_t*>(meta),
      static_cast<int32_t*>(flags), static_cast<uint8_t*>(out), out_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
