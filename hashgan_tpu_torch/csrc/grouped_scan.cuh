// The scan skeleton of kernels 2, 5, 6 and 7 (mxu_fullkey_scan.cu,
// subgroupmin_scan.cu, groupmin_scan.cu, groupmin_min2.cu): packed queries
// against the grouped (W, L, C) gallery on the int8 tensor cores. Each
// kernel keeps only its epilogue, the reduction of the local keys this walk
// hands it. Kernel 9 (fullkey_scan_mma.cu) keeps its own f16 arithmetic and
// shares the staging, the tiling, the lane map, the stores and the launch.
//
// The gallery is the grouped layout: item idx = s*C + c is word w at
// [w, s, c]. Within a column every engine orders items by
//   (padding?, distance d, row s),   padding where idx >= valid_n,
// and the scans keep that order in one int, the local key
// pad<<30 | d<<16 | s (d <= 256, s < 65536), so a plain integer min picks
// the item each engine's TPU kernel picks from its own key (d*L + s + 2^22
// in float32, or d*stride + idx + PAD_BASE in int32: inside a column both
// order the same way).
//
// Design, with mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (exact int32 sums
// dot = B - 2d of +-1 bytes):
// - A block covers a strip of kCols columns and 8 warps of queries; a warp
//   owns MT m-tiles of 16 queries. It builds its +-1 A fragments once from
//   the packed words (bit j of word w is byte j of k-step w) and keeps them
//   in registers.
// - Items go along N: n-tile t holds columns 8t .. 8t+7 of the strip in ONE
//   row s, and the block walks s = 0 .. L-1. An accumulator element keeps
//   its column for the whole walk, so an epilogue's minima are running
//   register values: no shuffles.
// - Chunks of kChunkWords / W rows are copied with cp.async (the next chunk
//   is in flight while this one is used), unpacked once into +-1 s8 B
//   fragments in shared memory, in fragment order (4 bits of one item
//   become the 4 bytes of one register), and every warp reads its B
//   fragment with one conflict-free 8-byte load per lane. A chunk is 64
//   words a column (160 KB of shared memory with its fragments and the
//   second buffer): each costs two block barriers, so larger chunks ran
//   faster, and one block an SM is all the registers allow anyway.
// - The local key: since d<<16 = (B - dot)<<15 it is
//   (B<<15 | s | pad) - dot*32768, one IMAD per element. The pad flag is
//   uniform over the strip except in the one row where s*C + c crosses
//   valid_n; only that row takes the per-element path (kMixed).
// - Columns past C are zero-filled and never stored; query rows past nq are
//   zero A rows, and warps past nq skip the products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gscan {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;         // columns per block (strip)
constexpr int kNT = kCols / 8;    // mma n-tiles per strip
constexpr int kChunkWords = 64;   // rows s x words W per staged chunk
constexpr int kNone = 0x7fffffff;
constexpr int kPadFlag = 1 << 30;

template <int W, int MT>
struct Tiling {
  static constexpr int kQueries = kWarps * 16 * MT;  // queries a block
  static constexpr int kRows = kChunkWords / W;      // rows s a chunk
  static constexpr int kPackedWords = kRows * W * kCols;  // one buffer
  // two packed buffers and the B fragments (8 bytes a lane, 32 lanes an
  // (s, n-tile, k-step))
  static constexpr int kSmem = 2 * kPackedWords * 4 + kPackedWords * 32;
};

__device__ __forceinline__ bool local_is_pad(int key) {
  return (key & kPadFlag) != 0;
}
__device__ __forceinline__ int local_d(int key) { return (key >> 16) & 0x3fff; }
__device__ __forceinline__ int local_s(int key) { return key & 0xffff; }

// Bits 0..3 of x as four +-1 bytes (+1 where the bit is set), bit 0 in the
// lowest byte.
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t x) {
  const uint32_t m = ((x & 0xFu) * 0x00204081u) & 0x01010101u;
  return ~(m * 0xFEu);
}

// d += a * b: one 16x8x32 product, s8 operands, s32 accumulator.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One asynchronous copy of 16 or 4 bytes into shared memory; zero-filled
// when ``valid`` is false (src is then not read).
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool wide,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Rows s0 .. s0+ns-1 of the strip's words -> packed[(sl*W + w)*kCols + col],
// in 16-byte copies (``wide``) or 4-byte ones, columns past C zero-filled.
template <int W>
__device__ __forceinline__ void stage_chunk(uint32_t* packed,
                                            const int32_t* __restrict__ g,
                                            int L, int C, int c0, int s0,
                                            int ns, bool wide) {
  const int per = wide ? 4 : 1;  // words a copy
  const int n_copies = ns * W * (kCols / per);
  for (int i = threadIdx.x; i < n_copies; i += kThreads) {
    const int col = (i % (kCols / per)) * per, row = i / (kCols / per);
    const int sl = row / W, w = row % W;
    const int c = c0 + col;
    const bool ok = c < C;
    cp_async(packed + row * kCols + col,
             g + (static_cast<int64_t>(w) * L + s0 + sl) * C + (ok ? c : 0),
             wide, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The packed words of ns rows -> B fragments: frag[((sl*kNT + t)*W + k)*32
// + lane] holds, for column 8t + lane/4, bits 4(lane%4) + 0..3 (x) and
// 16 + 4(lane%4) + 0..3 (y) of word k as +-1 bytes.
template <int W>
__device__ __forceinline__ void unpack_chunk(const uint32_t* packed,
                                             uint2* frag, int ns) {
  for (int e = threadIdx.x; e < ns * kNT * W * 32; e += kThreads) {
    const int lane = e & 31, blk = e >> 5;
    const int k = blk % W, t = (blk / W) % kNT, sl = blk / (W * kNT);
    const uint32_t x =
        packed[(sl * W + k) * kCols + 8 * t + (lane >> 2)] >> (4 * (lane & 3));
    frag[e] = make_uint2(pm1_nibble(x), pm1_nibble(x >> 16));
  }
}

// Valid rows of column c: items s*C + c < valid_n for s < rows_of(c).
__device__ __forceinline__ int rows_of(int c, int C, int L, int valid_n) {
  return (c < C && valid_n > c) ? min(L, (valid_n - c + C - 1) / C) : 0;
}

// Where this thread's accumulator elements sit: element r of n-tile t of
// m-tile m is query q_base + 16m + grp + 8(r/2), column col_lane + 8t + r%2.
template <int MT>
struct Lanes {
  int q_base, grp, col_lane;
  __device__ __forceinline__ Lanes()
      : q_base(blockIdx.y * kWarps * 16 * MT + (threadIdx.x >> 5) * 16 * MT),
        grp((threadIdx.x & 31) >> 2),
        col_lane(blockIdx.x * kCols + 2 * (threadIdx.x & 3)) {}
  __device__ __forceinline__ int query(int m, int h) const {
    return q_base + 16 * m + grp + 8 * h;
  }
};

// One row s for every n-tile: the products, then epi.key(m, t, r, local key)
// for each accumulator element. kMixed: the row where the strip crosses
// valid_n, padded per element.
template <int W, int MT, bool kMixed, class Epi>
__device__ __forceinline__ void row_step(const uint2* frag,
                                         const uint32_t (&a)[MT][W][4],
                                         int sl, int s, int key_s,
                                         int col_lane, int C, int valid_n,
                                         Epi& epi) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    int32_t acc[MT][4] = {};
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint2 b = frag[((sl * kNT + t) * W + k) * 32 + lane];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_s8(acc[m], a[m][k], b);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int key = key_s - acc[m][r] * 32768;
        if (kMixed) {
          const int c = col_lane + 8 * t + (r & 1);
          if (s * C + c >= valid_n) key |= kPadFlag;
        }
        epi.key(m, t, r, key);
      }
  }
}

// The walk over the block's strip: epi.init() once the A fragments are
// built, then every row s = 0 .. L-1 in order, each element's local key to
// epi.key, then epi.row_done(s). Returns whether this warp holds any query
// (inactive warps see no key and no row_done). Where an epilogue keeps its
// running values, as member arrays or as references to arrays the kernel
// declares, changes ptxas's register allocation near the 255-register
// limit: on the H100, kernel 7 ran 9% slower with member arrays, kernel 5
// 8% slower with references (and spilled at W = 8). Each keeps the faster.
template <int W, int MT, class Epi>
__device__ __forceinline__ bool walk_strip(const int32_t* __restrict__ q,
                                           const int32_t* __restrict__ gallery,
                                           int nq, int L, int C, int valid_n,
                                           bool wide, const Lanes<MT>& ln,
                                           Epi& epi) {
  using T = Tiling<W, MT>;
  constexpr int kRows = T::kRows;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* packed = smem;  // 2 buffers
  uint2* frag = reinterpret_cast<uint2*>(smem + 2 * T::kPackedWords);
  const int tig = threadIdx.x & 3;
  const int c0 = blockIdx.x * kCols;
  const bool active = ln.q_base < nq;

  // A fragments: rows grp and grp+8 of each m-tile; register j of k-step w
  // holds bits 4tig + 0..3 (j = 0, 1) or 16 + 4tig + 0..3 (j = 2, 3)
  uint32_t a[MT][W][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = ln.query(m, 0), r1 = ln.query(m, 1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t x0 =
          r0 < nq ? static_cast<uint32_t>(q[static_cast<int64_t>(r0) * W + w]) >>
                        (4 * tig)
                  : 0u;
      const uint32_t x1 =
          r1 < nq ? static_cast<uint32_t>(q[static_cast<int64_t>(r1) * W + w]) >>
                        (4 * tig)
                  : 0u;
      a[m][w][0] = pm1_nibble(x0);
      a[m][w][1] = pm1_nibble(x1);
      a[m][w][2] = pm1_nibble(x0 >> 16);
      a[m][w][3] = pm1_nibble(x1 >> 16);
    }
  }
  epi.init();

  // rows s < s_full hold no padding in the strip, rows s >= s_pad only
  // padding; at most one row lies between
  const int s_full = rows_of(min(c0 + kCols, C) - 1, C, L, valid_n);
  const int s_pad = rows_of(c0, C, L, valid_n);
  const int key_base = (32 * W) << 15;

  const int n_chunks = (L + kRows - 1) / kRows;
  stage_chunk<W>(packed, gallery, L, C, c0, 0, min(kRows, L), wide);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * kRows, ns = min(kRows, L - s0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // every thread is past the last chunk's products: the other buffer and
    // the fragments may be overwritten
    __syncthreads();
    if (ci + 1 < n_chunks)
      stage_chunk<W>(packed + ((ci + 1) & 1) * T::kPackedWords, gallery, L,
                     C, c0, s0 + kRows, min(kRows, L - s0 - kRows), wide);
    unpack_chunk<W>(packed + (ci & 1) * T::kPackedWords, frag, ns);
    __syncthreads();
    if (!active) continue;
    for (int sl = 0; sl < ns; ++sl) {
      const int s = s0 + sl;
      const int key_s = key_base + s + (s >= s_pad ? kPadFlag : 0);
      if (s < s_full || s >= s_pad)
        row_step<W, MT, false>(frag, a, sl, s, key_s, ln.col_lane, C,
                               valid_n, epi);
      else
        row_step<W, MT, true>(frag, a, sl, s, key_s, ln.col_lane, C,
                              valid_n, epi);
      epi.row_done(s);
    }
  }
  return active;
}

// The epilogue of kernels 2 and 6: one running minimum of the local key per
// accumulator element, in arrays the kernel declares.
template <int MT>
struct Min1 {
  int (&b1)[MT][kNT][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) b1[m][t][r] = kNone;
  }
  __device__ __forceinline__ void key(int m, int t, int r, int k) {
    b1[m][t][r] = min(b1[m][t][r], k);
  }
  __device__ __forceinline__ void row_done(int) {}
};

// A lane's two adjacent columns c, c + 1 (c even) of one output row: one
// 8-byte store where C is even (c < C then puts c + 1 in too), else a
// 4-byte store for each column below C. kStream: evict-first (__stcs), so
// a large output does not push the staged gallery out of L2.
template <bool kStream, class T>
__device__ __forceinline__ void store_pair(T* row, int c, int C, T v0, T v1) {
  using T2 = std::conditional_t<std::is_same<T, float>::value, float2, int2>;
  if ((C & 1) == 0) {
    if (c >= C) return;
    T2* p = reinterpret_cast<T2*>(row + c);
    if (kStream)
      __stcs(p, T2{v0, v1});
    else
      *p = T2{v0, v1};
    return;
  }
  if (c < C) row[c] = v0;
  if (c + 1 < C) row[c + 1] = v1;
}

// Launches kernel<<<(strips, query blocks), kThreads, smem>>>(args...) at
// the tiling T after raising its dynamic shared memory limit; returns the
// CUDA error.
template <class T, class... P, class... A>
int launch(void (*kernel)(P...), int nq, int C, cudaStream_t stream,
           A... args) {
  constexpr int smem = T::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kCols - 1) / kCols,
                  (nq + T::kQueries - 1) / T::kQueries);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte staging copies where every (w, s) row of the gallery is 16-byte
// aligned.
inline bool wide_rows(const void* g, int C) {
  return C % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
}

// f(std::integral_constant<int, W>{}) for a runtime word count 1..8; any
// other count is cudaErrorInvalidValue.
template <class F>
int dispatch_words(int W, F&& f) {
  switch (W) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gscan
