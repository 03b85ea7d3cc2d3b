// Min and second-min scan of the repair engine: for every (query, column c)
// of the grouped (W, L, C) gallery, the smallest and the second-smallest of
// the column's composite keys
//   d * stride + idx (+ PAD_BASE when idx >= valid_n),   idx = s*C + c,
// INT32_MAX for the second when the column has one item. Keys are distinct
// (idx is), so min2 is the second-smallest key. Padding items stay
// candidates (with the pad flag): a column of padding returns padding keys.
//
// Replaces: hashgan_tpu/ops/groupmin.py, groupmin_scan -> _groupmin_kernel
// (line 97), which XORs and popcounts (Tq, L, Cb) tiles on the VPU, adds a
// precomputed (L, C) addend and reduces twice over sublanes. Here the addend
// is computed from valid_n and both minima come out of one pass.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations (35 us for 256 queries x 1M items x 128 bits at 1,979
// TOP/s); the packed gallery (16 MB at that shape) stays in the 50 MB L2 and
// the two (Q, C) outputs are 16 MB. After the products, each (query, item)
// key costs about four integer operations (an IMAD and three min/max), which
// is what holds this kernel.
//
// Design, on the tensor cores with mma.sync.m16n8k32.row.col.s32.s8.s8.s32
// (exact int32 sums dot = B - 2d of +-1 bytes):
// - A block covers a strip of kCols columns and 8 warps of queries; a warp
//   owns MT m-tiles of 16 queries (2 for W <= 4, so 256 queries a block, 1
//   above). It builds its +-1 A fragments once from the packed words (bit j
//   of word w is byte j of k-step w) and keeps them in registers.
// - Items go along N: n-tile t holds columns 8t .. 8t+7 of the strip in ONE
//   group row s, and the block walks s = 0 .. L-1. An accumulator element
//   keeps its column for the whole walk, so min and min2 are running
//   register values: no shuffles.
// - Chunks of kChunkWords / W rows s are copied with cp.async (the next
//   chunk is in flight while this one is used), unpacked once into +-1 s8 B
//   fragments in shared memory, in fragment order (4 bits of one item become
//   the 4 bytes of one register), and every warp reads its B fragment with
//   one conflict-free 8-byte load per lane. A chunk is 64 words a column
//   (160 KB of shared memory with its fragments and the second buffer): on
//   the H100 larger chunks ran faster, since each costs two block barriers,
//   and one block an SM is all the registers allow anyway (up to 253 a
//   thread at W = 4).
// - The local key pad<<30 | d<<16 | s orders a column as the composite key
//   does. Since d<<16 = (B - dot)<<15 it is (B<<15 | s | pad) - dot*32768:
//   one IMAD per element, then b2 = min(b2, max(b1, key)), b1 = min(b1,
//   key). The pad flag is uniform over the strip except in the one row
//   where s*C + c crosses valid_n; only that row takes the per-element path.
//   The composite keys are formed once at the end.
// - Columns past C are zero-filled and never stored; query rows past nq are
//   zero A rows, and warps past nq skip the products.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;         // columns per block (strip)
constexpr int kNT = kCols / 8;    // mma n-tiles per strip
constexpr int kChunkWords = 64;   // rows s x words W per staged chunk
constexpr int kNone = 0x7fffffff;
constexpr int kPadFlag = 1 << 30;
constexpr int kPadBase = 1000000000;

template <int W>
struct Tiling {
  static constexpr int MT = W <= 4 ? 2 : 1;          // m-tiles a warp
  static constexpr int kQueries = kWarps * 16 * MT;  // queries a block
  static constexpr int kRows = kChunkWords / W;      // rows s a chunk
  static constexpr int kPackedWords = kRows * W * kCols;  // one buffer
  // two packed buffers and the B fragments (8 bytes a lane, 32 lanes an
  // (s, n-tile, k-step))
  static constexpr int kSmem = 2 * kPackedWords * 4 + kPackedWords * 32;
};

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

// One group row s for every n-tile: the products, then the running minima.
// kMixed: the row where the strip crosses valid_n, padded per element.
template <int W, bool kMixed>
__device__ __forceinline__ void row_step(
    const uint2* frag, uint32_t (&a)[Tiling<W>::MT][W][4],
    int (&b1)[Tiling<W>::MT][kNT][4], int (&b2)[Tiling<W>::MT][kNT][4],
    int sl, int s, int key_s, int col_lane, int C, int valid_n) {
  constexpr int MT = Tiling<W>::MT;
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
        b2[m][t][r] = min(b2[m][t][r], max(b1[m][t][r], key));
        b1[m][t][r] = min(b1[m][t][r], key);
      }
  }
}

// Valid rows of column c: items s*C + c < valid_n for s < rows_of(c).
__device__ __forceinline__ int rows_of(int c, int C, int L, int valid_n) {
  return (c < C && valid_n > c) ? min(L, (valid_n - c + C - 1) / C) : 0;
}

__device__ __forceinline__ int composite(int local, int stride, int C, int c) {
  if (local == kNone) return kNone;
  return ((local >> 16) & 0x3fff) * stride + (local & 0xffff) * C + c +
         ((local & kPadFlag) ? kPadBase : 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
groupmin_min2_mma_kernel(const int32_t* __restrict__ q,
                         const int32_t* __restrict__ gallery,
                         int32_t* __restrict__ min1, int32_t* __restrict__ min2,
                         int nq, int L, int C, int valid_n, int stride,
                         bool wide) {
  using T = Tiling<W>;
  constexpr int MT = T::MT;
  constexpr int kRows = T::kRows;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* packed = smem;  // 2 buffers
  uint2* frag = reinterpret_cast<uint2*>(smem + 2 * T::kPackedWords);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kCols;
  const int q_base = blockIdx.y * T::kQueries + warp * 16 * MT;
  const bool active = q_base < nq;

  // A fragments: rows grp and grp+8 of each m-tile; register j of k-step w
  // holds bits 4tig + 0..3 (j = 0, 1) or 16 + 4tig + 0..3 (j = 2, 3)
  uint32_t a[MT][W][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = q_base + m * 16 + grp, r1 = r0 + 8;
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

  // accumulator element r of n-tile t: query row grp + 8(r/2), column
  // col_lane + 8t + r%2 of the strip
  int b1[MT][kNT][4], b2[MT][kNT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) b1[m][t][r] = b2[m][t][r] = kNone;
  const int col_lane = c0 + 2 * tig;

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
        row_step<W, false>(frag, a, b1, b2, sl, s, key_s, col_lane, C, valid_n);
      else
        row_step<W, true>(frag, a, b1, b2, sl, s, key_s, col_lane, C, valid_n);
    }
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q_base + m * 16 + grp + 8 * h;
      if (qi >= nq) continue;
      const int64_t row = static_cast<int64_t>(qi) * C;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int c = col_lane + 8 * t;
        const int k1[2] = {composite(b1[m][t][2 * h], stride, C, c),
                           composite(b1[m][t][2 * h + 1], stride, C, c + 1)};
        const int k2[2] = {composite(b2[m][t][2 * h], stride, C, c),
                           composite(b2[m][t][2 * h + 1], stride, C, c + 1)};
        if ((C & 1) == 0) {  // c even: c < C puts c + 1 in too
          if (c < C) {
            *reinterpret_cast<int2*>(min1 + row + c) = make_int2(k1[0], k1[1]);
            *reinterpret_cast<int2*>(min2 + row + c) = make_int2(k2[0], k2[1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (c + j < C) {
              min1[row + c + j] = k1[j];
              min2[row + c + j] = k2[j];
            }
        }
      }
    }
}

template <int W>
int launch(const int32_t* q, const int32_t* g, int32_t* min1, int32_t* min2,
           int nq, int L, int C, int valid_n, int stride, cudaStream_t stream) {
  constexpr int smem = Tiling<W>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        groupmin_min2_mma_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte copies where every (w, s) row of the gallery is 16-byte aligned
  const bool wide = C % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const dim3 grid((C + kCols - 1) / kCols,
                  (nq + Tiling<W>::kQueries - 1) / Tiling<W>::kQueries);
  groupmin_min2_mma_kernel<W><<<grid, kThreads, smem, stream>>>(
      q, g, min1, min2, nq, L, C, valid_n, stride, wide);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); min1, min2 (nq, C). The
// caller guarantees 1 <= W <= 8, L <= 65536, nq <= 65535 * 128 and
// (32W + 1) * stride + L*C < PAD_BASE.
extern "C" int hg_groupmin_min2(const void* q, const void* gallery,
                                void* min1, void* min2, int nq, int W, int L,
                                int C, int valid_n, int stride, void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* gp = static_cast<const int32_t*>(gallery);
  auto* m1 = static_cast<int32_t*>(min1);
  auto* m2 = static_cast<int32_t*>(min2);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch<1>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 2: return launch<2>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 3: return launch<3>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 4: return launch<4>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 5: return launch<5>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 6: return launch<6>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 7: return launch<7>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    case 8: return launch<8>(qp, gp, m1, m2, nq, L, C, valid_n, stride, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
