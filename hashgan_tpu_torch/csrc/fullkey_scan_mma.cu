// Exact full-key scan on the f16 tensor cores: per (query, column) the
// smallest composite key
//   d * stride + s * C + c
// over the column's items s with s*C + c < valid_n (d = Hamming distance,
// stride = L*C + 1); INT32_MAX when the column holds no valid item. The same
// function as mxu_fullkey_scan.cu; only the arithmetic differs.
//
// Replaces: scripts/bench_scan_variants.py, fullkey_scan_bf16 ->
// _fullkey_kernel_bf16 (line 46), the TPU experiment of emitting the scan's
// +-1 matmul with a 16-bit accumulator. Mosaic refused the bf16 accumulator
// on the TPU. Hopper's tensor cores give bf16 operands only a float32
// accumulator, but take f16 operands with an f16 accumulator
// (mma.sync.m16n8k16.f16.f16.f16.f16), the card's narrow-accumulator
// product. It is exact: every partial sum of +-1 products over B <= 256 bits
// is an integer of magnitude <= 256, and f16 holds integers exactly up to
// 2048.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations (35 us for 256 queries x 1M items x 128 bits at 1,979
// TOP/s); the f16 products run at half that rate. Gallery bytes (16 MB at
// 1M x 128 bits) stay L2-resident.
//
// Design: the walk of grouped_scan.cuh with f16 operands.
// - A block covers a 64-column strip (kNT = 8 n-tiles of 8) and 8 warps of
//   queries; a warp owns MT m-tiles of 16 queries (2 for W <= 4, 1 above),
//   whose +-1 f16 A fragments it builds once from the packed words and keeps
//   in registers. n-tile t holds columns 8t .. 8t+7 of the strip in ONE row
//   s, and the block walks the rows, so an accumulator element keeps its
//   column for the whole walk and the column minimum is a running register
//   value.
// - The skeleton's chunks of 64 words a column are staged with its
//   cp.async double buffer (the next chunk in flight while this one is
//   used). f16 fragments take 64 bytes a staged word (256 KB for a chunk),
//   so each half chunk is unpacked in turn into +-1 f16 B fragments in
//   shared memory in fragment order (one conflict-free 8-byte load per lane
//   and mma): 2 x 16 KB packed + 128 KB of fragments, and two block
//   barriers a half chunk. On the H100 this ran 1% faster than 32-word
//   chunks with the same barriers a word (0.2046 against 0.2059-0.2078 ms
//   at 256 x 1M x 128 bits).
// - The accumulator starts at 1536 = 0x6600, so it ends at 1536 + dot with
//   dot = B - 2d in [-256, 256]: in [1024, 2048) the f16 bit pattern is
//   0x6600 + dot, an integer that grows with dot. One byte permute builds
//   the running key (pattern << 16) | (0xffff - s), whose maximum is the
//   item of the largest dot (smallest d), ties to the smallest s: kernel 2's
//   minimum. The composite key is formed once at the end; a key of 0 means
//   the column holds no valid item.
// - Padding as in the skeleton: rows below s_full hold no padding in the
//   strip and take the unmasked update, the one row between is masked per
//   element, and rows at or past s_pad hold only padding and are not read.
#include "grouped_scan.cuh"

namespace {

using namespace gscan;

constexpr uint32_t kAccInit = 0x66006600u;  // f16 pair (1536, 1536)

template <int W>
constexpr int kMT = W <= 4 ? 2 : 1;

// The skeleton's staged chunks, unpacked half a chunk (kHalf rows) at a
// time: f16 fragments take 64 bytes a staged word, so a whole chunk's would
// not fit in shared memory.
template <int W>
struct Tile : Tiling<W, kMT<W>> {
  using Base = Tiling<W, kMT<W>>;
  static constexpr int kHalf = (Base::kRows + 1) / 2;
  static constexpr int kSmem =
      2 * Base::kPackedWords * 4 + kHalf * W * kCols * 64;
};

// Bits p and p+1 of x as two f16 +-1 values (+1 = 0x3C00 where the bit is
// set, -1 = 0xBC00 where it is not), bit p in the low half.
__device__ __forceinline__ uint32_t pm1_pair(uint32_t x, int p) {
  return 0xBC00BC00u ^ (((x >> p) & 1u) << 15) ^
         (((x >> (p + 1)) & 1u) << 31);
}

// d += a * b: one 16x8x16 product, f16 operands, f16 accumulator.
__device__ __forceinline__ void mma_f16(uint32_t (&d)[2],
                                        const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 "
      "{%0, %1}, {%2, %3, %4, %5}, {%6, %7}, {%0, %1};\n"
      : "+r"(d[0]), "+r"(d[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The packed words of ns rows -> f16 B fragments: frag[((sl*kNT + t)*2W +
// kc)*32 + lane] holds, for column 8t + lane/4, bits 16kc + 2(lane%4) + 0, 1
// (x) and + 8, 9 (y) of the staged words as +-1 f16 pairs.
template <int W>
__device__ __forceinline__ void unpack_chunk_f16(const uint32_t* packed,
                                                 uint2* frag, int ns) {
  constexpr int KC = 2 * W;
  for (int e = threadIdx.x; e < ns * kNT * KC * 32; e += kThreads) {
    const int lane = e & 31, blk = e >> 5;
    const int kc = blk % KC, t = (blk / KC) % kNT, sl = blk / (KC * kNT);
    const uint32_t x =
        packed[(sl * W + (kc >> 1)) * kCols + 8 * t + (lane >> 2)];
    const int p = 16 * (kc & 1) + 2 * (lane & 3);
    frag[e] = make_uint2(pm1_pair(x, p), pm1_pair(x, p + 8));
  }
}

// One row s for every n-tile: the products, then the running maximum of
// each element's key. best[m][t][h][j] is row grp + 8h, column
// col_lane + 8t + j. kMixed: the row where the strip crosses valid_n.
template <int W, int MT, bool kMixed>
__device__ __forceinline__ void row_step_f16(
    const uint2* frag, const uint32_t (&a)[MT][2 * W][4], int sl, int s,
    int col_lane, int C, int valid_n, uint32_t (&best)[MT][kNT][2][2]) {
  constexpr int KC = 2 * W;
  const int lane = threadIdx.x & 31;
  const uint32_t cs = 0xffffu - static_cast<uint32_t>(s);
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    uint32_t acc[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = kAccInit;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint2 b = frag[((sl * kNT + t) * KC + kc) * 32 + lane];
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_f16(acc[m], a[m][kc], b);
    }
    bool ok0 = true, ok1 = true;
    if (kMixed) {
      const int idx = s * C + col_lane + 8 * t;
      ok0 = idx < valid_n;
      ok1 = idx + 1 < valid_n;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t k0 = __byte_perm(acc[m][h], cs, 0x1054);
        const uint32_t k1 = __byte_perm(acc[m][h], cs, 0x3254);
        if (ok0) best[m][t][h][0] = max(best[m][t][h][0], k0);
        if (ok1) best[m][t][h][1] = max(best[m][t][h][1], k1);
      }
  }
}

// A running key -> the composite key of column c (INT32_MAX for 0).
template <int W>
__device__ __forceinline__ int full_key(uint32_t b, int stride, int C, int c) {
  if (b == 0u) return kNone;
  const int dot = static_cast<int>(b >> 16) - 0x6600;
  const int s = 0xffff - static_cast<int>(b & 0xffffu);
  return ((32 * W - dot) >> 1) * stride + s * C + c;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
fullkey_scan_f16_kernel(const int32_t* __restrict__ q,
                        const int32_t* __restrict__ gallery,
                        int32_t* __restrict__ out, int nq, int L, int C,
                        int valid_n, int stride, bool wide) {
  constexpr int MT = kMT<W>;
  constexpr int KC = 2 * W;
  constexpr int kRows = Tile<W>::kRows;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* packed = smem;  // 2 buffers
  uint2* frag = reinterpret_cast<uint2*>(smem + 2 * Tile<W>::kPackedWords);
  const Lanes<MT> ln;
  const int tig = threadIdx.x & 3;
  const int c0 = blockIdx.x * kCols;
  const bool active = ln.q_base < nq;

  // A fragments: rows grp and grp+8 of each m-tile, bits 16kc + 2tig (+1)
  // and + 8 (+9) of the packed words
  uint32_t a[MT][KC][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = ln.query(m, 0), r1 = ln.query(m, 1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t x0 =
          r0 < nq ? static_cast<uint32_t>(q[static_cast<int64_t>(r0) * W + w])
                  : 0u;
      const uint32_t x1 =
          r1 < nq ? static_cast<uint32_t>(q[static_cast<int64_t>(r1) * W + w])
                  : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * h + 2 * tig;
        a[m][2 * w + h][0] = pm1_pair(x0, p);
        a[m][2 * w + h][1] = pm1_pair(x1, p);
        a[m][2 * w + h][2] = pm1_pair(x0, p + 8);
        a[m][2 * w + h][3] = pm1_pair(x1, p + 8);
      }
    }
  }
  uint32_t best[MT][kNT][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) best[m][t][h][0] = best[m][t][h][1] = 0u;

  // rows s < s_full hold no padding in the strip, rows s >= s_pad only
  // padding (not read); at most one row lies between
  const int s_full = rows_of(min(c0 + kCols, C) - 1, C, L, valid_n);
  const int s_pad = rows_of(c0, C, L, valid_n);

  const int n_chunks = (s_pad + kRows - 1) / kRows;
  if (n_chunks > 0)
    stage_chunk<W>(packed, gallery, L, C, c0, 0, min(kRows, s_pad), wide);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * kRows, ns = min(kRows, s_pad - s0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // every thread is past the last chunk's products: the other buffer and
    // the fragments may be overwritten
    __syncthreads();
    if (ci + 1 < n_chunks)
      stage_chunk<W>(packed + ((ci + 1) & 1) * Tile<W>::kPackedWords,
                     gallery, L, C, c0, s0 + kRows,
                     min(kRows, s_pad - s0 - kRows), wide);
    const uint32_t* buf = packed + (ci & 1) * Tile<W>::kPackedWords;
    for (int h0 = 0; h0 < ns; h0 += Tile<W>::kHalf) {
      const int nh = min(Tile<W>::kHalf, ns - h0);
      // every thread is past the first half's products
      if (h0 > 0) __syncthreads();
      unpack_chunk_f16<W>(buf + h0 * W * kCols, frag, nh);
      __syncthreads();
      if (!active) continue;
      for (int sl = 0; sl < nh; ++sl) {
        const int s = s0 + h0 + sl;
        if (s < s_full)
          row_step_f16<W, MT, false>(frag, a, sl, s, ln.col_lane, C, valid_n,
                                     best);
        else
          row_step_f16<W, MT, true>(frag, a, sl, s, ln.col_lane, C, valid_n,
                                    best);
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = ln.query(m, h);
      if (qi >= nq) continue;
      int32_t* row = out + static_cast<int64_t>(qi) * C;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int c = ln.col_lane + 8 * t;
        store_pair<false>(row, c, C,
                          full_key<W>(best[m][t][h][0], stride, C, c),
                          full_key<W>(best[m][t][h][1], stride, C, c + 1));
      }
    }
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, C): the interface of
// hg_mxu_fullkey_scan. The caller guarantees 1 <= W <= 8, L <= 65536,
// nq <= 65535 * (256 for W <= 4, 128 above) and
// (32W + 1) * stride + L*C < 2^31.
extern "C" int hg_fullkey_scan_mma(const void* q, const void* gallery,
                                   void* out, int nq, int W, int L, int C,
                                   int valid_n, int stride, void* stream) {
  auto* gp = static_cast<const int32_t*>(gallery);
  return dispatch_words(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return launch<Tile<kW>>(
        fullkey_scan_f16_kernel<kW>, nq, C, static_cast<cudaStream_t>(stream),
        static_cast<const int32_t*>(q), gp, static_cast<int32_t*>(out), nq, L,
        C, valid_n, stride, wide_rows(gp, C));
  });
}
