// Exact full-key scan on the tensor cores: per (query, column) the smallest
// composite key
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
// TOP/s; the f16 rate is half of that). Gallery bytes (16 MB at 1M x 128
// bits) stay L2-resident. This simple version is held back by its epilogue
// and its shared-memory traffic rather than by the products: it runs
// mma.sync, not wgmma, and no TMA pipeline.
// Design:
// - A block covers 32 gallery columns (4 mma n-tiles of 8) and 8 warps of
//   queries; a warp owns MT m-tiles of 16 queries (32 queries for W <= 4,
//   16 above), whose +-1 A fragments it builds once from the packed words
//   and keeps in registers for the whole scan.
// - Items go along N so that n-tile j holds columns c0 + 8j .. c0 + 8j + 7
//   of ONE group row s, and the block walks s = 0 .. L-1. An accumulator
//   element therefore keeps its column for the whole walk, and the column
//   minimum is a running minimum in registers: no shuffles.
// - Per chunk of s rows the block stages the packed words in shared memory,
//   unpacks them once to +-1 f16 B fragments, stored in fragment order (one
//   8-byte load per lane per mma, conflict-free), and every warp reuses them.
// - The accumulator starts at 1536 = 0x6600, so it ends at 1536 + dot with
//   dot = B - 2d in [-256, 256]: in [1024, 2048) the f16 bit pattern is
//   0x6600 + dot, an integer that grows with dot. One byte permute builds
//   the running key (pattern << 16) | (0xffff - s), whose maximum is the
//   item of the largest dot (smallest d), ties to the smallest s: K2's
//   minimum of (d << 16) | s. The composite key is formed once at the end.
// - Rows s where some column of the block has run out of valid items are
//   masked per element; the others take the unmasked update.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;               // gallery columns per block
constexpr int kNTiles = kCols / 8;      // mma n-tiles per block
constexpr int kFragBytes = 32 * 1024;   // unpacked B fragments per chunk
constexpr uint32_t kAccInit = 0x66006600u;  // f16 pair (1536, 1536)

// Bits p and p+1 of x as two f16 +-1 values (+1 = 0x3C00 where the bit is
// set, -1 = 0xBC00 where it is not), bit p in the low half.
__device__ __forceinline__ uint32_t pm1_pair(uint32_t x, int p) {
  return 0xBC00BC00u ^ (((x >> p) & 1u) << 15) ^
         (((x >> (p + 1)) & 1u) << 31);
}

// d += a * b: one 16x8x16 product, f16 operands, f16 accumulator.
__device__ __forceinline__ void mma_f16(uint32_t (&d)[2],
                                        const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 "
      "{%0, %1}, {%2, %3, %4, %5}, {%6, %7}, {%0, %1};\n"
      : "+r"(d[0]), "+r"(d[1])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Valid rows of column c: items s*C + c < valid_n for s < s_end.
__device__ __forceinline__ int rows_of(int c, int C, int L, int valid_n) {
  return (c < C && valid_n > c) ? min(L, (valid_n - c + C - 1) / C) : 0;
}

template <int W>
struct Tiling {
  static constexpr int MT = W <= 4 ? 2 : 1;   // m-tiles (16 queries) a warp
  static constexpr int KC = 2 * W;            // k-chunks of 16 bits
  static constexpr int kRows = kFragBytes / (kCols * 32 * W * 2);  // 16 / W
  static constexpr int kQueries = kWarps * 16 * MT;  // queries per block
};

template <int W>
__global__ void __launch_bounds__(kThreads)
fullkey_mma_kernel(const int32_t* __restrict__ q,
                   const int32_t* __restrict__ gallery,
                   int32_t* __restrict__ out, int nq, int L, int C,
                   int valid_n, int stride) {
  constexpr int MT = Tiling<W>::MT;
  constexpr int KC = Tiling<W>::KC;
  constexpr int kRows = Tiling<W>::kRows;
  __shared__ uint32_t packed[kRows * W * kCols];
  __shared__ uint2 frag[kRows * kNTiles * KC * 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.x * kCols;
  const int q_base = blockIdx.y * Tiling<W>::kQueries + warp * 16 * MT;
  const bool active = q_base < nq;

  // A fragments: rows g and g+8 of each m-tile, bits 16kc + 2tig (+1, +8, +9)
  uint32_t a[MT][KC][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = q_base + m * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t x0 = r0 < nq ? static_cast<uint32_t>(
                                        q[static_cast<int64_t>(r0) * W + w])
                                  : 0u;
      const uint32_t x1 = r1 < nq ? static_cast<uint32_t>(
                                        q[static_cast<int64_t>(r1) * W + w])
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

  // Accumulator element (j, half h) holds column c0 + 8j + 2tig + h.
  int valid_rows[kNTiles][2];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      valid_rows[j][h] = rows_of(c0 + 8 * j + 2 * tig + h, C, L, valid_n);
  const int s_max = rows_of(c0, C, L, valid_n);
  const int s_full = rows_of(min(c0 + kCols, C) - 1, C, L, valid_n);

  uint32_t best[MT][kNTiles][2][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) best[m][j][r][0] = best[m][j][r][1] = 0u;

  for (int s0 = 0; s0 < s_max; s0 += kRows) {
    const int ns = min(kRows, s_max - s0);
    for (int i = threadIdx.x; i < ns * W * kCols; i += kThreads) {
      const int cl = i % kCols, w = (i / kCols) % W, sl = i / (kCols * W);
      const int c = c0 + cl;
      packed[i] = c < C ? static_cast<uint32_t>(
                              gallery[(static_cast<int64_t>(w) * L + s0 + sl) *
                                          C + c])
                        : 0u;
    }
    __syncthreads();
    // B fragment of (row sl, n-tile j, k-chunk kc) for lane ln: column
    // 8j + ln/4, bits 16kc + 2(ln%4) (+1) and (+8, +9).
    for (int i = threadIdx.x; i < ns * kNTiles * KC * 32; i += kThreads) {
      const int ln = i & 31, blk = i >> 5;
      const int kc = blk % KC, j = (blk / KC) % kNTiles, sl = blk / (KC * kNTiles);
      const uint32_t x = packed[(sl * W + (kc >> 1)) * kCols + 8 * j + (ln >> 2)];
      const int p = 16 * (kc & 1) + 2 * (ln & 3);
      frag[i] = make_uint2(pm1_pair(x, p), pm1_pair(x, p + 8));
    }
    __syncthreads();
    if (active) {
      for (int sl = 0; sl < ns; ++sl) {
        const int s = s0 + sl;
        uint32_t acc[MT][kNTiles][2];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) acc[m][j][0] = acc[m][j][1] = kAccInit;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int j = 0; j < kNTiles; ++j) {
            const uint2 b = frag[((sl * kNTiles + j) * KC + kc) * 32 + lane];
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_f16(acc[m][j], a[m][kc], b);
          }
        const uint32_t cs = 0xffffu - static_cast<uint32_t>(s);
        if (s < s_full) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < kNTiles; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                best[m][j][r][0] = max(best[m][j][r][0],
                                       __byte_perm(acc[m][j][r], cs, 0x1054));
                best[m][j][r][1] = max(best[m][j][r][1],
                                       __byte_perm(acc[m][j][r], cs, 0x3254));
              }
        } else {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < kNTiles; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const uint32_t k0 = __byte_perm(acc[m][j][r], cs, 0x1054);
                const uint32_t k1 = __byte_perm(acc[m][j][r], cs, 0x3254);
                if (s < valid_rows[j][0])
                  best[m][j][r][0] = max(best[m][j][r][0], k0);
                if (s < valid_rows[j][1])
                  best[m][j][r][1] = max(best[m][j][r][1], k1);
              }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites packed and frag
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q_base + m * 16 + g + 8 * r;
      if (qi >= nq) continue;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 8 * j + 2 * tig + h;
          if (c >= C) continue;
          const uint32_t b = best[m][j][r][h];
          int key = 0x7fffffff;
          if (b != 0u) {
            const int dot = static_cast<int>(b >> 16) - 0x6600;
            const int d = (32 * W - dot) >> 1;
            const int s = 0xffff - static_cast<int>(b & 0xffffu);
            key = d * stride + s * C + c;
          }
          out[static_cast<int64_t>(qi) * C + c] = key;
        }
    }
}

template <int W>
void launch(const int32_t* q, const int32_t* g, int32_t* out, int nq, int L,
            int C, int valid_n, int stride, cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols,
                  (nq + Tiling<W>::kQueries - 1) / Tiling<W>::kQueries);
  fullkey_mma_kernel<W><<<grid, kThreads, 0, stream>>>(q, g, out, nq, L, C,
                                                       valid_n, stride);
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, C): the interface of
// hg_mxu_fullkey_scan. The caller guarantees 1 <= W <= 8, L <= 65536 and
// (32W + 1) * stride + L*C < 2^31.
extern "C" int hg_fullkey_scan_mma(const void* q, const void* gallery,
                                   void* out, int nq, int W, int L, int C,
                                   int valid_n, int stride, void* stream) {
  auto* qp = static_cast<const int32_t*>(q);
  auto* gp = static_cast<const int32_t*>(gallery);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 2: launch<2>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 3: launch<3>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 4: launch<4>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 5: launch<5>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 6: launch<6>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 7: launch<7>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    case 8: launch<8>(qp, gp, op, nq, L, C, valid_n, stride, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
