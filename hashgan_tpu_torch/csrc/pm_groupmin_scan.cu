// Column-min scan over the pre-unpacked +-1 gallery (the opt-in pm8 copy):
//   out[q, c] = min over s of  base[s, c] - (L/2) * sum_b q[q, b] * g[b, s, c]
// for +-1 queries q (Q, B) and a +-1 gallery in the block layout
// (B, C/cb, L, cb) (item s of column c = j*cb + cc at [b, j, s, cc]).
// int8 operands: int32 sums and keys, half_l = L/2 in integers. bf16
// operands: float32 sums and keys, half_l = L/2.0. Both exact: the sums are
// integers of magnitude <= B <= 256. With the key base of build_key_base
// (B*L/2 + s, +2^22 on padding) the key is d*L + s (+2^22), distinct over s.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, mxu8_groupmin_scan ->
// _pm_groupmin_kernel (line 142), one MXU matmul per (query tile, column
// block) followed by a sublane min.
//
// Bound on the H100: at 256 queries over 1M items x 128 bits the int8
// gallery is 134 MB, past the 50 MB L2, so the least time is reading it once
// (40 us at 3.35 TB/s; the 6.9e10 int8 operations take 35 us on the tensor
// cores). The bf16 copy is 268 MB (80 us), and its products take 70 us at
// the bf16 rate: that path sits near both limits.
//
// Both dtypes share one walk on the tensor cores (B = 32W, W = 1..8):
// - A block covers a strip of 64 columns and 8 warps: int8 8 query groups
//   of 2 m-tiles (16 queries each), bf16 4 query groups of MT m-tiles, two
//   warps each, one a column half. Each warp builds its A fragments once
//   from q and keeps them in registers for the whole walk. So a block's
//   queries read each gallery byte from device memory once; for more
//   queries the query groups of one strip are neighbours in the launch
//   order (grid x), so their reads meet in L2.
// - Items go along N: n-tile t holds columns 8t .. 8t+7 of the strip in ONE
//   group row s, and the block walks s = 0 .. L-1. Each accumulator element
//   keeps its column, so the column minimum is a running register minimum,
//   folded in after the k-steps of each n-tile: no shuffles.
// - The gallery is staged in chunks of 16/W rows s with cp.async (16-byte
//   copies where cb allows, zero-filled past C), double-buffered: chunk i+1
//   is in flight while chunk i is multiplied. The key base rows of the chunk
//   come with it. A staged row is one (s, bit) row of the strip's 64 columns.
//
// int8 (pm_int8_mma_kernel): mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (exact
// int32 sums), MT = 2 (256 queries a block). The .col B operand wants 4
// consecutive bits of one item in a register, and the pm8 layout strides
// bits by NB*L*cb. Each chunk is transposed once with __byte_perm into B
// fragments in fragment order, which every warp then reads with one
// conflict-free 8-byte load per lane per mma. The transpose reads staging
// rows padded to 80 bytes in a rotated row order, and writes its four words
// in a rotated column order, so that neither side has shared-memory bank
// conflicts.
//
// bf16 (pm_bf16_mma_kernel): mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32
// (float32 sums, exact for +-1 operands in any order). A 16-bit B fragment
// holds 2 consecutive bits of one item, which is what ldmatrix .trans gives
// from staged (bit, column) rows: one ldmatrix.x4.trans per lane reads the
// fragments of two k-steps of one n-tile, with no transpose pass. Staged
// rows are 128 + 16 bytes, so the eight rows of one 8x8 matrix fall in
// distinct banks. Each B fragment feeds MT m-tiles, so the fragment reads
// per product fall as MT grows; the A fragments (MT x 2W x 4 registers) cap
// it: MT = 4 (256 queries a block) up to W = 4, 2 (128) above. The key is
// __fsub_rn(base, __fmul_rn(sum, half_l)): two rounded float32 operations,
// as the plain twin computes it, with no contraction into an FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// int8: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMT = 2;                         // m-tiles (16 queries) a warp
constexpr int kBlockQueries = kMmaWarps * 16 * kMT;  // 256
constexpr int kCols = 64;                      // columns per block (strip)
constexpr int kNT = kCols / 8;                 // mma n-tiles per strip
constexpr int kRowBytes = kCols + 16;          // staged (s, bit) row, padded

template <int W>
struct Int8Tiling {
  static constexpr int B = 32 * W;
  static constexpr int kRows = 16 / W;         // rows s per chunk (32 KB)
  static constexpr int kRawBytes = kRows * B * kRowBytes;   // one buffer
  static constexpr int kBaseBytes = kRows * kCols * 4;      // one buffer
  static constexpr int kFragBytes = kRows * B * kCols;      // B fragments
  static constexpr int kSmem = 2 * (kRawBytes + kBaseBytes) + kFragBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of ``bytes`` (16, 8 or 4) bytes into shared memory;
// zero-filled when ``valid`` is false (src is then not read).
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool valid) {
  const uint32_t d = smem_addr(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a * b: one 16x8x32 product, s8 operands, s32 accumulator.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Stage rows s0 .. s0+ns-1 of the strip's columns c0 .. c0+63: the gallery's
// elements (type T, kRows rows s a buffer) as raw[(sl*B + b)*kRowBytes +
// (col - c0)*sizeof(T)] and the key base (4-byte K) as base_s[sl*kCols + col
// - c0]. A thread always copies the same 2^seg_shift bytes of the strip,
// those from column c on (the copy divides cb*sizeof(T), so it never crosses
// a column block); gcol points at them in bit row 0, group row 0. Columns
// past C are zero-filled.
template <typename T, typename K, int B, int kRows, int kRowBytes>
__device__ __forceinline__ void stage_chunk(
    uint8_t* raw, K* base_s, const T* gcol, const K* __restrict__ base, int s0,
    int ns, int c, bool col_ok, int C, int cb, int64_t bit_stride,
    int seg_shift) {
  // log2 of the copies a staged row takes (its data: kCols * sizeof(T))
  const int per_row = (sizeof(T) == 1 ? 6 : 7) - seg_shift;
  const int seg = 1 << seg_shift;
  const int sg = threadIdx.x & ((1 << per_row) - 1);
  for (int r = threadIdx.x >> per_row; r < kRows * B;
       r += kMmaThreads >> per_row) {
    const int sl = r % kRows, b = r / kRows;
    if (sl >= ns) continue;
    cp_async(raw + (sl * B + b) * kRowBytes + sg * seg,
             gcol + b * bit_stride + static_cast<int64_t>(s0 + sl) * cb, seg,
             col_ok);
  }
  if (threadIdx.x < ns * (kCols / 4)) {
    const int sl = threadIdx.x / (kCols / 4), c4 = threadIdx.x % (kCols / 4);
    const int col = (c & ~(kCols - 1)) + 4 * c4;  // the strip's column 4*c4
    cp_async(base_s + sl * kCols + 4 * c4,
             base + static_cast<int64_t>(s0 + sl) * C + (col < C ? col : 0),
             16, col < C);
  }
  cp_async_commit();
}

// The staged bytes of ns rows -> B fragments: frag[((sl*kNT + t)*W + k)*32
// + lane] holds, for column 8t + lane/4, bits 32k + 4(lane%4) + 0..3 (x)
// and 32k + 16 + 4(lane%4) + 0..3 (y), the lowest bit in the lowest byte.
// A warp step takes (sl, k, half of the strip): lane = (column quad c4,
// bit quad tig) loads 4 + 4 row words of 4 columns and transposes them
// into the 4 columns' fragment words.
template <int W>
__device__ __forceinline__ void transpose_chunk(const uint8_t* raw,
                                                uint2* frag, int ns) {
  constexpr int B = 32 * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int rot = (lane >> 2) & 3;  // column order of the stores
  const int rl = tig & 2;           // row order of the loads: i ^ rl
  // second transpose stage: rows 0-1 from t_a, 2-3 from t_b (or swapped)
  const uint32_t sel_lo = rl ? 0x1054u : 0x5410u;
  const uint32_t sel_hi = rl ? 0x3276u : 0x7632u;
  for (int u = warp; u < ns * W * 2; u += kMmaWarps) {
    const int half = u & 1, k = (u >> 1) % W, sl = (u >> 1) / W;
    const int c4 = 8 * half + (lane >> 2);
    const uint8_t* rows =
        raw + (sl * B + 32 * k + 4 * tig) * kRowBytes + 4 * c4;
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i ^ rl;
      // byte p of each word becomes column 4*c4 + (p + rot) % 4
      lo[i] = __funnelshift_r(
          *reinterpret_cast<const uint32_t*>(rows + r * kRowBytes),
          *reinterpret_cast<const uint32_t*>(rows + r * kRowBytes), 8 * rot);
      hi[i] = __funnelshift_r(
          *reinterpret_cast<const uint32_t*>(rows + (16 + r) * kRowBytes),
          *reinterpret_cast<const uint32_t*>(rows + (16 + r) * kRowBytes),
          8 * rot);
    }
    uint32_t item_lo[4], item_hi[4];
    {
      const uint32_t t0 = __byte_perm(lo[0], lo[1], 0x5140);
      const uint32_t t1 = __byte_perm(lo[0], lo[1], 0x7362);
      const uint32_t t2 = __byte_perm(lo[2], lo[3], 0x5140);
      const uint32_t t3 = __byte_perm(lo[2], lo[3], 0x7362);
      item_lo[0] = __byte_perm(t0, t2, sel_lo);
      item_lo[1] = __byte_perm(t0, t2, sel_hi);
      item_lo[2] = __byte_perm(t1, t3, sel_lo);
      item_lo[3] = __byte_perm(t1, t3, sel_hi);
    }
    {
      const uint32_t t0 = __byte_perm(hi[0], hi[1], 0x5140);
      const uint32_t t1 = __byte_perm(hi[0], hi[1], 0x7362);
      const uint32_t t2 = __byte_perm(hi[2], hi[3], 0x5140);
      const uint32_t t3 = __byte_perm(hi[2], hi[3], 0x7362);
      item_hi[0] = __byte_perm(t0, t2, sel_lo);
      item_hi[1] = __byte_perm(t0, t2, sel_hi);
      item_hi[2] = __byte_perm(t1, t3, sel_lo);
      item_hi[3] = __byte_perm(t1, t3, sel_hi);
    }
    uint2* blk = frag + ((sl * kNT + (c4 >> 1)) * W + k) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cc = (i + rot) & 3;  // column 4*c4 + cc
      blk[(4 * (c4 & 1) + cc) * 4 + tig] = make_uint2(item_lo[i], item_hi[i]);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kMmaThreads, 1)
pm_int8_mma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ g,
                   const int32_t* __restrict__ base, int32_t* __restrict__ out,
                   int nq, int NB, int L, int cb, int seg_shift) {
  using T = Int8Tiling<W>;
  constexpr int B = T::B;
  extern __shared__ __align__(16) uint8_t pm8_smem[];
  uint8_t* raw = pm8_smem;                                     // 2 buffers
  int32_t* base_s = reinterpret_cast<int32_t*>(pm8_smem + 2 * T::kRawBytes);
  uint2* frag = reinterpret_cast<uint2*>(
      pm8_smem + 2 * (T::kRawBytes + T::kBaseBytes));

  const int C = NB * cb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * kCols;
  const int q_base = blockIdx.x * kBlockQueries + warp * 16 * kMT;
  const bool active = q_base < nq;
  const int half_l = L / 2;

  // A fragments: rows grp and grp+8 of each m-tile, bytes 32k + 4tig (+16)
  uint32_t a[kMT][W][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int r0 = q_base + m * 16 + grp, r1 = r0 + 8;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + static_cast<int64_t>(r0) * B) + tig;
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + static_cast<int64_t>(r1) * B) + tig;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      a[m][k][0] = r0 < nq ? q0[8 * k] : 0u;
      a[m][k][1] = r1 < nq ? q1[8 * k] : 0u;
      a[m][k][2] = r0 < nq ? q0[8 * k + 4] : 0u;
      a[m][k][3] = r1 < nq ? q1[8 * k + 4] : 0u;
    }
  }

  // accumulator element r of n-tile t: query row grp + 8(r/2), column
  // 8t + 2tig + r%2 of the strip
  int32_t best[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) best[m][t][r] = 0x7fffffff;

  // this thread's staging column: 2^seg_shift bytes at column c
  const int c = c0 + ((threadIdx.x & ((kCols >> seg_shift) - 1)) << seg_shift);
  const bool col_ok = c < C;
  const int8_t* gcol =
      col_ok ? g + (static_cast<int64_t>(c / cb) * L) * cb + c % cb : g;
  const int64_t bit_stride = static_cast<int64_t>(NB) * L * cb;

  const int n_chunks = (L + T::kRows - 1) / T::kRows;
  stage_chunk<int8_t, int32_t, B, T::kRows, kRowBytes>(
      raw, base_s, gcol, base, 0, min(T::kRows, L), c, col_ok, C, cb,
      bit_stride, seg_shift);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int s0 = ci * T::kRows, ns = min(T::kRows, L - s0);
    cp_async_wait_all();
    // every thread is past the last chunk's products: the other buffer and
    // the fragments may be overwritten
    __syncthreads();
    if (ci + 1 < n_chunks) {
      const int s1 = s0 + T::kRows;
      stage_chunk<int8_t, int32_t, B, T::kRows, kRowBytes>(
          raw + (buf ^ 1) * T::kRawBytes,
          base_s + (buf ^ 1) * T::kRows * kCols, gcol, base, s1,
          min(T::kRows, L - s1), c, col_ok, C, cb, bit_stride, seg_shift);
    }
    transpose_chunk<W>(raw + buf * T::kRawBytes, frag, ns);
    __syncthreads();
    if (!active) continue;
    const int32_t* bs = base_s + buf * T::kRows * kCols;
    for (int sl = 0; sl < ns; ++sl) {
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int2 bv =
            *reinterpret_cast<const int2*>(bs + sl * kCols + 8 * t + 2 * tig);
        int32_t acc[kMT][4] = {};
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const uint2 b = frag[((sl * kNT + t) * W + k) * 32 + lane];
#pragma unroll
          for (int m = 0; m < kMT; ++m) mma_s8(acc[m], a[m][k], b);
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          best[m][t][0] = min(best[m][t][0], bv.x - acc[m][0] * half_l);
          best[m][t][1] = min(best[m][t][1], bv.y - acc[m][1] * half_l);
          best[m][t][2] = min(best[m][t][2], bv.x - acc[m][2] * half_l);
          best[m][t][3] = min(best[m][t][3], bv.y - acc[m][3] * half_l);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q_base + m * 16 + grp + 8 * h;
      if (qi >= nq) continue;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int c = c0 + 8 * t + 2 * tig;  // C % 4 == 0: c, c+1 both in
        if (c < C)
          *reinterpret_cast<int2*>(out + static_cast<int64_t>(qi) * C + c) =
              make_int2(best[m][t][2 * h], best[m][t][2 * h + 1]);
      }
    }
}

template <int W>
int launch_int8(const int8_t* q, const int8_t* g, const int32_t* base,
                int32_t* out, int nq, int NB, int L, int cb,
                cudaStream_t stream) {
  const int smem = Int8Tiling<W>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      pm_int8_mma_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int seg_shift = cb % 16 == 0 ? 4 : (cb % 8 == 0 ? 3 : 2);
  const dim3 grid((nq + kBlockQueries - 1) / kBlockQueries,
                  (NB * cb + kCols - 1) / kCols);
  pm_int8_mma_kernel<W><<<grid, kMmaThreads, smem, stream>>>(
      q, g, base, out, nq, NB, L, cb, seg_shift);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int W>
struct Bf16Tiling {
  static constexpr int B = 32 * W;
  // m-tiles (16 queries) a warp: each B fragment feeds kMT products, and
  // the A fragments take kMT x 2W x 4 registers
  static constexpr int kMT = W <= 4 ? 4 : 2;
  static constexpr int kColGroups = 2;  // warps a query group (column halves)
  static constexpr int kWarpNT = kNT / kColGroups;  // n-tiles a warp
  static constexpr int kBlockQueries = kMmaWarps / kColGroups * 16 * kMT;
  static constexpr int kRowBytes = 2 * kCols + 16;  // conflict-free ldmatrix
  static constexpr int kRows = 16 / W;              // rows s per chunk
  static constexpr int kRawBytes = kRows * B * kRowBytes;   // one buffer
  static constexpr int kBaseBytes = kRows * kCols * 4;      // one buffer
  static constexpr int kSmem = 2 * (kRawBytes + kBaseBytes);
};

// d += a * b: one 16x8x16 product, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lane 8m + i gives the address of row i
// of matrix m; register m of lane l gets rows 2(l%4), 2(l%4) + 1 of column
// l/4 of matrix m (the lower row in the lower half).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

template <int W>
__global__ void __launch_bounds__(kMmaThreads, 1)
pm_bf16_mma_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ g,
                   const float* __restrict__ base, float* __restrict__ out,
                   int nq, int NB, int L, int cb, int seg_shift) {
  using T = Bf16Tiling<W>;
  constexpr int B = T::B, MT = T::kMT, NT = T::kWarpNT;
  extern __shared__ __align__(16) uint8_t pm8_smem[];
  uint8_t* raw = pm8_smem;                                     // 2 buffers
  float* base_s = reinterpret_cast<float*>(pm8_smem + 2 * T::kRawBytes);

  const int C = NB * cb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * kCols;
  const int cg = warp % T::kColGroups;  // n-tiles cg*NT .. cg*NT + NT-1
  const int q_base =
      blockIdx.x * T::kBlockQueries + warp / T::kColGroups * 16 * MT;
  const bool active = q_base < nq;
  const float half_l = static_cast<float>(L) / 2.0f;

  // A fragments of k-step k (bits 16k .. 16k+15): rows grp and grp+8 of each
  // m-tile, bits 16k + 2tig (+1) and 16k + 8 + 2tig (+1), two bf16 a word
  uint32_t a[MT][2 * W][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = q_base + m * 16 + grp, r1 = r0 + 8;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + static_cast<int64_t>(r0) * B) + tig;
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + static_cast<int64_t>(r1) * B) + tig;
#pragma unroll
    for (int k = 0; k < 2 * W; ++k) {
      a[m][k][0] = r0 < nq ? q0[8 * k] : 0u;
      a[m][k][1] = r1 < nq ? q1[8 * k] : 0u;
      a[m][k][2] = r0 < nq ? q0[8 * k + 4] : 0u;
      a[m][k][3] = r1 < nq ? q1[8 * k + 4] : 0u;
    }
  }

  // accumulator element r of the warp's n-tile t: query row grp + 8(r/2),
  // column 8(cg*NT + t) + 2tig + r%2 of the strip
  float best[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) best[m][t][r] = __int_as_float(0x7f800000);

  // this thread's staging copy: 2^seg_shift bytes from column c
  const int per_row = 7 - seg_shift;  // log2 of the copies a staged row takes
  const int c =
      c0 + ((threadIdx.x & ((1 << per_row) - 1)) << seg_shift) / 2;
  const bool col_ok = c < C;
  const uint16_t* gcol =
      col_ok ? g + (static_cast<int64_t>(c / cb) * L) * cb + c % cb : g;
  const int64_t bit_stride = static_cast<int64_t>(NB) * L * cb;

  const int n_chunks = (L + T::kRows - 1) / T::kRows;
  stage_chunk<uint16_t, float, B, T::kRows, T::kRowBytes>(
      raw, base_s, gcol, base, 0, min(T::kRows, L), c, col_ok, C, cb,
      bit_stride, seg_shift);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int s0 = ci * T::kRows, ns = min(T::kRows, L - s0);
    cp_async_wait_all();
    // chunk ci is in, and every thread is past the last chunk's products:
    // the other buffer may be overwritten
    __syncthreads();
    if (ci + 1 < n_chunks) {
      const int s1 = s0 + T::kRows;
      stage_chunk<uint16_t, float, B, T::kRows, T::kRowBytes>(
          raw + (buf ^ 1) * T::kRawBytes,
          base_s + (buf ^ 1) * T::kRows * kCols, gcol, base, s1,
          min(T::kRows, L - s1), c, col_ok, C, cb, bit_stride, seg_shift);
    }
    if (!active) continue;
    // this lane's ldmatrix row: bit 32kp + lane (matrix lane/8, row lane%8)
    // at the warp's first column
    const uint8_t* rows =
        raw + buf * T::kRawBytes + lane * T::kRowBytes + 16 * NT * cg;
    const float* bs = base_s + buf * T::kRows * kCols + 8 * NT * cg;
    for (int sl = 0; sl < ns; ++sl) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bs + sl * kCols + 8 * t + 2 * tig);
        float acc[MT][4] = {};
#pragma unroll
        for (int kp = 0; kp < W; ++kp) {
          // B fragments of k-steps 2kp (b[0], b[1]) and 2kp + 1 (b[2], b[3])
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, rows + (sl * B + 32 * kp) * T::kRowBytes + 16 * t);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m], a[m][2 * kp], b[0], b[1]);
            mma_bf16(acc[m], a[m][2 * kp + 1], b[2], b[3]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            best[m][t][r] = fminf(best[m][t][r],
                                  __fsub_rn(r & 1 ? bv.y : bv.x,
                                            __fmul_rn(acc[m][r], half_l)));
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q_base + m * 16 + grp + 8 * h;
      if (qi >= nq) continue;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // C % 4 == 0: c, c+1 both in
        const int c = c0 + 8 * (cg * NT + t) + 2 * tig;
        if (c < C)
          *reinterpret_cast<float2*>(out + static_cast<int64_t>(qi) * C + c) =
              make_float2(best[m][t][2 * h], best[m][t][2 * h + 1]);
      }
    }
}

template <int W>
int launch_bf16(const uint16_t* q, const uint16_t* g, const float* base,
                float* out, int nq, int NB, int L, int cb,
                cudaStream_t stream) {
  using T = Bf16Tiling<W>;
  cudaError_t err = cudaFuncSetAttribute(
      pm_bf16_mma_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int seg_shift = cb % 8 == 0 ? 4 : 3;  // 8 or 4 bf16 a copy
  const dim3 grid((nq + T::kBlockQueries - 1) / T::kBlockQueries,
                  (NB * cb + kCols - 1) / kCols);
  pm_bf16_mma_kernel<W><<<grid, kMmaThreads, T::kSmem, stream>>>(
      q, g, base, out, nq, NB, L, cb, seg_shift);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch(const void* q, const void* g, const void* base, void* out, int nq,
           int NB, int L, int cb, int is_int8, cudaStream_t stream) {
  if (is_int8)
    return launch_int8<W>(static_cast<const int8_t*>(q),
                          static_cast<const int8_t*>(g),
                          static_cast<const int32_t*>(base),
                          static_cast<int32_t*>(out), nq, NB, L, cb, stream);
  return launch_bf16<W>(static_cast<const uint16_t*>(q),
                        static_cast<const uint16_t*>(g),
                        static_cast<const float*>(base),
                        static_cast<float*>(out), nq, NB, L, cb, stream);
}

}  // namespace

// q (nq, B) +-1 int8 (is_int8) or bf16 bits; g (B, NB, L, cb) of the same
// type; base (L, NB*cb) int32 or float32; out (nq, NB*cb) of the base's
// type. The caller guarantees B = 32W with 1 <= W <= 8, cb % 4 == 0, 16-byte
// aligned g and base and 4-byte aligned q (so every vector access and
// asynchronous copy is aligned in contiguous tensors).
extern "C" int hg_pm_groupmin_scan(const void* q, const void* g,
                                   const void* base, void* out, int nq, int B,
                                   int NB, int L, int cb, int is_int8,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 32: return launch<1>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 64: return launch<2>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 96: return launch<3>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 128: return launch<4>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 160: return launch<5>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 192: return launch<6>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 224: return launch<7>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    case 256: return launch<8>(q, g, base, out, nq, NB, L, cb, is_int8, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
