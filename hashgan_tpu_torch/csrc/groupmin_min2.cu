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
// Design: the int8 tensor-core walk of grouped_scan.cuh, a warp with MT
// m-tiles of 16 queries (2 for W <= 4, so 256 queries a block, 1 above:
// the two running minima take the registers a second m-tile would need).
// Its epilogue keeps b2 = min(b2, max(b1, key)), b1 = min(b1, key) per
// element, and forms the composite keys once at the end.
#include "grouped_scan.cuh"

namespace {

using namespace gscan;

constexpr int kPadBase = 1000000000;

template <int W>
constexpr int kMT = W <= 4 ? 2 : 1;

template <int MT>
struct Min2 {
  int (&b1)[MT][kNT][4];
  int (&b2)[MT][kNT][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) b1[m][t][r] = b2[m][t][r] = kNone;
  }
  __device__ __forceinline__ void key(int m, int t, int r, int k) {
    b2[m][t][r] = min(b2[m][t][r], max(b1[m][t][r], k));
    b1[m][t][r] = min(b1[m][t][r], k);
  }
  __device__ __forceinline__ void row_done(int) {}
};

__device__ __forceinline__ int composite(int local, int stride, int C, int c) {
  if (local == kNone) return kNone;
  return local_d(local) * stride + local_s(local) * C + c +
         (local_is_pad(local) ? kPadBase : 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
groupmin_min2_mma_kernel(const int32_t* __restrict__ q,
                         const int32_t* __restrict__ gallery,
                         int32_t* __restrict__ min1, int32_t* __restrict__ min2,
                         int nq, int L, int C, int valid_n, int stride,
                         bool wide) {
  constexpr int MT = kMT<W>;
  const Lanes<MT> ln;
  int b1[MT][kNT][4], b2[MT][kNT][4];
  Min2<MT> epi{b1, b2};
  if (!walk_strip<W, MT>(q, gallery, nq, L, C, valid_n, wide, ln, epi))
    return;

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = ln.query(m, h);
      if (qi >= nq) continue;
      const int64_t row = static_cast<int64_t>(qi) * C;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int c = ln.col_lane + 8 * t;
        store_pair<false>(min1 + row, c, C,
                          composite(epi.b1[m][t][2 * h], stride, C, c),
                          composite(epi.b1[m][t][2 * h + 1], stride, C, c + 1));
        store_pair<false>(min2 + row, c, C,
                          composite(epi.b2[m][t][2 * h], stride, C, c),
                          composite(epi.b2[m][t][2 * h + 1], stride, C, c + 1));
      }
    }
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); min1, min2 (nq, C). The
// caller guarantees 1 <= W <= 8, L <= 65536, nq <= 65535 * 128 and
// (32W + 1) * stride + L*C < PAD_BASE.
extern "C" int hg_groupmin_min2(const void* q, const void* gallery,
                                void* min1, void* min2, int nq, int W, int L,
                                int C, int valid_n, int stride, void* stream) {
  auto* gp = static_cast<const int32_t*>(gallery);
  return dispatch_words(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return launch<Tiling<kW, kMT<kW>>>(
        groupmin_min2_mma_kernel<kW>, nq, C, static_cast<cudaStream_t>(stream),
        static_cast<const int32_t*>(q), gp, static_cast<int32_t*>(min1),
        static_cast<int32_t*>(min2), nq, L, C, valid_n, stride,
        wide_rows(gp, C));
  });
}
