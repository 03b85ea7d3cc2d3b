// Subgroup-min scan of the large-k engine: for every (query, subgroup u) of
// the grouped (W, L, C) gallery, one DISTINCT int32 composite key
//   d * stride + s * C + c          (pad_d * stride + s * C + c if the whole
//                                     subgroup is padding)
// where subgroup u = j*C + c holds the sigma items s in [j*sigma, (j+1)*sigma)
// of column c, and (d, s) is its smallest item in the (padding?, d, s) order
// (grouped_scan.cuh). Output (Q, R*C), R = L / sigma; pad_d = bits + 1.
//
// Replaces: hashgan_tpu/ops/mxu_large_k.py, mxu_subgroupmin_scan ->
// _mxu_subgroupmin_kernel (line 70), together with the decode
// _subgroup_full_keys (line 152) that its caller runs on the TPU kernel's
// (Q, R, C) float32 minima d*L + s (+2^22). The TPU kernel unpacks the gallery
// to +-1 bf16 and takes d = (B - q.g)/2 from an MXU matmul; here the same
// product runs on the int8 tensor cores, and the keys come out finished.
//
// Bound on the H100: the Q*N distances as the +-1 int8 tensor-core product,
// 2*Q*N*B operations, 6.9e10 for 256 queries x 1M items x 128 bits, 35 us
// at 1,979 TOP/s. The (Q, R*C) output is 8x the column scans' (67 MB at
// that shape, 20 us at 3.35 TB/s, and more than the 50 MB L2).
//
// Design: the int8 tensor-core walk of grouped_scan.cuh, two m-tiles of 16
// queries a warp (256 queries a block) at every W, with one running minimum
// per element that is flushed and reset after every row s where
// (s + 1) % sigma == 0. Chunk and subgroup boundaries are independent (64/W
// rows a chunk, any sigma dividing L), so the next flush row is a counter.
// A flush writes a lane's two adjacent columns with one 8-byte evict-first
// store (__stcs): the output streams past L2 and leaves the staged gallery
// there.
#include "grouped_scan.cuh"

namespace {

using namespace gscan;

constexpr int kMT = 2;

struct SubgroupFlush {
  int b1[kMT][kNT][4];
  Lanes<kMT> ln;
  int32_t* out;
  int64_t row_len;  // R*C
  int nq, C, sigma, stride, pad_d;
  int next;   // the row that ends the current subgroup
  int j_off;  // j*C of the current subgroup

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) b1[m][t][r] = kNone;
  }
  __device__ __forceinline__ void key(int m, int t, int r, int k) {
    b1[m][t][r] = min(b1[m][t][r], k);
  }
  __device__ __forceinline__ int composite(int local, int c) const {
    const int d = local_is_pad(local) ? pad_d : local_d(local);
    return d * stride + local_s(local) * C + c;
  }
  __device__ __forceinline__ void row_done(int s) {
    if (s != next) return;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = ln.query(m, h);
        if (qi >= nq) continue;
        int32_t* row = out + qi * row_len + j_off;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const int c = ln.col_lane + 8 * t;
          store_pair<true>(row, c, C, composite(b1[m][t][2 * h], c),
                           composite(b1[m][t][2 * h + 1], c + 1));
        }
      }
    init();
    next += sigma;
    j_off += C;
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
subgroupmin_mma_kernel(const int32_t* __restrict__ q,
                       const int32_t* __restrict__ gallery,
                       int32_t* __restrict__ out, int nq, int L, int C,
                       int sigma, int valid_n, int stride, int pad_d,
                       bool wide) {
  SubgroupFlush epi;
  epi.out = out;
  epi.row_len = static_cast<int64_t>(L / sigma) * C;
  epi.nq = nq;
  epi.C = C;
  epi.sigma = sigma;
  epi.stride = stride;
  epi.pad_d = pad_d;
  epi.next = sigma - 1;
  epi.j_off = 0;
  walk_strip<W, kMT>(q, gallery, nq, L, C, valid_n, wide, epi.ln, epi);
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, (L/sigma)*C). The
// caller guarantees 1 <= W <= 8, L % sigma == 0, L <= 65536,
// nq <= 65535 * 256 and (pad_d + 1) * stride + L*C < 2^31.
extern "C" int hg_subgroupmin_scan(const void* q, const void* gallery,
                                   void* out, int nq, int W, int L, int C,
                                   int sigma, int valid_n, int stride,
                                   int pad_d, void* stream) {
  auto* gp = static_cast<const int32_t*>(gallery);
  return dispatch_words(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    return launch<Tiling<kW, kMT>>(
        subgroupmin_mma_kernel<kW>, nq, C, static_cast<cudaStream_t>(stream),
        static_cast<const int32_t*>(q), gp, static_cast<int32_t*>(out), nq, L,
        C, sigma, valid_n, stride, pad_d, wide_rows(gp, C));
  });
}
