// Exact full-key scan: per (query, column) the smallest composite key
//   d * stride + s * C + c
// over the column's items s with s*C + c < valid_n (d = Hamming distance,
// stride = L*C + 1); INT32_MAX when the column holds no valid item.
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, mxu_fullkey_scan ->
// _mxu_fullkey_kernel / _mxu_fullkey_kernel_lanes. The TPU kernel unpacks
// the gallery to +-1 bf16 and takes d = (B - q.g)/2 from one MXU matmul; the
// keys are the same because that identity is exact. This kernel takes the
// PACKED queries and computes d by XOR + popcount instead.
//
// Bound on the H100: the Q*N distances, whose fastest route on the card is
// the +-1 int8 tensor-core product, 2*Q*N*B operations (35 us for 256
// queries x 1M items x 128 bits at 1,979 TOP/s). This kernel spends integer
// instructions instead: every (query, item) pair costs W XORs, W popcounts,
// W adds and a min, Q*N*W of each (1.07e9 popcounts at that shape); POPC
// runs at a quarter of the ALU rate. Gallery bytes (16 MB at 1M x 128
// bits) stay L2-resident.
// Design: gallery layout (W, L, C) with c minor; one thread per column, so a
// warp's gallery loads are 128 contiguous bytes. A block covers 128 columns
// x 32 queries: the queries' words sit in shared memory (broadcast reads)
// and every gallery word loaded is reused for all 32 queries. The running
// minimum is kept as the small local key (d << 16 | s), which orders like
// (d, s) and so like the composite key within a column; the composite key
// is formed once per (query, column) at the end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;    // threads per block, one column each
constexpr int kQueries = 32;  // queries per block
constexpr int kNone = 0x7fffffff;

template <int W>
__global__ void __launch_bounds__(kCols)
fullkey_scan_kernel(const int32_t* __restrict__ q,
                    const int32_t* __restrict__ gallery,
                    int32_t* __restrict__ out, int nq, int L, int C,
                    int valid_n, int stride) {
  __shared__ uint32_t qs[kQueries * W];
  const int q0 = blockIdx.y * kQueries;
  for (int t = threadIdx.x; t < kQueries * W; t += kCols) {
    const int qi = q0 + t / W;
    qs[t] = qi < nq ? static_cast<uint32_t>(
                          q[static_cast<int64_t>(qi) * W + t % W])
                    : 0u;
  }
  __syncthreads();

  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= C) return;
  // Items of column c are idx = s*C + c, valid while idx < valid_n.
  const int s_end = valid_n > c ? min(L, (valid_n - c + C - 1) / C) : 0;

  int best[kQueries];
#pragma unroll
  for (int t = 0; t < kQueries; ++t) best[t] = kNone;

  for (int s = 0; s < s_end; ++s) {
    uint32_t g[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      g[w] = static_cast<uint32_t>(
          gallery[(static_cast<int64_t>(w) * L + s) * C + c]);
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(g[w] ^ qs[t * W + w]);
      best[t] = min(best[t], (d << 16) | s);
    }
  }

#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) break;
    int key = kNone;
    if (best[t] != kNone)
      key = (best[t] >> 16) * stride + (best[t] & 0xffff) * C + c;
    out[static_cast<int64_t>(qi) * C + c] = key;
  }
}

template <int W>
void launch(const int32_t* q, const int32_t* g, int32_t* out, int nq, int L,
            int C, int valid_n, int stride, cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols, (nq + kQueries - 1) / kQueries);
  fullkey_scan_kernel<W><<<grid, kCols, 0, stream>>>(q, g, out, nq, L, C,
                                                     valid_n, stride);
}

}  // namespace

// q (nq, W) packed queries; gallery (W, L, C); out (nq, C). The caller
// guarantees 1 <= W <= 8, L <= 65536 and (32W + 1) * stride + L*C < 2^31.
extern "C" int hg_mxu_fullkey_scan(const void* q, const void* gallery,
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
