// Column-min scan over the pre-unpacked +-1 gallery (the opt-in pm8 copy):
//   out[q, c] = min over s of  base[s, c] - (L/2) * sum_b q[q, b] * g[b, s, c]
// for +-1 queries q (Q, B) and a +-1 gallery in the block layout
// (B, C/cb, L, cb) (item s of column c = j*cb + cc at [b, j, s, cc]).
// int8 operands: int32 sums and keys, half_l = L/2 in integers. bf16
// operands: float32 sums and keys, half_l = L/2.0. Both exact: the sums are
// integers of magnitude <= B <= 256. With the key base of build_key_base
// (B*L/2 + s, +2^22 on padding) the key is d*L + s (+2^22).
//
// Replaces: hashgan_tpu/ops/mxu_scan.py, mxu8_groupmin_scan ->
// _pm_groupmin_kernel (line 142), one MXU matmul per (query tile, column
// block) followed by a sublane min.
//
// Bound on the H100: at 256 queries over 1M items x 128 bits the int8
// gallery is 134 MB, past the 50 MB L2, so the least time is reading it once
// (40 us at 3.35 TB/s; the 6.9e10 int8 operations take 35 us on the tensor
// cores). This kernel is the simple version: it does the products on the
// CUDA cores (__dp4a, four int8 products a call; float32 FMAs for bf16) and
// reads the gallery once per 16-query tile. Tensor-core mma/wgmma is later
// work.
// Design: 128 threads a block, each owning 4 neighbouring columns of one
// column block (cb % 4 == 0), so one 32-bit load brings bit b of 4 items and
// a warp reads 128 contiguous bytes. For int8, four such loads (bits
// 4b4..4b4+3) are transposed with __byte_perm into one word per item, whose
// 4 bytes meet the query's 4 bytes in one __dp4a. The 16 queries' words sit
// in shared memory; the sums for one sublane s live in registers and fold
// into the running minima before the next s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kTQ = 16;  // queries per block

__global__ void __launch_bounds__(kThreads)
pm_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ g,
               const int32_t* __restrict__ base, int32_t* __restrict__ out,
               int nq, int B, int NB, int L, int cb) {
  extern __shared__ int32_t q4[];  // kTQ x B/4 words
  const int nb4 = B / 4;
  const int q0 = blockIdx.y * kTQ;
  for (int i = threadIdx.x; i < kTQ * nb4; i += kThreads) {
    const int qi = q0 + i / nb4;
    q4[i] = qi < nq ? reinterpret_cast<const int32_t*>(
                          q + static_cast<int64_t>(qi) * B)[i % nb4]
                    : 0;
  }
  __syncthreads();
  const int C = NB * cb;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  if (c0 >= C) return;
  const int j = c0 / cb, cc = c0 % cb;
  const int half_l = L / 2;
  const int64_t bit_stride = static_cast<int64_t>(NB) * L * cb;
  const int8_t* gcol = g + static_cast<int64_t>(j) * L * cb + cc;

  int best[kTQ][kColsPerThread];
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) best[t][k] = 0x7fffffff;

  for (int s = 0; s < L; ++s) {
    int acc[kTQ][kColsPerThread] = {};
    const int8_t* gs = gcol + static_cast<int64_t>(s) * cb;
    for (int b4 = 0; b4 < nb4; ++b4) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(gs + (4 * b4 + r) * bit_stride);
      // 4x4 byte transpose: item k's word = byte k of w[0..3]
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      const int item[4] = {
          static_cast<int>(__byte_perm(t0, t2, 0x5410)),
          static_cast<int>(__byte_perm(t0, t2, 0x7632)),
          static_cast<int>(__byte_perm(t1, t3, 0x5410)),
          static_cast<int>(__byte_perm(t1, t3, 0x7632))};
#pragma unroll
      for (int t = 0; t < kTQ; ++t) {
        const int qv = q4[t * nb4 + b4];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k)
          acc[t][k] = __dp4a(item[k], qv, acc[t][k]);
      }
    }
    const int4 bs =
        *reinterpret_cast<const int4*>(base + static_cast<int64_t>(s) * C + c0);
    const int bv[4] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
    for (int t = 0; t < kTQ; ++t)
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k)
        best[t][k] = min(best[t][k], bv[k] - acc[t][k] * half_l);
  }
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) break;
    *reinterpret_cast<int4*>(out + static_cast<int64_t>(qi) * C + c0) =
        make_int4(best[t][0], best[t][1], best[t][2], best[t][3]);
  }
}

__device__ __forceinline__ float bf16_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

__global__ void __launch_bounds__(kThreads)
pm_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ g,
               const float* __restrict__ base, float* __restrict__ out, int nq,
               int B, int NB, int L, int cb) {
  extern __shared__ float qf[];  // kTQ x B values
  const int q0 = blockIdx.y * kTQ;
  for (int i = threadIdx.x; i < kTQ * B; i += kThreads) {
    const int qi = q0 + i / B;
    qf[i] = qi < nq ? bf16_to_float(q[static_cast<int64_t>(qi) * B + i % B])
                    : 0.0f;
  }
  __syncthreads();
  const int C = NB * cb;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kColsPerThread;
  if (c0 >= C) return;
  const int j = c0 / cb, cc = c0 % cb;
  const float half_l = static_cast<float>(L) / 2.0f;
  const int64_t bit_stride = static_cast<int64_t>(NB) * L * cb;
  const uint16_t* gcol = g + static_cast<int64_t>(j) * L * cb + cc;

  float best[kTQ][kColsPerThread];
#pragma unroll
  for (int t = 0; t < kTQ; ++t)
#pragma unroll
    for (int k = 0; k < kColsPerThread; ++k) best[t][k] = __int_as_float(0x7f800000);

  for (int s = 0; s < L; ++s) {
    float acc[kTQ][kColsPerThread] = {};
    const uint16_t* gs = gcol + static_cast<int64_t>(s) * cb;
    for (int b = 0; b < B; ++b) {
      const uint2 v = *reinterpret_cast<const uint2*>(gs + b * bit_stride);
      const float item[4] = {bf16_to_float(v.x & 0xffffu),
                             bf16_to_float(v.x >> 16),
                             bf16_to_float(v.y & 0xffffu),
                             bf16_to_float(v.y >> 16)};
#pragma unroll
      for (int t = 0; t < kTQ; ++t) {
        const float qv = qf[t * B + b];
#pragma unroll
        for (int k = 0; k < kColsPerThread; ++k)
          acc[t][k] = fmaf(qv, item[k], acc[t][k]);
      }
    }
    const float4 bs = *reinterpret_cast<const float4*>(
        base + static_cast<int64_t>(s) * C + c0);
    const float bv[4] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
    for (int t = 0; t < kTQ; ++t)
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k)
        best[t][k] = fminf(best[t][k], bv[k] - acc[t][k] * half_l);
  }
#pragma unroll
  for (int t = 0; t < kTQ; ++t) {
    const int qi = q0 + t;
    if (qi >= nq) break;
    *reinterpret_cast<float4*>(out + static_cast<int64_t>(qi) * C + c0) =
        make_float4(best[t][0], best[t][1], best[t][2], best[t][3]);
  }
}

}  // namespace

// q (nq, B) +-1 int8 (is_int8) or bf16 bits; g (B, NB, L, cb) of the same
// type; base (L, NB*cb) int32 or float32; out (nq, NB*cb) of the base's
// type. The caller guarantees B % 4 == 0 and cb % 4 == 0 (so every vector
// access is aligned in contiguous tensors).
extern "C" int hg_pm_groupmin_scan(const void* q, const void* g,
                                   const void* base, void* out, int nq, int B,
                                   int NB, int L, int cb, int is_int8,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int C = NB * cb;
  const dim3 grid((C / kColsPerThread + kThreads - 1) / kThreads,
                  (nq + kTQ - 1) / kTQ);
  if (is_int8) {
    const size_t smem = sizeof(int32_t) * kTQ * (B / 4);
    pm_int8_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(g),
        static_cast<const int32_t*>(base), static_cast<int32_t*>(out), nq, B,
        NB, L, cb);
  } else {
    const size_t smem = sizeof(float) * kTQ * B;
    pm_bf16_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(g),
        static_cast<const float*>(base), static_cast<float*>(out), nq, B, NB,
        L, cb);
  }
  return static_cast<int>(cudaGetLastError());
}
