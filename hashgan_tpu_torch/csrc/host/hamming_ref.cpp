// Exact host Hamming scanner (the port's copy of native/hamming_ref.cpp).
//
// An exact XOR-popcount top-k scanner on the host, independent of the CUDA
// engines: it verifies them at scales where the numpy oracle is too slow,
// and scans galleries held in host memory.
//
// Semantics contract (identical to every other engine in this repo):
// ranking key = (hamming distance ascending, database index ascending).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libhamming_ref.so hamming_ref.cpp
// (driven by hashgan_tpu_torch/ops/native.py at first use, into
// hashgan_tpu_torch/csrc/build/; no external deps).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// All-pairs distance: queries (q, w), gallery (n, w) -> out (q, n) int32.
void hamming_distance(const uint32_t* queries, const uint32_t* gallery,
                      int64_t q, int64_t n, int64_t w, int32_t* out) {
    for (int64_t i = 0; i < q; ++i) {
        const uint32_t* qi = queries + i * w;
        int32_t* oi = out + i * n;
        for (int64_t j = 0; j < n; ++j) {
            const uint32_t* gj = gallery + j * w;
            int32_t d = 0;
            for (int64_t t = 0; t < w; ++t) {
                d += __builtin_popcount(qi[t] ^ gj[t]);
            }
            oi[j] = d;
        }
    }
}

// Exact top-k with (distance, index) ordering via a bounded max-heap per
// query. out_d/out_i are (q, k); slots past n get distance INT32_MAX.
void hamming_topk(const uint32_t* queries, const uint32_t* gallery,
                  int64_t q, int64_t n, int64_t w, int64_t k,
                  int32_t* out_d, int32_t* out_i) {
    const int64_t kk = std::min(k, n);
    for (int64_t i = 0; i < q; ++i) {
        const uint32_t* qi = queries + i * w;
        // heap of encoded keys: (d << 32) | idx, max-heap on top
        std::vector<int64_t> heap;
        heap.reserve(kk);
        for (int64_t j = 0; j < n; ++j) {
            const uint32_t* gj = gallery + j * w;
            int32_t d = 0;
            for (int64_t t = 0; t < w; ++t) {
                d += __builtin_popcount(qi[t] ^ gj[t]);
            }
            int64_t key = (static_cast<int64_t>(d) << 32) | j;
            if (static_cast<int64_t>(heap.size()) < kk) {
                heap.push_back(key);
                std::push_heap(heap.begin(), heap.end());
            } else if (key < heap.front()) {
                std::pop_heap(heap.begin(), heap.end());
                heap.back() = key;
                std::push_heap(heap.begin(), heap.end());
            }
        }
        std::sort_heap(heap.begin(), heap.end());
        for (int64_t r = 0; r < k; ++r) {
            if (r < static_cast<int64_t>(heap.size())) {
                out_d[i * k + r] = static_cast<int32_t>(heap[r] >> 32);
                out_i[i * k + r] = static_cast<int32_t>(heap[r] & 0xFFFFFFFFLL);
            } else {
                out_d[i * k + r] = INT32_MAX;
                out_i[i * k + r] = static_cast<int32_t>(n);
            }
        }
    }
}

// Pack sign bits: codes (n, b) float32 -> packed (n, ceil(b/32)) uint32.
void pack_codes(const float* codes, int64_t n, int64_t b, uint32_t* out) {
    const int64_t words = (b + 31) / 32;
    for (int64_t i = 0; i < n; ++i) {
        const float* ci = codes + i * b;
        uint32_t* oi = out + i * words;
        std::memset(oi, 0, words * sizeof(uint32_t));
        for (int64_t j = 0; j < b; ++j) {
            if (ci[j] > 0.0f) {
                oi[j / 32] |= (1u << (j % 32));
            }
        }
    }
}

}  // extern "C"
