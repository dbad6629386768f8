// Shared pieces of the block-sparse SpMM kernels (bsr_spmm.cu,
// bsr_spmm_panel.cu): the CTA shape, 16-byte vector loads, FP32/FP64
// fused multiply-adds and the panel kernel's per-thread column count.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace rbl {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kKC = 32;        // contraction slice staged in shared memory
constexpr int kMaxBM = 128;    // tallest tile the kernels take
constexpr int kMaxBW = 32;     // columns of X one CTA handles
constexpr int kLX = kKC * kMaxBW / kThreads;  // X elements per thread and slice

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// X staging of one (kKC, bw) slice: thread tid copies element
// e = tid + j·kThreads, from row-major X (stride b) to the padded shared
// array (stride kMaxBW + 1).  The offsets are the same for every slice.
struct XStage {
  int src[kLX], dst[kLX];
  __device__ XStage(int tid, int bw, int b) {
#pragma unroll
    for (int j = 0; j < kLX; ++j) {
      const int e = tid + j * kThreads;
      const int kk = e / bw, c = e % bw;
      const bool ok = e < kKC * bw;
      src[j] = ok ? kk * b + c : -1;
      dst[j] = ok ? kk * (kMaxBW + 1) + c : 0;
    }
  }
};

// Calls f(std::integral_constant<int, NC>) with NC the most columns one
// thread accumulates: a power of two ≥ its share of the CTA's columns, so
// that the unrolled column loop issues at most twice the useful FMAs.
template <typename F>
void dispatch_ncol(int bm, int b, F&& f) {
  const int groups = kThreads / bm;
  const int ncol = ((b < kMaxBW ? b : kMaxBW) + groups - 1) / groups;
  if (ncol <= 1) {
    f(std::integral_constant<int, 1>{});
  } else if (ncol <= 2) {
    f(std::integral_constant<int, 2>{});
  } else if (ncol <= 4) {
    f(std::integral_constant<int, 4>{});
  } else if (ncol <= 8) {
    f(std::integral_constant<int, 8>{});
  } else if (ncol <= 16) {
    f(std::integral_constant<int, 16>{});
  } else {
    f(std::integral_constant<int, 32>{});
  }
}

// Arguments every kernel launch checks before it starts.
template <typename T>
bool valid_launch(int nb, int bm, int bk, int b, const T* vals) {
  return bm >= 1 && bm <= kMaxBM && bk >= kKC && bk % kKC == 0 && b >= 1 &&
         nb >= 0 && reinterpret_cast<unsigned long long>(vals) % 16 == 0;
}

}  // namespace rbl
